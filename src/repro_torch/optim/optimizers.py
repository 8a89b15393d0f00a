"""Optimizers (torch twin of ``repro.optim.optimizers``).

SGD+momentum is the paper's optimizer (ResNet/CIFAR). AdamW, which serves
the LLM architectures, comes with the LM-training slice (see ROADMAP.md).

The port's ``sgd`` keeps parameters, gradients and momentum in three flat
f32 buffers: the Horovod fusion buffer of the fused kernel's docstring.
Parameters and momentum are FlatTrees (``models.spec``), nested dicts whose
leaves view the flat buffers, so checkpoints and elastic restarts see the
same trees as the reference's. Each step is one ``kernels.ops``
``fused_sgd_update`` over the whole buffer, which updates it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels import ops
from repro_torch.models.spec import FlatTree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr)
    name: str = "opt"


def sgd(momentum: float = 0.9, weight_decay: float = 1e-4,
        nesterov: bool = False) -> Optimizer:
    """Momentum SGD with weight decay on every parameter (GroupNorm gains
    and biases and ``fc_b`` included), as the reference applies it."""

    def init(params: FlatTree) -> dict:
        if not isinstance(params, FlatTree):
            raise TypeError("sgd keeps its state in flat buffers: pass the "
                            "parameters as a FlatTree (models.spec.flat_tree)")
        return {"mu": params.zeros_like()}

    def update(grads: torch.Tensor, state: dict, params: FlatTree, lr: float):
        """grads: the flat f32 gradient buffer, in ``params.flat``'s order.

        Updates ``params.flat`` and ``state["mu"].flat`` in place, in one
        kernel launch on the GPU, and returns ``(params, state)``, the same
        objects.
        """
        ops.fused_sgd_update(params.flat, grads, state["mu"].flat, lr,
                             momentum=momentum, weight_decay=weight_decay,
                             nesterov=nesterov)
        return params, state

    return Optimizer(init, update, "sgd")
