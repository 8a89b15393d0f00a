"""Optimizers (torch twin of ``repro.optim.optimizers``).

SGD+momentum is the paper's optimizer (ResNet/CIFAR); AdamW serves the LLM
architectures.

Both keep parameters, gradients and their state in flat f32 buffers: the
Horovod fusion buffer of the fused kernel's docstring. Parameters and
per-parameter state are FlatTrees (``models.spec``), nested dicts whose
leaves view the flat buffers, so checkpoints and elastic restarts see the
same trees as the reference's. An ``sgd`` step is one ``kernels.ops``
``fused_sgd_update`` over the whole buffer, which updates it in place. An
``adamw`` step is in-place torch ops over the buffers (the reference has
no AdamW kernel, so neither has the port).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
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


# elements of the flat buffers per AdamW pass that needs temporaries:
# 2**26 f32, 256 MiB each
_ADAMW_CHUNK = 1 << 26


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with the reference's formula: bias-corrected moments and
    decoupled weight decay on every parameter, in f32.

    State: ``{"m", "v"}`` FlatTrees beside the parameters and ``"t"``, the
    step count as an int32 0-d tensor on the host (the reference's
    ``jnp.int32`` scalar, so that checkpoints cross between the packages;
    on the host, reading it costs no device synchronisation).
    """

    def init(params: FlatTree) -> dict:
        if not isinstance(params, FlatTree):
            raise TypeError("adamw keeps its state in flat buffers: pass the "
                            "parameters as a FlatTree (models.spec.flat_tree)")
        return {"m": params.zeros_like(), "v": params.zeros_like(),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(grads: torch.Tensor, state: dict, params: FlatTree, lr: float):
        """grads: the flat f32 gradient buffer, in ``params.flat``'s order.

        Updates ``params.flat``, ``m``, ``v`` and ``t`` in place and returns
        ``(params, state)``, the same objects. No op allocates a full-size
        temporary: the moments update in place, and the step
        ``m / c1 / (sqrt(v / c2) + eps) + wd * p`` is formed in chunks.
        """
        state["t"] += 1
        t = np.float32(state["t"].item())
        # the bias corrections in f32, as the reference computes them
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        p, m, v = params.flat, state["m"].flat, state["v"].flat
        m.mul_(b1).add_(grads, alpha=1 - b1)
        v.mul_(b2).addcmul_(grads, grads, value=1 - b2)
        for s in range(0, p.numel(), _ADAMW_CHUNK):
            e = s + _ADAMW_CHUNK
            step = m[s:e] / c1
            step.div_(v[s:e].div(c2).sqrt_().add_(eps))
            step.add_(p[s:e], alpha=weight_decay)
            p[s:e].sub_(step, alpha=lr)
        return params, state

    return Optimizer(init, update, "adamw")
