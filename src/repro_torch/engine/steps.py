"""Step builders: train-step, prefill and decode-step closures over a
model (torch twin of ``repro.engine.steps``).

They run on the GPU unless the caller passes ``device="cpu"``: with no GPU
and no ``device="cpu"`` they raise. The train step runs in one process;
the explicit gradient exchange (``grad_exchange``) comes with the
collectives slice and gradient accumulation (``microbatches``) after it
(see ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import NO_SHARD, Sharder
from repro_torch.models.spec import FlatTree, flatten, unflatten
from repro_torch.optim.optimizers import Optimizer


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run its plain versions on the CPU")
    return dev


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _check_params(params: dict, device: torch.device) -> None:
    where = next(iter(flatten(params).values())).device
    if where.type != device.type:
        raise ValueError(f"params are on {where}, the step runs on {device}")


def make_prefill(model, sh: Sharder = NO_SHARD, window: int | None = None,
                 device="cuda"):
    """(params, batch {tokens [B, S]}) -> logits [B, S, V] f32."""
    dev = resolve_device(device)

    def prefill(params, batch):
        _check_params(params, dev)
        return model.prefill(params, _on(batch, dev), sh, window=window)

    return prefill


def make_decode_step(model, sh: Sharder = NO_SHARD,
                     window: int | None = None, device="cuda"):
    """(params, cache, batch {tokens [B, 1], pos [B]}) -> (logits [B, 1, V], cache);
    the cache is updated in place."""
    dev = resolve_device(device)

    def decode_step(params, cache, batch):
        _check_params(params, dev)
        return model.decode_step(params, cache, _on(batch, dev), sh,
                                 window=window)

    return decode_step


def value_and_flat_grad(model, params: FlatTree, batch: dict,
                        out: torch.Tensor | None = None, sh: Sharder = NO_SHARD):
    """-> (loss, grads): the loss and its gradient as one flat f32 buffer
    in ``params.flat``'s order, written into ``out`` when given.

    The leaves that autograd differentiates are detached aliases of the
    parameter views (the parameters themselves never require grad); their
    gradients come from ``torch.autograd.grad`` and reach the buffer in one
    ``torch.cat``.
    """
    leaves = {p: v.detach().requires_grad_() for p, v in flatten(params).items()}
    with torch.enable_grad():
        loss = model.loss(unflatten(leaves), batch, sh)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    if out is None:
        out = torch.empty_like(params.flat)
    torch.cat([g.reshape(-1) for g in grads], out=out)
    return loss.detach(), out


def make_train_step(model, optimizer: Optimizer, sh: Sharder = NO_SHARD,
                    grad_exchange: str | None = None, microbatches: int = 1,
                    device="cuda"):
    """(state {params, opt}, batch, lr) -> (state, loss).

    The parameters and optimizer state are updated in place (one fused
    kernel launch on the GPU) and the same state is returned; the loss is
    a 0-d tensor, read by the caller only when it needs the value.
    """
    if grad_exchange is not None:
        raise NotImplementedError(
            f"grad_exchange={grad_exchange!r}: the explicit all-reduce comes "
            "with the collectives slice (see ROADMAP.md)")
    if microbatches != 1:
        raise NotImplementedError(
            f"microbatches={microbatches}: gradient accumulation is not "
            "ported yet (see ROADMAP.md)")
    dev = resolve_device(device)
    grads = None  # the flat gradient buffer, made at the first step

    def train_step(state, batch, lr):
        nonlocal grads
        params = state["params"]
        _check_params(params, dev)
        if grads is None:
            grads = torch.empty_like(params.flat)
        loss, _ = value_and_flat_grad(model, params, _on(batch, dev), grads, sh)
        with torch.no_grad():
            new_params, new_opt = optimizer.update(grads, state["opt"], params, lr)
        return {"params": new_params, "opt": new_opt}, loss

    return train_step


def init_train_state(model, optimizer: Optimizer, generator=None,
                     device="cuda") -> dict:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator, dev)
    return {"params": params, "opt": optimizer.init(params)}
