"""Step builders: train-step, prefill and decode-step closures over a
model (torch twin of ``repro.engine.steps``).

They run on the GPU unless the caller passes ``device="cpu"``: with no GPU
and no ``device="cpu"`` they raise. The train step accumulates gradients
over microbatches and, in data-parallel runs, exchanges them with the
paper's all-reduce (``collectives.dist``) over a process group.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.collectives.dist import ALGORITHMS, allreduce_
from repro_torch.models.layers import NO_SHARD, Sharder
from repro_torch.models.spec import FlatTree, flatten, unflatten, views
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


def _synced_clock(device: torch.device) -> float:
    """The host clock (s) once ``device``'s queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _check_params(params: dict, device: torch.device) -> None:
    where = next(iter(flatten(params).values())).device
    if where.type != device.type:
        raise ValueError(f"params are on {where}, the step runs on {device}")


def make_prefill(model, sh: Sharder = NO_SHARD, window: int | None = None,
                 device="cuda"):
    """(params, batch {tokens [B, S]}) -> logits [B, S, V] f32. For a VLM
    the batch may also hold patch_embeds [B, P, D], written over the first
    P embedded rows (the vision stub); whisper's holds frames
    [B, n_frames, D], the encoder's input (the audio stub)."""
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


def _grad_leaves(model, params: FlatTree, grads: torch.Tensor) -> dict:
    """The tree that autograd differentiates: for each parameter view, a
    detached alias that requires grad and whose ``.grad`` is its view of
    the flat f32 buffer ``grads``. Backward adds each gradient into an
    existing ``.grad`` in place, so the flat buffer is the only full-size
    gradient storage. A stacked leaf (first axis "layers") becomes a tuple
    of per-layer leaves: through a per-layer select of the stacked tensor,
    each layer's gradient would be a full-size zero tensor of the stack."""
    stacked = {path for path, s in flatten(model.param_specs()).items()
               if s.axes[:1] == ("layers",)}
    grad_views = flatten(views(grads, params.shapes()))

    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    leaves = {}
    for path, p in flatten(params).items():
        g = grad_views[path]
        leaves[path] = (tuple(map(leaf, p.unbind(0), g.unbind(0)))
                        if path in stacked else leaf(p, g))
    return unflatten(leaves)


def accumulate_flat_grad(model, params: FlatTree, batch: dict,
                         grads: torch.Tensor, sh: Sharder = NO_SHARD):
    """Add the gradient of ``model.loss`` at ``params`` on ``batch`` into
    the flat f32 buffer ``grads`` (in ``params.flat``'s order), in place;
    returns the loss, detached."""
    with torch.enable_grad():
        loss = model.loss(_grad_leaves(model, params, grads), batch, sh)
        loss.backward()
    return loss.detach()


def value_and_flat_grad(model, params: FlatTree, batch: dict,
                        out: torch.Tensor | None = None, sh: Sharder = NO_SHARD):
    """-> (loss, grads): the loss and its gradient as one flat f32 buffer
    in ``params.flat``'s order, written into ``out`` when given (the
    parameters themselves never require grad)."""
    if out is None:
        out = torch.zeros_like(params.flat)
    else:
        out.zero_()
    return accumulate_flat_grad(model, params, batch, out, sh), out


def make_train_step(model, optimizer: Optimizer, sh: Sharder = NO_SHARD,
                    grad_exchange: str | None = None, microbatches: int = 1,
                    group=None, device="cuda", exchange_ms: list | None = None):
    """(state {params, opt}, batch, lr) -> (state, loss).

    The parameters and optimizer state are updated in place (for ``sgd``,
    one fused kernel launch on the GPU) and the same state is returned;
    the loss is a 0-d tensor, read by the caller only when it needs the
    value.

    Gradients accumulate in one flat f32 buffer, in place (see
    ``accumulate_flat_grad``). microbatches > 1: gradient accumulation. The
    batch's leading axis is split into k consecutive microbatches; their
    gradients are summed into the buffer and divided by k, and the loss is
    the mean of the k losses.

    grad_exchange: None (one process), or "ring", "doubling_halving" or
    "psum": the accumulated gradient is all-reduced over ``group`` (None:
    the world) in place and divided by the group's size before the
    update. The step returns this rank's local loss, as the reference's
    does. ``exchange_ms``: a list to which each step appends the host
    time in ms of its exchange (the all-reduce and the division), with the
    device synchronised before and after; None records nothing.
    """
    if grad_exchange is not None:
        if grad_exchange not in ALGORITHMS:
            raise ValueError(f"unknown grad_exchange {grad_exchange!r}; expected "
                             f"None or one of {sorted(ALGORITHMS)}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"grad_exchange={grad_exchange!r} needs an initialised "
                "torch.distributed process group (launch.mesh.init_data_group)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be at least 1, got {microbatches}")
    dev = resolve_device(device)
    grads = None  # the flat gradient buffer, made at the first step

    def train_step(state, batch, lr):
        nonlocal grads
        params = state["params"]
        _check_params(params, dev)
        if grads is None:
            grads = torch.empty_like(params.flat)
        batch = _on(batch, dev)
        k = microbatches
        b = len(next(iter(batch.values())))
        if b % k:
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{k} microbatches")
        m, loss = b // k, 0.0
        grads.zero_()
        for i in range(k):
            mb = {key: v[i * m:(i + 1) * m] for key, v in batch.items()}
            loss = loss + accumulate_flat_grad(model, params, mb, grads, sh)
        if k > 1:
            grads.div_(k)
            loss = loss / k
        if grad_exchange is not None:
            t0 = None if exchange_ms is None else _synced_clock(dev)
            allreduce_(grads, group, grad_exchange)
            grads.div_(dist.get_world_size(group))
            if t0 is not None:
                exchange_ms.append(1e3 * (_synced_clock(dev) - t0))
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
