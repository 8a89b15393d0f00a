"""Dispatch for the kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the plain PyTorch version in ``kernels.ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is
no fallback from one to the other. A ``meta`` tensor (the dry-run) gets an
empty output of the right shape and dtype, and the kernel's own flops and
bytes (``*_cost``, the counts ``chip_smoke.py`` bounds each kernel by) go to
every open ``counting_kernel_costs`` record: nothing runs on meta. A
DTensor runs the same dispatch on its local shards, once the dims the
kernel reduces are whole on each rank (``on_local_shards``).

Gradients: where an input requires grad, ``rmsnorm`` and ``swa_attention``
run through a ``torch.autograd.Function`` whose forward is the same
dispatch (kernel or plain version, under no_grad) and whose backward is an
explicit formula in torch ops, in f32 and cast to the input's dtype: the
reference has no backward kernel for them (``jax.grad`` differentiates its
plain ``jnp`` ops), and autograd never runs through their plain versions.
``ssd`` (Mamba-2's chunked SSD, plain ``jnp`` in the reference) is the one
kernel with a backward kernel: on CUDA its Function's forward and backward
both launch ``csrc/ssd.cu``, and on the CPU autograd runs through the plain
version's ops. Each backward runs inside a ``core.telemetry`` span,
``kernels.<kernel>.backward``.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import telemetry
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import swa_attention as _swa


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {x.device}")


# ------------------------------------------------------------ costs ----
def rmsnorm_cost(x_shape, w_shape, elt: int) -> tuple[float, float]:
    """(operations, bytes) of one rmsnorm call: x read and y written in
    their dtype (``elt`` bytes), the f32 gain read once; 5 operations an
    element (square, sum, scale, gain, cast)."""
    n = math.prod(x_shape)
    return 5.0 * n, float(2 * n * elt + 4 * math.prod(w_shape))


def swa_pairs(sq: int, sk: int, *, causal: bool, window: int | None,
              q_offset: int = 0) -> int:
    """The (query, key) pairs the mask lets through: the work of one
    attention head."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def swa_attention_cost(bh: int, sq: int, sk: int, d: int, elt: int, *,
                       causal: bool, window: int | None,
                       q_offset: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one swa_attention call: q, k, v read and o
    written once; q.k and p.v, 2 operations a multiply-add each, over the
    pairs the mask lets through."""
    pairs = swa_pairs(sq, sk, causal=causal, window=window, q_offset=q_offset)
    return 4.0 * d * pairs * bh, float(2 * bh * (sq + sk) * d * elt)


def ssd_cost(b: int, s: int, h: int, p: int, n: int, chunk: int, elt: int, *,
             backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one ssd call, forward or backward, at xin
    [b, s, h, p] and Bm, Cm [b, s, n] in ``elt``-byte elements, dt and dA
    f32. Operations, 2 a multiply-add over the causal pairs (i, j <= i) of
    each chunk: forward C.B (once for every head), the intra-chunk product
    M x, the inter-chunk term C h^T and the state's term; backward C.B
    again, dy x^T and M^T dy, dC and dB through dCB, and five products of
    the state's size (B G^T, C h^T, D, and dC's and dB's state terms).
    Bytes: the forward reads its inputs and writes y; the backward reads
    them and dy and writes the five gradients."""
    q = min(chunk, s)
    pairs = sum(k * (k + 1) // 2 for k in [q] * (s // q) + ([s % q] if s % q else []))
    state = 2.0 * s * n * h * p  # one product of the state's size, all chunks
    if backward:
        return (b * (3 * 2.0 * pairs * n + 2 * 2.0 * pairs * h * p + 5 * state),
                float(b * s * (3 * h * p * elt + 4 * n * elt + 4 * h * 4)))
    return (b * (2.0 * pairs * n + 2.0 * pairs * h * p + 2 * state),
            float(b * s * (2 * h * p * elt + 2 * n * elt + 2 * h * 4)))


def fused_sgd_update_cost(n: int) -> tuple[float, float]:
    """(operations, bytes) of one fused_sgd_update over n f32 elements:
    p, g, mu read and p, mu written; 3 multiplies and 3 adds."""
    return 6.0 * n, float(5 * 4 * n)


_COST_RECORDS: list[dict] = []


@contextlib.contextmanager
def counting_kernel_costs():
    """Yield a record {"flops", "bytes", "calls": {name: n}} to which every
    kernel call on ``meta`` tensors adds its cost while the context is
    open."""
    rec = {"flops": 0.0, "bytes": 0.0, "calls": {}}
    _COST_RECORDS.append(rec)
    try:
        yield rec
    finally:
        _COST_RECORDS.remove(rec)


def _charge(name: str, cost: tuple[float, float]) -> None:
    for rec in _COST_RECORDS:
        rec["flops"] += cost[0]
        rec["bytes"] += cost[1]
        rec["calls"][name] = rec["calls"].get(name, 0) + 1


# ---------------------------------------------------------- DTensor ----
def _whole(t: DTensor, dims) -> DTensor:
    """``t`` redistributed so that no dim in ``dims`` is sharded and no sum
    is pending; every other placement stays."""
    dims = {d + t.ndim if d < 0 else d for d in dims}
    want = tuple(Replicate() if isinstance(p, Partial)
                 or (isinstance(p, Shard) and p.dim % t.ndim in dims) else p
                 for p in t.placements)
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def on_local_shards(fn, *ts, whole=()):
    """``fn`` of DTensors ``ts`` run on their local shards: the dims in
    ``whole`` (those ``fn`` reduces over) are made whole, every other input
    takes the first's placements, and the output (or each output of a
    tuple) is a DTensor of the first's placements. On CUDA shards ``fn``
    launches the hand-written kernel; gradients flow through the local
    call."""
    first = _whole(ts[0], whole)
    mesh, place = first.device_mesh, tuple(first.placements)
    rest = [(t if isinstance(t, DTensor)
             else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)) for t in ts[1:]]
    rest = [t if tuple(t.placements) == place else _whole(t, whole) for t in rest]
    n = len(ts)
    return on_local_shards_as(fn, (first, *rest), (place,) * n, (place,) * n, place)


def on_local_shards_as(fn, ts, places, grad_places, out_place):
    """``fn`` of DTensors ``ts`` on their local shards, each input first
    redistributed to its entry of ``places``; a local input's gradient
    has the placements of its entry of ``grad_places`` (a pending sum
    where the local call sums over rows another rank holds), and each
    output is a DTensor of ``out_place``."""
    mesh = ts[0].device_mesh
    local = [(t if tuple(t.placements) == tuple(p) else t.redistribute(mesh, p))
             .to_local(grad_placements=g) for t, p, g in zip(ts, places, grad_places)]
    out = fn(*local)
    # the shards are even (the rules shard only dims that divide), so the
    # global shapes and strides follow from the local outputs'
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, out_place, run_check=False)
                     for o in out)
    return DTensor.from_local(out, mesh, out_place, run_check=False)


def _rmsnorm_on_shards(x: DTensor, w, eps):
    """rmsnorm of a DTensor: the last dim whole on each rank; the gain
    follows x's sharding of the dims it shares with x (a [G, D] gain with
    x sharded over G), and its local gradient is a pending sum over the
    mesh dims on which x splits rows that w does not have."""
    x = _whole(x, (-1,))
    mesh, lead = x.device_mesh, x.ndim - w.ndim
    wp, wg = [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim >= lead:
            wp.append(Shard(p.dim - lead))
            wg.append(Shard(p.dim - lead))
        else:
            wp.append(Replicate())
            wg.append(Partial() if isinstance(p, Shard) else Replicate())
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)
    place = tuple(x.placements)
    return on_local_shards_as(lambda a, b: rmsnorm(a, b, eps=eps), (x, w),
                              (place, wp), (place, wg), place)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# largest [rows, S] block of f32 softmax weights the attention backward
# holds at once: 2**28 values, 1 GiB
_SWA_BWD_BLOCK = 1 << 28


def rmsnorm_backward(x, w, g, *, eps: float = 1e-6):
    """-> (dx, dw) of ``y = x * r * (1 + w)``, ``r = rsqrt(mean(x**2) + eps)``
    over the last dim, for the cotangent ``g`` of y. With ``a = g * (1 + w)``:
    ``dx = r * a - x * r**3 * mean(a * x)`` and ``dw = sum g * x * r`` over
    every leading axis that w does not have (w is [D] or [G, D], a suffix
    of x's shape). r is recomputed from x; f32 math, dx in x's dtype and
    dw in w's."""
    ct = ref.math_dtype(x.dtype)
    xf, gf, wf = x.to(ct), g.to(ct), w.to(ct)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    a = gf * (1.0 + wf)
    dx = r * a - xf * (r * r * r) * torch.mean(a * xf, dim=-1, keepdim=True)
    dw = (gf * xf * r).reshape(-1, *w.shape).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def swa_attention_backward(q, k, v, do, *, causal: bool = True,
                           window: int | None = None, q_offset: int = 0):
    """-> (dq, dk, dv) of ``o = softmax(mask(q k^T / sqrt(D))) v`` for the
    cotangent ``do``; q [BH, Sq, D], k, v [BH, Sk, D], query row i at
    position q_offset + i (cross-attention: Sk != Sq). P is recomputed from
    q and k under the forward's mask (``ref.swa_mask``), over blocks of
    query rows that hold at most ``_SWA_BWD_BLOCK`` f32 weights; then ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``,
    ``dQ = dS K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``. ``rowsum(dO * O)``
    is taken as ``rowsum(P * dO V^T)``, its value for the unrounded
    ``O = P V``, so the bf16 rounding of the forward's output does not
    enter. f32 math, results in the inputs' dtypes."""
    bh, s, d = q.shape
    sk = k.shape[1]
    ct = ref.math_dtype(q.dtype)
    qf, kf, vf, dof = (t.to(ct) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    mask = ref.swa_mask(s, sk, q.device, causal=causal, window=window,
                        q_offset=q_offset)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = max(1, min(s, _SWA_BWD_BLOCK // max(1, bh * sk)))
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qb, dob = qf[:, r0:r1], dof[:, r0:r1]
        scores = torch.einsum("bqd,bkd->bqk", qb, kf) * scale
        p = torch.softmax(torch.where(mask[None, r0:r1], scores, ref.NEG_INF), -1)
        dv += torch.einsum("bqk,bqd->bkd", p, dob)
        dp = torch.einsum("bqd,bkd->bqk", dob, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, r0:r1] = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
        dk += torch.einsum("bqk,bqd->bkd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rmsnorm(x, w, eps):
    if x.device.type == "meta":
        _charge("rmsnorm", rmsnorm_cost(x.shape, w.shape, x.element_size()))
        return torch.empty_like(x)
    if _route(x, "rmsnorm"):
        return _rms.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def _swa_attention(q, k, v, causal, window, q_offset=0):
    if q.device.type == "meta":
        bh, sq, d = q.shape
        _charge("swa_attention", swa_attention_cost(
            bh, sq, k.shape[1], d, q.element_size(), causal=causal,
            window=window, q_offset=q_offset))
        return torch.empty_like(q)
    if _route(q, "swa_attention"):
        return _swa.swa_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return ref.swa_attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)


class _RMSNorm(torch.autograd.Function):
    """``_rmsnorm`` (kernel or plain version) with ``rmsnorm_backward`` as
    its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with telemetry.span("kernels.rmsnorm.backward"):
            return (*rmsnorm_backward(x, w, g, eps=ctx.eps), None)


class _SWAAttention(torch.autograd.Function):
    """``_swa_attention`` (kernel or plain version) with
    ``swa_attention_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return _swa_attention(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with telemetry.span("kernels.swa_attention.backward"):
            return (*swa_attention_backward(q, k, v, do, causal=ctx.causal,
                                            window=ctx.window,
                                            q_offset=ctx.q_offset),
                    None, None, None)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the SSD kernels read it: a
    copy only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ssd_meta(xin, Bm, backward: bool, chunk: int) -> None:
    b, s, h, p = xin.shape
    _charge("ssd_backward" if backward else "ssd",
            ssd_cost(b, s, h, p, Bm.shape[-1], chunk, xin.element_size(), backward=backward))


class _SSD(torch.autograd.Function):
    """``ssd`` on CUDA (or meta) tensors: the forward kernels, and the
    backward kernels as its gradient. Saves the five inputs, the cumsums
    and the state entering each chunk."""

    @staticmethod
    def forward(ctx, xin, Bm, Cm, dt, dA, chunk):
        ctx.chunk = chunk
        if xin.device.type == "meta":
            _ssd_meta(xin, Bm, False, chunk)
            ctx.save_for_backward(xin, Bm, Cm, dt, dA)
            return torch.empty_like(xin)
        y, cs, states = _ssd.ssd_forward(xin, Bm, Cm, dt, dA, chunk)
        ctx.save_for_backward(xin, Bm, Cm, dt, dA, cs, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with telemetry.span("kernels.ssd.backward"):
            if dy.device.type == "meta":
                _ssd_meta(saved[0], saved[1], True, ctx.chunk)
                grads = tuple(torch.empty_like(t) for t in saved)
            else:
                grads = _ssd.ssd_backward(_dense(dy), *saved, ctx.chunk)
        return (*grads, None)


def ssd(xin, Bm, Cm, dt, dA, chunk: int):
    """Mamba-2's chunked SSD from a zero state (``ref.ssd``): xin [B, S, H,
    P], Bm/Cm [B, S, N], dt/dA [B, S, H] f32 -> y [B, S, H, P] in xin's
    dtype. CPU tensors run the plain version, autograd through its ops;
    CUDA tensors the kernels through ``_SSD`` (no graph is recorded where
    nothing requires grad), which raise on what they do not take; meta
    tensors an empty output, the cost charged."""
    if xin.device.type != "meta" and not _route(xin, "ssd"):
        return ref.ssd(xin, Bm, Cm, dt, dA, chunk)
    return _SSD.apply(*(_dense(t) for t in (xin, Bm, Cm, dt, dA)), chunk)


def rmsnorm(x, w, *, eps: float = 1e-6):
    """RMSNorm with gain 1 + w. x: [..., D]; w: f32, [D], or [G, D] with
    x ending in [G, D] (a gain per head)."""
    if isinstance(x, DTensor):
        return _rmsnorm_on_shards(x, w, eps)
    if _wants_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def swa_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0):
    """Sliding-window flash attention. q: [BH, Sq, D]; k, v: [BH, Sk, D];
    query row i sits at position q_offset + i. DTensors run on their local
    shards, with S and D whole on each rank."""
    if isinstance(q, DTensor):
        return on_local_shards(
            lambda *t: swa_attention(*t, causal=causal, window=window,
                                     q_offset=q_offset), q, k, v, whole=(1, 2))
    if _wants_grad(q, k, v):
        return _SWAAttention.apply(q, k, v, causal, window, q_offset)
    return _swa_attention(q, k, v, causal, window, q_offset)


def fused_sgd_update(params_flat, grads_flat, mu_flat, lr, *,
                     momentum: float = 0.9, weight_decay: float = 1e-4,
                     nesterov: bool = False):
    """Momentum SGD over flat f32 buffers, in place on ``params_flat`` and
    ``mu_flat`` on both routes; returns them."""
    if params_flat.device.type == "meta":
        _charge("fused_sgd_update", fused_sgd_update_cost(params_flat.numel()))
        return params_flat, mu_flat
    if _route(params_flat, "fused_sgd_update"):
        return _fu.fused_sgd_update(params_flat, grads_flat, mu_flat, lr,
                                    momentum=momentum,
                                    weight_decay=weight_decay,
                                    nesterov=nesterov)
    new_p, new_mu = ref.fused_sgd_update_ref(
        params_flat, grads_flat, mu_flat, lr, momentum=momentum,
        weight_decay=weight_decay, nesterov=nesterov)
    params_flat.copy_(new_p)
    mu_flat.copy_(new_mu)
    return params_flat, mu_flat


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the counts were last reset."""
    return {"rmsnorm": _rms.rmsnorm.launches,
            "swa_attention": _swa.swa_attention.launches,
            "fused_sgd_update": _fu.fused_sgd_update.launches,
            "ssd": _ssd.ssd_forward.launches,
            "ssd_backward": _ssd.ssd_backward.launches}


def reset_launch_counts() -> None:
    _rms.rmsnorm.launches = 0
    _swa.swa_attention.launches = 0
    _fu.fused_sgd_update.launches = 0
    _ssd.ssd_forward.launches = 0
    _ssd.ssd_backward.launches = 0
    _rms.rmsnorm.grouped_launches = 0
