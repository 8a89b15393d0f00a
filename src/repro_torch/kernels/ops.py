"""Dispatch for the kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the plain PyTorch version in ``kernels.ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is
no fallback from one to the other.

Gradients: where an input requires grad, ``rmsnorm`` and ``swa_attention``
run through a ``torch.autograd.Function`` whose forward is the same
dispatch (kernel or plain version, under no_grad) and whose backward is an
explicit formula in torch ops, in f32 and cast to the input's dtype. The
reference has no backward kernel (``jax.grad`` differentiates its plain
``jnp`` ops), so neither has the port; autograd never runs through the
plain versions here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import swa_attention as _swa


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {x.device}")


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
                           window: int | None = None):
    """-> (dq, dk, dv) of ``o = softmax(mask(q k^T / sqrt(D))) v`` for the
    cotangent ``do``. P is recomputed from q and k under the forward's
    mask, over blocks of query rows that hold at most ``_SWA_BWD_BLOCK``
    f32 weights; then ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``,
    ``dQ = dS K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``. ``rowsum(dO * O)``
    is taken as ``rowsum(P * dO V^T)``, its value for the unrounded
    ``O = P V``, so the bf16 rounding of the forward's output does not
    enter. f32 math, results in the inputs' dtypes."""
    bh, s, d = q.shape
    ct = ref.math_dtype(q.dtype)
    qf, kf, vf, dof = (t.to(ct) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    mask = ref.swa_mask(s, s, q.device, causal=causal, window=window)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = max(1, min(s, _SWA_BWD_BLOCK // max(1, bh * s)))
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
    if _route(x, "rmsnorm"):
        return _rms.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def _swa_attention(q, k, v, causal, window, q_offset=0):
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
        return (*rmsnorm_backward(x, w, g, eps=ctx.eps), None)


class _SWAAttention(torch.autograd.Function):
    """``_swa_attention`` (kernel or plain version) with
    ``swa_attention_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _swa_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*swa_attention_backward(q, k, v, do, causal=ctx.causal,
                                        window=ctx.window), None, None)


def rmsnorm(x, w, *, eps: float = 1e-6):
    """RMSNorm with gain 1 + w. x: [..., D]; w: f32, [D], or [G, D] with
    x ending in [G, D] (a gain per head)."""
    if _wants_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def swa_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0):
    """Sliding-window flash attention. q: [BH, Sq, D]; k, v: [BH, Sk, D];
    query row i sits at position q_offset + i.

    Gradients are taken for self-attention only (Sq = Sk, q_offset = 0):
    ``swa_attention_backward`` has no cross-attention case, so a call with
    Sq != Sk or an offset that wants a gradient raises
    NotImplementedError."""
    if _wants_grad(q, k, v):
        if k.shape[1] != q.shape[1] or q_offset:
            raise NotImplementedError(
                "swa_attention: the backward formula takes self-attention "
                f"only (Sq = Sk, q_offset = 0), got Sq {q.shape[1]}, Sk "
                f"{k.shape[1]}, q_offset {q_offset}; cross-attention's "
                "gradient comes with whisper training (ROADMAP.md, queue 1, "
                "left over from done slices)")
        return _SWAAttention.apply(q, k, v, causal, window)
    return _swa_attention(q, k, v, causal, window, q_offset)


def fused_sgd_update(params_flat, grads_flat, mu_flat, lr, *,
                     momentum: float = 0.9, weight_decay: float = 1e-4,
                     nesterov: bool = False):
    """Momentum SGD over flat f32 buffers, in place on ``params_flat`` and
    ``mu_flat`` on both routes; returns them."""
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
            "fused_sgd_update": _fu.fused_sgd_update.launches}


def reset_launch_counts() -> None:
    _rms.rmsnorm.launches = 0
    _swa.swa_attention.launches = 0
    _fu.fused_sgd_update.launches = 0
    _rms.rmsnorm.grouped_launches = 0
