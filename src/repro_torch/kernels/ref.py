"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

Math in f32 (in f64 for f64 inputs, which the gradient checks use),
output in the input dtype. The CPU path of ``kernels.ops`` runs these; on
the GPU they are what each kernel is held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def math_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32, or the input's dtype where that is wider."""
    return torch.promote_types(dtype, torch.float32)


def swa_mask(sq: int, sk: int, device, *, causal: bool, window: int | None,
             q_offset: int = 0):
    """[Sq, Sk] bool: key j visible to query i, which sits at position
    q_offset + i (the reference's ``chunked_attention`` mask)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def swa_attention_ref(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0):
    """q [BH, Sq, D], k, v [BH, Sk, D] -> [BH, Sq, D]; f32 math throughout."""
    d = q.shape[-1]
    ct = math_dtype(q.dtype)
    qf, kf, vf = q.to(ct), k.to(ct), v.to(ct)
    scores = torch.einsum("bqd,bkd->bqk", qf, kf) / math.sqrt(d)
    mask = swa_mask(q.shape[1], k.shape[1], q.device, causal=causal,
                    window=window, q_offset=q_offset)
    scores = torch.where(mask[None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def fused_sgd_update_ref(params_flat, grads_flat, mu_flat, lr, *,
                         momentum: float = 0.9, weight_decay: float = 1e-4,
                         nesterov: bool = False):
    """Momentum SGD, -> (new_params, new_mu); the inputs are not changed.
    Each product and sum is its own f32 op, in the reference's order."""
    p = params_flat.float()
    g = grads_flat.float() + weight_decay * p
    mu_new = momentum * mu_flat.float() + g
    step = (g + momentum * mu_new) if nesterov else mu_new
    return ((p - lr * step).to(params_flat.dtype),
            mu_new.to(mu_flat.dtype))


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    ct = math_dtype(x.dtype)
    xf = x.to(ct)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.to(ct))).to(x.dtype)


def _ssd_chunk(h, xc, Bc, Cc, dtc, dAc, dt_):
    """One chunk of the SSD: (state after it, its output in ``dt_``).
    h: [B, H, P, N] f32; xc [B, Q, H, P], Bc/Cc [B, Q, N] in ``dt_``;
    dtc/dAc [B, Q, H] f32. The casts are the reference's: C.B in f32,
    M rounded to ``dt_`` before its product with x, the inter-chunk term
    and the state update in f32 (in f64 throughout for f64 inputs)."""
    Q = xc.shape[1]
    ct = math_dtype(dt_)
    cs = torch.cumsum(dAc, dim=1)                                   # [B,Q,H]
    CB = torch.einsum("bin,bjn->bij", Cc.to(ct), Bc.to(ct))
    diff = cs[:, :, None, :] - cs[:, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(mask[None, :, :, None], diff, NEG_INF))
    M = CB[:, :, :, None] * decay * dtc[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", M.to(dt_), xc)
    # inter: [B,Q,H,P] = C[B,Q,N] . h[B,H,P,N] scaled by exp(cs)[B,Q,H]
    y_inter = torch.einsum("bin,bhpn->bihp", Cc.to(ct), h)
    y_inter = y_inter * torch.exp(cs)[:, :, :, None]
    # state update: h' = h*exp(cs_Q) + sum_j exp(cs_Q - cs_j) dt_j B_j x_j
    w = torch.exp(cs[:, -1:, :] - cs) * dtc                         # [B,Q,H]
    dh = torch.einsum("bjh,bjn,bjhp->bhpn", w, Bc.to(ct), xc.to(ct))
    h = h * torch.exp(cs[:, -1])[:, :, None, None] + dh
    return h, (y_intra.to(ct) + y_inter).to(dt_)


def ssd(xin, Bm, Cm, dt, dA, chunk: int):
    """The chunked SSD over a whole sequence, from a zero state: y [B, S,
    H, P] in xin's dtype for xin [B, S, H, P], Bm/Cm [B, S, N] and dt/dA
    [B, S, H] f32. Chunks of min(chunk, S) rows; the last may be short
    (the reference pads it with zero rows, which add no term to the rows
    before them). The plain version of ``csrc/ssd.cu``: the CPU route of
    ``kernels.ops.ssd``, and what the kernels are held against."""
    B_, S, H, P = xin.shape
    Q = min(chunk, S)
    h = xin.new_zeros((B_, H, P, Bm.shape[-1]), dtype=math_dtype(xin.dtype))
    ys = []
    for c0 in range(0, S, Q):
        c1 = min(S, c0 + Q)
        h, y = _ssd_chunk(h, xin[:, c0:c1], Bm[:, c0:c1], Cm[:, c0:c1],
                          dt[:, c0:c1], dA[:, c0:c1], xin.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1)
