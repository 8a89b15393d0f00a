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
