"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

f32 math throughout, output in the input dtype. The CPU path of
``kernels.ops`` runs these; on the GPU they are what each kernel is held
against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, *, causal: bool = True,
                      window: int | None = None):
    """q, k, v: [BH, S, D] -> [BH, S, D]; f32 math throughout."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqd,bkd->bqk", qf, kf) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
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
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
