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


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
