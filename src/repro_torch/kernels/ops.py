"""Dispatch for the kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the plain PyTorch version in ``kernels.ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is
no fallback from one to the other.
"""
from __future__ import annotations

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


def rmsnorm(x, w, *, eps: float = 1e-6):
    """RMSNorm with gain 1 + w. x: [..., D]; w: [D] f32."""
    if _route(x, "rmsnorm"):
        return _rms.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def swa_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Sliding-window flash attention. q/k/v: [BH, S, D]."""
    if _route(q, "swa_attention"):
        return _swa.swa_attention(q, k, v, causal=causal, window=window)
    return ref.swa_attention_ref(q, k, v, causal=causal, window=window)


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
