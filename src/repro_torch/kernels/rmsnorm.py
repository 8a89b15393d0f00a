"""RMSNorm CUDA kernel wrapper (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
``rmsnorm.launches`` counts the kernel's launches, and
``rmsnorm.grouped_launches`` those of them with a weight per group
(``w [G, D]``, G > 1: Mamba-2's gated norm, a weight per head).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.library("rmsnorm")
        fn = lib.rmsnorm_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * (1 + w)`` on the GPU.

    x: [..., D] contiguous CUDA bf16 or f32; w: f32 on the same device,
    [D] (one gain for every row), or [G, D] with ``x.shape[-2:] == (G, D)``
    (row r of x, counted over the leading dims, takes gain row r mod G: a
    gain per head of ``x [B, S, H, P]``, as the reference broadcasts it).
    Any other shape of w is refused. Statistics in f32, output in
    ``x.dtype``. No backward of its own: raises when grad mode is on and
    an input requires grad; training reaches it through
    ``kernels.ops.rmsnorm``'s autograd Function.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rmsnorm kernel has no backward: call it under "
                           "torch.no_grad() or on inputs that do not require "
                           "grad")
    if w.dim() not in (1, 2) or x.dim() < w.dim() or x.shape[-w.dim():] != w.shape:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not match: "
                         "w is [D] or [G, D] and x ends in w's shape")
    if not x.is_cuda:
        raise ValueError(f"rmsnorm kernel needs a CUDA tensor, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes bf16 or f32 x, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes f32 w, got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")
    y = torch.empty_like(x)
    d = x.shape[-1]
    groups = w.numel() // d if d else 1
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib, "rmsnorm", fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                       rows, d, groups, eps, _DTYPES[x.dtype], stream))
    rmsnorm.launches += 1
    if groups > 1:
        rmsnorm.grouped_launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.grouped_launches = 0
