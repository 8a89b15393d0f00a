"""Sliding-window flash-attention CUDA kernel wrapper (``csrc/swa_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/swa_attention.py::swa_attention``.
``swa_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.library("swa_attention")
        fn = lib.swa_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on the GPU; key j visible to query i iff
    (not causal or j <= i) and (window is None or j > i - window).

    q, k, v: [BH, S, D] contiguous CUDA tensors of one dtype (bf16 or f32),
    D in ``HEAD_DIMS``. f32 math; output in ``q.dtype``.
    """
    if not q.is_cuda:
        raise ValueError(f"swa_attention kernel needs CUDA tensors, got {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"swa_attention kernel takes bf16 or f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or not (k.shape == v.shape == q.shape):
        raise ValueError(f"q, k, v must be [BH, S, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("swa_attention kernel needs contiguous, 16-byte "
                             "aligned q, k, v")
    o = torch.empty_like(q)
    if bh == 0 or s == 0:
        return o
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib, "swa_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
            int(causal), window or 0, _DTYPES[q.dtype], stream))
    swa_attention.launches += 1
    return o


swa_attention.launches = 0
