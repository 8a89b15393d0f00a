"""Fused momentum-SGD CUDA kernel wrapper (``csrc/fused_sgd_update.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/fused_update.py::fused_sgd_update``:
one launch updates a whole flat parameter buffer and its momentum in place
from the flat gradient buffer (the Horovod fusion buffer of the kernel's
docstring). ``fused_sgd_update.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.library("fused_sgd_update")
        fn = lib.fused_sgd_update_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def fused_sgd_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     lr: float, *, momentum: float = 0.9,
                     weight_decay: float = 1e-4, nesterov: bool = False):
    """Momentum SGD on the GPU, in place on ``p`` and ``mu``:
    ``g' = g + wd*p; mu = m*mu + g'; p -= lr * (g' + m*mu if nesterov else mu)``.

    p, g, mu: 1-D contiguous f32 CUDA tensors of one length on one device,
    not overlapping (views into larger buffers, at any offset, are fine).
    Returns ``(p, mu)``.
    """
    if not p.is_cuda:
        raise ValueError(f"fused_sgd_update kernel needs CUDA tensors, got {p.device}")
    if not (g.device == mu.device == p.device):
        raise ValueError(f"p on {p.device}, g on {g.device}, mu on {mu.device}")
    if not (p.dtype == g.dtype == mu.dtype == torch.float32):
        raise TypeError(f"fused_sgd_update kernel takes f32 p, g, mu, got "
                        f"{p.dtype}, {g.dtype}, {mu.dtype}")
    if not (p.dim() == g.dim() == mu.dim() == 1) or not (
            p.shape == g.shape == mu.shape):
        raise ValueError(f"p, g, mu must be 1-D of one length, got {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(mu.shape)}")
    if not (p.is_contiguous() and g.is_contiguous() and mu.is_contiguous()):
        raise ValueError("fused_sgd_update kernel needs contiguous p, g, mu")
    spans = sorted(_span(t) for t in (p, g, mu))
    if p.numel() and any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError("p, g and mu must not overlap")
    if p.numel() == 0:
        return p, mu
    lib, fn = _launcher()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        build.check(lib, "fused_sgd_update", fn(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), p.numel(), float(lr),
            float(momentum), float(weight_decay), int(bool(nesterov)), stream))
    fused_sgd_update.launches += 1
    return p, mu


fused_sgd_update.launches = 0
