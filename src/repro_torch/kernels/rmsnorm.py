"""RMSNorm CUDA kernel wrapper (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
``rmsnorm.launches`` counts the kernel's launches, and
``rmsnorm.grouped_launches`` those of them with a weight per group
(``w [G, D]``, G > 1: Mamba-2's gated norm, a weight per head). ``design``
reads from the built library which route runs a width, and its shape.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("general", "small", "wide")
DESIGN_FIELDS = ("lanes", "rows_per_warp", "threads", "vectors", "load_bytes",
                 "registers", "local_bytes")
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


def design(d: int, dtype: torch.dtype, aligned: bool = True) -> dict:
    """The kernel that runs rows of ``d`` elements of ``dtype``, with
    16-byte aligned x, y and w or not, as the built library reports it:
    its route (``ROUTES``) and ``DESIGN_FIELDS`` (lanes a row, rows a warp
    (0 when a row spans several warps), threads a block, 16-byte vectors a
    lane holds (0 on the general route, which reads the row twice), bytes
    a load, and the compiler's registers and local-memory bytes a thread).
    Needs a CUDA device."""
    if dtype not in _DTYPES:
        raise TypeError(f"rmsnorm has no kernel for {dtype}")
    if d < 1:
        raise ValueError(f"width must be positive, got {d}")
    lib, _ = _launcher()
    fn = lib.rmsnorm_design
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (1 + len(DESIGN_FIELDS)))()
    build.check(lib, "rmsnorm", fn(d, _DTYPES[dtype], int(aligned), out))
    return {"route": ROUTES[out[0]], **dict(zip(DESIGN_FIELDS, out[1:]))}


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
    w_dims, shape = w.ndim, x.shape
    if w_dims not in (1, 2) or len(shape) < w_dims or shape[-w_dims:] != w.shape:
        raise ValueError(f"x {tuple(shape)} and w {tuple(w.shape)} do not match: "
                         "w is [D] or [G, D] and x ends in w's shape")
    if not x.is_cuda:
        raise ValueError(f"rmsnorm kernel needs a CUDA tensor, got {x.device}")
    device = x.get_device()
    if w.get_device() != device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"rmsnorm kernel takes bf16 or f32 x, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes f32 w, got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    d = shape[-1]
    lib, fn = _fn or _launcher()
    # the current stream's handle without building a torch.cuda.Stream, as
    # PyTorch's own generated kernel launchers read it
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), n // d, d, w.numel() // d, eps, dtype,
            torch._C._cuda_getCurrentRawStream(device))
    if device == torch.cuda.current_device():
        code = fn(*args)
    else:
        with torch.cuda.device(device):
            code = fn(*args)
    if code:
        build.check(lib, "rmsnorm", code)
    rmsnorm.launches += 1
    if w_dims == 2 and w.shape[0] > 1:
        rmsnorm.grouped_launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.grouped_launches = 0
