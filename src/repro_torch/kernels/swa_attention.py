"""Sliding-window flash-attention CUDA kernel wrapper (``csrc/swa_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/swa_attention.py::swa_attention``.
The source holds two kernels, chosen by dtype: bf16 runs on the tensor cores
(``mma.sync`` with ``cp.async``-fed K/V tiles), f32 on the CUDA
cores, because TF32 products cannot hold the reference's f32 tolerance.
``swa_attention.launches`` counts the launches of both; ``design`` reads
each kernel's tiles and resources from the built library.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel of the source that runs each dtype
KERNELS = {torch.bfloat16: "swa_attention_mma_kernel",
           torch.float32: "swa_attention_kernel"}
DESIGN_FIELDS = ("q_rows", "kv_keys", "stages", "warps", "smem_bytes",
                 "registers", "local_bytes")
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


def design(dtype: torch.dtype, d: int) -> dict:
    """The kernel that runs ``dtype`` at head dim ``d``, as the built library
    reports it: its name and ``DESIGN_FIELDS`` (tile sizes, K/V ring stages,
    warps and dynamic shared-memory bytes per block, and the compiler's
    registers and local-memory bytes per thread). Needs a CUDA device."""
    if dtype not in _DTYPES:
        raise TypeError(f"swa_attention has no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    lib, _ = _launcher()
    fn = lib.swa_attention_design
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(DESIGN_FIELDS))()
    build.check(lib, "swa_attention", fn(_DTYPES[dtype], d, out))
    return {"kernel": KERNELS[dtype], **dict(zip(DESIGN_FIELDS, out))}


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on the GPU; key j visible to query i iff
    (not causal or j <= i) and (window is None or j > i - window).

    q, k, v: [BH, S, D] contiguous CUDA tensors of one dtype (bf16 or f32),
    D in ``HEAD_DIMS``; output in ``q.dtype``, softmax state in f32. bf16
    products run on the tensor cores (P split into bf16 hi + lo halves for
    P.V), f32 products on the CUDA cores. No backward of its own: raises
    when grad mode is on and an input requires grad; training reaches it
    through ``kernels.ops.swa_attention``'s autograd Function.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("swa_attention kernel has no backward: call it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")
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
