"""Sliding-window flash-attention CUDA kernel wrapper (``csrc/swa_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/swa_attention.py::swa_attention``,
and extends it to cross-attention (queries and keys of different lengths,
queries at an offset) for whisper's decoder.
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on the GPU; query row i sits at position
    p = q_offset + i, and key j is visible to it iff (not causal or j <= p)
    and (window is None or j > p - window).

    q: [BH, Sq, D]; k, v: [BH, Sk, D] (Sq = Sk and q_offset = 0 for
    self-attention; cross-attention has Sq != Sk). Contiguous CUDA tensors
    of one dtype (bf16 or f32), D in ``HEAD_DIMS``; output [BH, Sq, D] in
    ``q.dtype``, softmax state in f32. bf16 products run on the tensor
    cores (P split into bf16 hi + lo halves for P.V), f32 products on the
    CUDA cores. Every query row must see at least one key. No backward of
    its own: raises when grad mode is on and an input requires grad;
    training reaches it through ``kernels.ops.swa_attention``'s autograd
    Function.
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
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    bh, sq, d = q.shape
    sk = k.shape[1]
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("swa_attention kernel needs contiguous, 16-byte "
                             "aligned q, k, v")
    o = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return o
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib, "swa_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, sk, d,
            int(causal), window or 0, q_offset, _DTYPES[q.dtype], stream))
    swa_attention.launches += 1
    return o


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int | None, q_offset: int) -> None:
    """Raise ValueError unless q is [BH, Sq, D] and k, v are [BH, Sk, D]
    with D in ``HEAD_DIMS``, and every query row sees a key: Sk > 0 and,
    with a window, the last row's band (q_offset + Sq - 1 - window,
    q_offset + Sq - 1] reaches below Sk."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q must be [BH, Sq, D] and k, v [BH, Sk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be at least 0, got {q_offset}")
    sq, sk = q.shape[1], k.shape[1]
    if sq and (sk == 0 or (window is not None and q_offset + sq - window >= sk)):
        raise ValueError(f"a query row would see no key: Sq {sq}, Sk {sk}, "
                         f"window {window}, q_offset {q_offset}")


swa_attention.launches = 0
