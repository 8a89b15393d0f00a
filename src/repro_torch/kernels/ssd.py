"""Chunked SSD CUDA kernels wrapper (``csrc/ssd.cu``), forward and backward.

Replaces no TPU kernel: the reference computes Mamba-2's SSD in plain
``jnp`` (``repro/models/mamba2.py``), and so did the port's plain version
(``kernels.ref.ssd``), a Python loop of ~35 torch ops a chunk. The kernels
compute the same function and its gradient in ``FORWARD_LAUNCHES`` and
``BACKWARD_LAUNCHES`` launches a call. ``ssd_forward.launches`` and
``ssd_backward.launches`` count the kernels launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIM = 64
STATE_DIMS = (16, 128)  # jamba-v0.1-52b's and mamba2-780m's: the instances built
MAX_CHUNK = 256
FORWARD_LAUNCHES = 3
BACKWARD_LAUNCHES = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = build.library("ssd")
        fwd = lib.ssd_forward_launch
        fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.ssd_backward_launch
        bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.ssd_heads_per_group.restype = ctypes.c_int
        _fns = (lib, fwd, bwd, lib.ssd_heads_per_group())
    return _fns


def check_inputs(xin, Bm, Cm, dt, dA, chunk: int) -> tuple[int, int, int, int, int]:
    """Raise unless the kernels take these inputs; -> (B, S, H, N, Q).

    xin [B, S, H, 64] and Bm, Cm [B, S, N] (N in ``STATE_DIMS``) of one
    dtype, bf16 or f32; dt, dA [B, S, H] f32; all contiguous and 16-byte
    aligned (the kernels read 16-byte vectors), on one CUDA device; chunks of Q = min(chunk, S) rows, at most ``MAX_CHUNK``."""
    if not xin.is_cuda:
        raise ValueError(f"ssd kernels need CUDA tensors, got {xin.device}")
    if any(t.device != xin.device for t in (Bm, Cm, dt, dA)):
        raise ValueError("ssd: xin, Bm, Cm, dt and dA must be on one device")
    if xin.dtype not in _DTYPES or not (Bm.dtype == Cm.dtype == xin.dtype):
        raise TypeError(f"ssd kernels take bf16 or f32 xin, Bm, Cm of one dtype, got "
                        f"{xin.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not (dt.dtype == dA.dtype == torch.float32):
        raise TypeError(f"ssd kernels take f32 dt and dA, got {dt.dtype}, {dA.dtype}")
    if xin.dim() != 4 or xin.shape[-1] != HEAD_DIM:
        raise ValueError(f"xin must be [B, S, H, {HEAD_DIM}], got {tuple(xin.shape)}")
    b, s, h, _ = xin.shape
    if Bm.dim() != 3 or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (b, s) \
            or Bm.shape[2] not in STATE_DIMS:
        raise ValueError(f"Bm, Cm must be [B, S, N] with N in {STATE_DIMS}, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if tuple(dt.shape) != (b, s, h) or dt.shape != dA.shape:
        raise ValueError(f"dt, dA must be [B, S, H] = {(b, s, h)}, got "
                         f"{tuple(dt.shape)}, {tuple(dA.shape)}")
    q = min(chunk, s)
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"ssd kernels take chunks of 1 to {MAX_CHUNK} rows, got {q}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (xin, Bm, Cm, dt, dA)):
        raise ValueError("ssd kernels need contiguous, 16-byte aligned inputs")
    return b, s, h, Bm.shape[2], q


def _tiles(q: int) -> int:
    """The chunk rounded up to whole 64-row tiles: the side of the
    kernels' [Q, Q] scratch blocks."""
    return -(-q // 64) * 64


def _launch(fn, device: int, *args) -> int:
    """fn(*args, stream) on ``device``'s current stream; the device is
    made current only when it is not already."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def ssd_forward(xin, Bm, Cm, dt, dA, chunk: int):
    """-> (y, cs, states): y [B, S, H, 64] in xin's dtype, the chunked SSD
    from a zero state (``kernels.ref.ssd``); cs [B, S, H] f32, the cumsum
    of dA within each chunk; states [B, nc, H, 64, N] f32, the state
    entering each chunk. cs and states are what ``ssd_backward`` needs.
    No backward of its own: ``kernels.ops.ssd``'s autograd Function pairs
    the two."""
    b, s, h, n, q = check_inputs(xin, Bm, Cm, dt, dA, chunk)
    nc = -(-s // q)
    f32 = dict(dtype=torch.float32, device=xin.device)
    y = torch.empty_like(xin)
    cs = torch.empty((b, s, h), **f32)
    states = torch.empty((b, nc, h, HEAD_DIM, n), **f32)
    cb = torch.empty((b, nc, _tiles(q), _tiles(q)), **f32)
    lib, fwd, _, _ = _fns or _launchers()
    code = _launch(fwd, xin.get_device(), xin.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   dt.data_ptr(), dA.data_ptr(), cs.data_ptr(), cb.data_ptr(),
                   states.data_ptr(), y.data_ptr(), b, s, h, n, q, _DTYPES[xin.dtype])
    if code:
        build.check(lib, "ssd", code)
    ssd_forward.launches += FORWARD_LAUNCHES
    return y, cs, states


def ssd_backward(dy, xin, Bm, Cm, dt, dA, cs, states, chunk: int):
    """-> (dxin, dBm, dCm, ddt, ddA), the gradient of ``ssd_forward``'s y
    for the cotangent dy [B, S, H, 64] (xin's dtype), from its inputs and
    its cs and states; each in its input's dtype, all computed in f32."""
    b, s, h, n, q = check_inputs(xin, Bm, Cm, dt, dA, chunk)
    nc = -(-s // q)
    if dy.shape != xin.shape or dy.dtype != xin.dtype or not dy.is_contiguous() \
            or dy.data_ptr() % 16 or dy.device != xin.device:
        raise ValueError(f"dy must be a contiguous, aligned {tuple(xin.shape)} {xin.dtype} "
                         f"tensor on {xin.device}, got {tuple(dy.shape)} {dy.dtype}")
    if tuple(cs.shape) != (b, s, h) or tuple(states.shape) != (b, nc, h, HEAD_DIM, n):
        raise ValueError("cs and states must be ssd_forward's")
    lib, _, bwd, per_group = _fns or _launchers()
    groups = -(-h // per_group)
    f32 = dict(dtype=torch.float32, device=xin.device)
    dx, dB, dC = torch.empty_like(xin), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, ddA = torch.empty_like(dt), torch.empty_like(dA)
    qt = _tiles(q)
    cb = torch.empty((b, nc, qt, qt), **f32)
    dcb = torch.empty((groups, b, nc, qt, qt), **f32)
    g = torch.empty((b, nc, h, HEAD_DIM, n), **f32)
    code = _launch(bwd, xin.get_device(), dy.data_ptr(), xin.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), dt.data_ptr(), cs.data_ptr(), states.data_ptr(),
                   cb.data_ptr(), dcb.data_ptr(), g.data_ptr(), dx.data_ptr(), dB.data_ptr(),
                   dC.data_ptr(), ddt.data_ptr(), ddA.data_ptr(), b, s, h, n, q, groups,
                   _DTYPES[xin.dtype])
    if code:
        build.check(lib, "ssd", code)
    ssd_backward.launches += BACKWARD_LAUNCHES
    return dx, dB, dC, ddt, ddA


ssd_forward.launches = 0
ssd_backward.launches = 0
