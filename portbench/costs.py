"""The yardstick of the kernels' rooflines and of MFU: the H100's peaks, the
least time of a kernel's operations and bytes (a frozen copy of
``chip_smoke.py``'s ``bound``, as of the port's first benchmark) and a
roofline share from the traced calls. Each kernel's own operations and
bytes sit in its reader, ``metrics/<kernel>_roofline.py``.
"""
from __future__ import annotations

import statistics

# NVIDIA H100 SXM5 data sheet, dense rates, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
F32_CUDA_CORE_FLOPS = 67e12     # f32 outside the tensor cores
ELEMENT_PEAK = {2: BF16_TENSOR_FLOPS, 4: F32_CUDA_CORE_FLOPS}  # by element size


def least_seconds(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of operations over
    their peak and bytes over HBM's rate."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def mfu_percent(flops: float, seconds: float, chips: int) -> float:
    """Model flops over ``seconds`` as a share (%) of ``chips`` cards' bf16
    dense peak."""
    return 100.0 * flops / seconds / (BF16_TENSOR_FLOPS * chips)


def roofline_percent(traces, kernel: str, least):
    """A kernel's share (%) of its roofline on each rank, mean over ranks:
    the least time of its recorded calls (``least(*call)``) over
    the profiler's device time of the kernels whose names hold ``kernel``.
    None where a rank recorded no call or traced no such kernel."""
    vals = []
    for t in traces:
        calls = t["kernel_calls"].get(kernel, [])
        ms = sum(v for k, v in t["kernel_ms_by_name"].items() if kernel in k)
        if calls and ms > 0:
            vals.append(100.0 * sum(least(*c) for c in calls) * 1e3 / ms)
    return statistics.fmean(vals) if vals else None
