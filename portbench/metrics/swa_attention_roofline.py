"""``kernels.swa_attention``'s share (%) of its roofline: the least time of
the traced calls (``least_seconds`` of each call's shapes and mask) over
the profiler's device time of the kernels named ``swa_attention``, mean
over ranks.

The traced window records each call of ``ENTRY`` as ``describe`` gives it.
``pairs`` and ``cost`` are frozen copies of ``swa_pairs`` and
``swa_attention_cost`` of ``src/repro_torch/kernels/ops.py`` (as of the
port's first benchmark)."""
import numpy as np

from portbench import costs

ENTRY = ("repro_torch.kernels.swa_attention", "swa_attention")
KERNEL = "swa_attention"


def describe(q, k, v, *, causal=True, window=None, q_offset=0):
    return [list(q.shape), k.shape[1], q.element_size(), causal, window, q_offset]


def pairs(sq: int, sk: int, *, causal: bool, window, q_offset: int = 0) -> int:
    """The (query, key) pairs the mask lets through: one head's work."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(bh: int, sq: int, sk: int, d: int, elt: int, *, causal: bool, window,
         q_offset: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one call: q, k, v read and o written once;
    q.k and p.v, 2 operations a multiply-add each, over the pairs the mask
    lets through."""
    n = pairs(sq, sk, causal=causal, window=window, q_offset=q_offset)
    return 4.0 * d * n * bh, float(2 * bh * (sq + sk) * d * elt)


def least_seconds(q_shape, sk: int, elt: int, causal: bool, window, q_offset: int) -> float:
    """bf16 runs on the tensor cores, f32 on the CUDA cores (the kernel's
    two routes)."""
    bh, sq, d = q_shape
    return costs.least_seconds(*cost(bh, sq, sk, d, elt, causal=causal, window=window,
                                     q_offset=q_offset), costs.ELEMENT_PEAK[elt])


def read(traces):
    return costs.roofline_percent(traces, KERNEL, least_seconds)
