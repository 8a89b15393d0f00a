"""``kernels.rmsnorm``'s share (%) of its roofline: the least time of the
traced calls (``least_seconds`` of each call's shapes) over the profiler's
device time of the kernels named ``rmsnorm``, mean over ranks.

The traced window records each call of ``ENTRY`` as ``describe`` gives it.
``cost`` is a frozen copy of ``rmsnorm_cost`` of
``src/repro_torch/kernels/ops.py`` (as of the port's first benchmark)."""
import math

from portbench import costs

ENTRY = ("repro_torch.kernels.rmsnorm", "rmsnorm")
KERNEL = "rmsnorm"


def describe(x, w, *, eps=1e-6):
    return [list(x.shape), list(w.shape), x.element_size()]


def cost(x_shape, w_shape, elt: int) -> tuple[float, float]:
    """(operations, bytes) of one call: x read and y written in their dtype
    (``elt`` bytes), the f32 gain read once; 5 operations an element
    (square, sum, scale, gain, cast)."""
    n = math.prod(x_shape)
    return 5.0 * n, float(2 * n * elt + 4 * math.prod(w_shape))


def least_seconds(x_shape, w_shape, elt: int) -> float:
    """The statistics run in f32 on the CUDA cores, whatever x's dtype."""
    return costs.least_seconds(*cost(x_shape, w_shape, elt), costs.F32_CUDA_CORE_FLOPS)


def read(traces):
    return costs.roofline_percent(traces, KERNEL, least_seconds)
