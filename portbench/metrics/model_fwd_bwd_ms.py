"""Device time a step of the model's forward and backward (``models.*``,
``models.layers`` and the kernels they call): the profiler's kernel time a
device-traced step without NCCL's kernels, less the optimizer's kernel
time (the step traced with spans). On four cards it holds the ring's adds
and the division by w, which run outside NCCL; mean over ranks."""
import statistics


def read(traces):
    vals = []
    for t in traces:
        nccl = sum(v for k, v in t["kernel_ms_by_name"].items() if "nccl" in k.lower())
        if t["kernel_ms"] > 0:
            vals.append((t["kernel_ms"] - nccl) / t["steps"] - t["optimizer_ms"])
    return statistics.fmean(vals) if vals else None
