"""Device time a step inside ``Optimizer.update`` (AdamW): the profiler's
kernels inside the benchmark's span around the update, in the one step
traced with the host's ops; mean over ranks."""
import statistics


def read(traces):
    vals = [t["optimizer_ms"] for t in traces if t["optimizer_ms"] > 0]
    return statistics.fmean(vals) if vals else None
