"""Share (%) of a step in which no kernel runs on the device: one minus the
device's busy time a step (the union of kernel intervals over the
device-traced steps, a step) over the mean time a step of the traced
run's window (host clock between synchronised step ends, no profiler
running). The profiler's own window is not the denominator: it slows the
host's launches and so stretches the idle time it would measure. NCCL's
kernels count as busy, also while they wait for a peer. Mean over ranks."""
import statistics


def read(traces):
    vals = [100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (t["loop_s"] / len(t["step_ms"])))
            for t in traces if t["busy_s"] > 0 and t["step_ms"]]
    return statistics.fmean(vals) if vals else None
