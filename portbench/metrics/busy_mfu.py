"""The whole step's share (%) of one card's bf16 dense peak while the
device works: each rank's model flops of the device-traced steps over the
device's busy time in them (the union of its kernel intervals, read from
the trace), mean over ranks. Idle time and the profiler's slowing of the
host are outside it; ``train_mfu`` holds them. It bounds the kernels'
roofline shares: a kernel taken off the path leaves its own share silent,
not this one."""
import statistics

from portbench import costs


def read(traces):
    vals = [costs.mfu_percent(t["flops_per_step"] * t["steps"], t["busy_s"], 1)
            for t in traces if t["busy_s"] > 0]
    return statistics.fmean(vals) if vals else None
