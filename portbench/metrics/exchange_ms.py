"""Device time a step of the gradient exchange: the NCCL kernels (the
ring's send and receive rounds, ``trace.LM_KERNEL_GROUPS["exchange"]``) of
a device-traced step, mean over ranks. A rank's NCCL kernel runs from its
launch until its peer's data has come, so the time holds the wait for the
slowest rank as well as the transfer; the ring's additions and the
division by the ranks run outside NCCL and are in ``model_fwd_bwd_ms``.
None where no rank traced an NCCL kernel."""
import statistics


def read(traces):
    vals = [t["groups_ms_per_step"]["exchange"] for t in traces
            if "exchange" in t["groups_ms_per_step"]]
    return statistics.fmean(vals) if vals else None
