"""90th percentile of a step's time: the host clock between synchronised
step ends, over every step of the traced window of every rank."""
import statistics


def read(traces):
    ms = [x for t in traces for x in t["step_ms"]]
    return statistics.quantiles(ms, n=10)[8] if len(ms) >= 2 else None
