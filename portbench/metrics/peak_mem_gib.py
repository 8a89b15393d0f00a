"""Peak device memory over the window (``max_memory_allocated`` after a
reset at its start), GiB, on the fullest card."""


def read(traces):
    peak = max(t["peak_bytes_window"] for t in traces)
    return peak / 2**30 if peak > 0 else None
