"""The traced window (``--trace 1``) and its reduction to the numbers the
per-layer readers take.

Every step of the window is timed on the host between synchronised step
ends. Then ``trace_steps`` more steps run under ``torch.profiler`` tracing
the device alone, with each call of the hand-written kernels that the
cell's roofline readers declare recorded with its shapes: busy time,
kernel time by name and the rooflines come from them. Tracing the host's
ops too made a step 2.5 times as long, so that is done for one step more
only, with spans of the benchmark's own
around the step and the optimizer's ``update``: the optimizer's kernel
time and the idle gaps' host ops come from it. NCCL's kernels are told
by their names. The device-traced steps' chrome trace is written under
the checkout, at a fixed path a cell.

``LM_KERNEL_GROUPS`` and the sums by kernel name are frozen copies, adapted
to a training step, of ``chip_smoke.py``'s ``LM_KERNEL_GROUPS`` and
``device_profile`` (as of the port's first benchmark). Its ``op_groups``,
which needs the profiler to record every op's shapes, is not copied: that
recording made a traced step 3.8 times as long as an untraced one
(NVIDIA H100 80GB HBM3, qwen2.5-3b.train).
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import harness

TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "portbench" / "traces"
TOP = 10
# kernel-name substrings of an LM train step's parts (chip_smoke.py)
LM_KERNEL_GROUPS = {
    "rmsnorm": ("rmsnorm",),
    "swa_attention": ("swa_attention",),
    "exchange": ("nccl",),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass"),
    "index": ("index", "scatter", "gather"),
    "softmax_logsumexp": ("softmax", "logsumexp"),
    "reduce": ("reduce_kernel",),
    "elementwise": ("elementwise", "vectorized"),
}


def _recorder(fn, describe, log: list):
    """``fn`` that first logs ``describe`` of each call's arguments. It
    shares ``fn``'s attributes, so the kernel's launch counters
    (``fn.launches``, which the kernel raises through its module's name)
    keep counting on the original."""
    def recorded(*a, **k):
        log.append(describe(*a, **k))
        return fn(*a, **k)
    recorded.__dict__ = fn.__dict__
    return recorded


@contextlib.contextmanager
def recording(readers):
    """Record the calls of the hand-written kernels that ``readers`` (the
    cell's metric readers) declare: a reader's ``ENTRY`` (module, name) is
    the kernel's entry point, its ``describe`` turns a call's arguments
    into what its roofline takes, logged under its ``KERNEL``."""
    calls, saved = {}, []
    for r in readers:
        mod = importlib.import_module(r.ENTRY[0])
        fn = getattr(mod, r.ENTRY[1])
        saved.append((mod, r.ENTRY[1], fn))
        setattr(mod, r.ENTRY[1], _recorder(fn, r.describe, calls.setdefault(r.KERNEL, [])))
    try:
        yield calls
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def kernel_readers(cell) -> list:
    """The cell's metric readers that declare a kernel to record."""
    mods = [harness.load_module("metrics", m["name"]) for m in cell.per_layer]
    return [m for m in mods if hasattr(m, "ENTRY")]


def traced_window(prog, state, feed, first: int, n: int, k: int, world: int):
    """The window's n steps, each timed between synchronised ends; then k
    steps traced on the device alone (kernels, with the kernels' calls
    recorded), and one more with the host's ops and the benchmark's spans
    too, from which the optimizer's and the exchange's shares and the
    idle gaps' host ops are read. Returns (state, the window's losses,
    summary, the window's start on the wall clock)."""
    dev = prog.device
    step_ms, losses = [], []
    harness._barrier(dev, world)
    start_wall, t_loop = time.time(), time.perf_counter()
    for i in range(first, first + n):
        t0 = time.perf_counter()
        state, loss = prog(state, feed, i)
        harness._sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    harness._barrier(dev, world)
    loop_s = time.perf_counter() - t_loop
    rank = torch.distributed.get_rank() if world > 1 else 0
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    with recording(kernel_readers(prog.cell)) as calls:
        device_only = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                          else ProfilerActivity.CPU])
        # the ranks' barriers stay outside the device trace, where their
        # NCCL kernels would count as the exchange's
        harness._barrier(dev, world)
        device_only.start()
        t_prof = time.perf_counter()
        for i in range(first + n, first + n + k):
            state, _ = prog(state, feed, i)
        harness._sync(dev)
        window_s = time.perf_counter() - t_prof
        device_only.stop()
        harness._barrier(dev, world)
        calls = {name: list(v) for name, v in calls.items()}
        spans = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        spans.start()
        with record_function(harness.SPAN_STEP):
            state, _ = prog(state, feed, first + n + k)
        harness._barrier(dev, world)
        spans.stop()
    device_only.export_chrome_trace(str(TRACE_DIR / f"{prog.cell.name}.rank{rank}.json"))
    summary = summarize(device_only, k, window_s)
    summary.update(span_summary(spans), step_ms=step_ms, loop_s=loop_s,
                   kernel_calls=calls)
    return state, losses, summary, start_wall


def _union(intervals) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals, and the gaps
    between its pieces."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def _events(prof):
    """(kernels, annotation ranges by name, host ops) of a profile, each as
    (start, end[, name]) in the profiler's microseconds."""
    kernels, spans, host = [], {}, []
    for e in prof.events():
        tr = e.time_range
        note = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA:
            if note:
                spans.setdefault(e.name, []).append((tr.start, tr.end))
            else:
                kernels.append((tr.start, tr.end, e.name))
        elif not note:
            host.append((tr.start, tr.end, e.name))
    return kernels, spans, host


def summarize(prof, steps: int, window_s: float) -> dict:
    """The device-traced steps' numbers: device busy time (the union of
    kernel intervals, NCCL's kernels included), kernel time by name and by
    group, and the kernels that took most time."""
    kernels, _, _ = _events(prof)
    busy_us, _ = _union((a, b) for a, b, _ in kernels)
    by_name: dict[str, float] = {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    groups = dict.fromkeys([*LM_KERNEL_GROUPS, "other"], 0.0)
    for name, us in by_name.items():
        g = next((g for g, keys in LM_KERNEL_GROUPS.items()
                  if any(key in name for key in keys)), "other")
        groups[g] += us
    return {"steps": steps, "window_s": window_s, "busy_s": busy_us / 1e6,
            "kernel_ms_by_name": {k: v / 1e3 for k, v in by_name.items()},
            "kernel_ms": sum(by_name.values()) / 1e3,
            "groups_ms_per_step": {g: us / 1e3 / steps for g, us in groups.items() if us},
            "breakdown": {"device_ops": [[name, us / 1e6] for name, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]]}}


def span_summary(prof) -> dict:
    """One step traced with the host's ops: the kernel time inside the
    optimizer's span (the kernels that start in one of its ranges on the
    device timeline), and the idle gaps by the host op across them."""
    kernels, spans, host = _events(prof)
    ranges = sorted(spans.get(harness.SPAN_OPT, []))
    starts = [a for a, _ in ranges]
    total = 0.0
    for a, b, _ in kernels:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a <= ranges[i][1]:
            total += b - a
    _, gaps = _union((a, b) for a, b, _ in kernels)
    return {"optimizer_ms": total / 1e3, "idle_gaps": idle_gaps(gaps, host),
            "spans_seen": sorted(spans)}


def idle_gaps(gaps: list, cpu: list) -> list:
    """The idle time between kernels, summed by what the host ran across
    the middle of each gap (the innermost host op holding it), largest
    first."""
    if not gaps:
        return []
    starts = np.array([a for a, _, _ in cpu] or [0.0])
    ends = np.array([b for _, b, _ in cpu] or [0.0])
    by_host: dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = (a + b) / 2
        held = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (min((cpu[i] for i in held), key=lambda c: c[1] - c[0])[2]
                if len(held) else "host outside any op")
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]]
