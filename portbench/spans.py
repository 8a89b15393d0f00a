"""The program's own spans, joined to the device's kernels: the span block.

``span_block`` runs ``trace_steps`` more steps under the program's step
tracer (``repro_torch.core.telemetry``) with ``torch.profiler`` tracing the
device alone, as the traced window's device-only block does, so that the
host is not slowed by op tracing. Each span's host stamps
(``time.time_ns()``) are put on the kernels' timeline through the
profile's ``trace_start_ns``. Between the block's opening and closing
barriers the device's idle time is split exactly (interval arithmetic,
no sampling):

- **backward** while ``train.backward``, or a span under it, is open on
  any thread (autograd's device thread runs the backward of CUDA tensors);
- else **forward** while the tracer's home thread is inside
  ``train.forward``;
- else **other**: staging, the exchange, the update's launches and the
  time between steps.

Then one step more runs traced with the host's ops too. The kernel time
inside the device-side ranges of the ``kernels.*.backward`` spans
(``record_function``'s range on the device timeline, as ``optimizer_ms``
reads the benchmark's span around the update) is the backward formulas'
time; each kernel's launch (the CUDA runtime call of the same
correlation) gives the kernels a step by the span that launched them. The span block's profile is written as
``<cell>.rank<r>.spans.json`` under the traced window's ``TRACE_DIR``, with
the spans as a host track beside the kernels.

``read`` takes each rank's trace summary with the block's summary under
``"spans"`` and returns a mean over ranks, or None where the program has
no spans to read.

    python3 portbench/spans.py --workload NAME --seed N --seconds S

runs a one-card cell's traced window (``trace.traced_window``), the span
block and ``--cost-rounds`` rounds of ``host_cost`` (what tracing costs
when on), and prints one JSON line: the existing per-layer readers'
values, the block's summary and the host time a step by mode.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import statistics
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

if __name__ == "__main__":  # run as a script from the root of a checkout
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness, trace  # noqa: E402

FORWARD, BACKWARD = "train.forward", "train.backward"
PARTS = ("forward", "backward", "other")
OUTSIDE = "outside any span"


# ------------------------------------------------ the timeline's arithmetic --
def idle_intervals(kernels, w0: float, w1: float) -> list[tuple[float, float]]:
    """The stretches of [w0, w1] in which no kernel of ``kernels`` ((start,
    end, ...) in one clock) runs, in order."""
    out, t = [], w0
    for a, b in sorted((max(k[0], w0), min(k[1], w1)) for k in kernels):
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def split_idle(idle, spans, home: int) -> tuple[dict, dict]:
    """Integrate ``idle`` (disjoint (a, b) intervals) over the spans open
    across it. ``spans``: dicts with name, id, parent, thread, start, end
    in the idle intervals' clock; ``home``: the tracer's home thread.
    Returns ({forward, backward, other}: time, {innermost open span's name:
    time}); each idle stretch is counted once in each, so both sum to the
    idle time. The innermost open span is the deepest (then the latest
    opened) over every thread."""
    by_id = {s["id"]: s for s in spans}

    def chain(s):
        while s is not None:
            yield s
            s = by_id.get(s["parent"])

    kind, depth = {}, {}
    for s in spans:
        names = [c["name"] for c in chain(s)]
        depth[s["id"]] = len(names)
        kind[s["id"]] = ("backward" if BACKWARD in names else
                         "forward" if s["thread"] == home and FORWARD in names else None)
    events = [(a, 0, 1, None) for a, _ in idle] + [(b, 0, -1, None) for _, b in idle]
    for s in spans:
        events += [(s["start"], 1, 1, s["id"]), (s["end"], 1, -1, s["id"])]
    events.sort(key=lambda e: e[0])
    parts, by_name = dict.fromkeys(PARTS, 0.0), {}
    open_, count = set(), dict.fromkeys(PARTS, 0)
    in_idle, last = 0, None
    for t, is_span, sign, sid in events:
        if in_idle > 0 and t > last:
            part = ("backward" if count["backward"] else
                    "forward" if count["forward"] else "other")
            parts[part] += t - last
            inner = max(open_, key=lambda i: (depth[i], by_id[i]["start"]), default=None)
            name = by_id[inner]["name"] if inner is not None else OUTSIDE
            by_name[name] = by_name.get(name, 0.0) + (t - last)
        last = t
        if not is_span:
            in_idle += sign
            continue
        if sign > 0:
            open_.add(sid)
        else:
            open_.discard(sid)
        if kind[sid] is not None:
            count[kind[sid]] += sign
    return parts, by_name


def kernel_us_in_ranges(kernels, ranges) -> float:
    """Kernel time of the kernels that start inside one of ``ranges``
    (disjoint (start, end) on the device timeline)."""
    ranges = sorted(ranges)
    starts = [a for a, _ in ranges]
    total = 0.0
    for a, b, *_ in kernels:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a <= ranges[i][1]:
            total += b - a
    return total


def kernels_by_launching_span(kernels, launches: dict, spans, home: int) -> dict:
    """Kernel time and count by the span that launched each kernel: the
    innermost span open on the launching thread when the launch call
    started, or, on a thread with none open (autograd's, outside a
    formula), the home thread's innermost. ``kernels``: (duration,
    correlation); ``launches``: correlation -> (host time, thread);
    ``spans`` as ``split_idle`` takes them, on the launches' clock. A
    kernel whose launch the trace lacks is "unattributed"."""
    events = [(s["start"], 1, s) for s in spans] + [(s["end"], -1, s) for s in spans]
    events += [(t, 0, corr) for corr, (t, _) in launches.items()]
    events.sort(key=lambda e: (e[0], -e[1]))
    stacks: dict[int, list] = {}
    named = {}
    for t, kind, x in events:
        if kind > 0:
            stacks.setdefault(x["thread"], []).append(x)
        elif kind < 0:
            stacks[x["thread"]].remove(x)
        else:
            stack = stacks.get(launches[x][1]) or stacks.get(home)
            named[x] = stack[-1]["name"] if stack else OUTSIDE
    out: dict[str, list] = {}
    for dur, corr in kernels:
        cell = out.setdefault(named.get(corr, "unattributed"), [0.0, 0])
        cell[0] += dur
        cell[1] += 1
    return out


def chrome_launches(doc: dict) -> tuple[list, dict]:
    """(kernels as (duration, correlation), launches as correlation ->
    (ts, tid)) of a Chrome trace that ``torch.profiler`` exported with
    CPU and CUDA activity; times in the file's µs."""
    kernels, launches = [], {}
    for e in doc["traceEvents"]:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append((e["dur"], corr))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[corr] = (e["ts"], e["tid"])
    return kernels, launches


def on_timeline(snapshot: dict, base_ns: int) -> list[dict]:
    """The tracer's spans with ``start`` and ``end`` in µs after
    ``base_ns``, the profile's ``trace_start_ns``."""
    return [{**s, "start": (s["start_ns"] - base_ns) / 1e3, "end": (s["end_ns"] - base_ns) / 1e3}
            for s in snapshot["spans"]]


# ---------------------------------------------------------- the span block --
def _device_only(dev) -> list:
    """The device-only block's profiler setting (the CPU's ops on the CPU,
    which has no device trace)."""
    return [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]


def span_block(prog, state, feed, first: int, k: int, world: int):
    """k steps from step ``first`` under the program's tracer and the
    device-only profile, then one with the host's ops; returns (state,
    summary)."""
    from repro_torch.core import telemetry

    tracer = telemetry.StepTracer()
    dev = prog.device
    prof = profile(activities=_device_only(dev))
    prof.start()
    harness._barrier(dev, world)
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    with telemetry.tracing(tracer):
        for i in range(first, first + k):
            state, _ = prog(state, feed, i)
        harness._barrier(dev, world)
        host_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    prof.stop()
    snap = tracer.snapshot()
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels, _, _ = trace._events(prof)
    spans = on_timeline(snap, base)
    w0, w1 = (t0_ns - base) / 1e3, (t1_ns - base) / 1e3
    idle = idle_intervals(kernels, w0, w1)
    parts, by_name = split_idle(idle, spans, snap["owner"])
    idle_us = sum(b - a for a, b in idle)
    rank = torch.distributed.get_rank() if world > 1 else 0
    export(prof, tracer, trace.TRACE_DIR / f"{prog.cell.name}.rank{rank}.spans.json")
    tracer.flush()

    both = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   if dev.type == "cuda" else [ProfilerActivity.CPU])
    both.start()
    with telemetry.tracing(tracer):
        state, _ = prog(state, feed, first + k)
        harness._barrier(dev, world)
    both.stop()
    one = tracer.flush()
    k_all, ranges, _ = trace._events(both)
    formulas = [kernel_us_in_ranges(k_all, ranges[name]) / 1e3
                for name in sorted({s["name"] for s in one["spans"]})
                if name.startswith("kernels.") and name.endswith(".backward") and name in ranges]
    doc = chrome(both)
    launched = kernels_by_launching_span(
        *chrome_launches(doc), on_timeline(one, int(doc.get("baseTimeNanoseconds", 0))),
        one["owner"])
    by_span = {name: {"ms": us / 1e3, "kernels": n} for name, (us, n) in sorted(
        launched.items(), key=lambda kv: -kv[1][0])}
    summary = {
        "steps": k, "host_ms_per_step": 1e3 * host_s / k,
        "window_ms_per_step": (w1 - w0) / 1e3 / k, "idle_ms_per_step": idle_us / 1e3 / k,
        "idle_ms_per_step_by_part": {p: v / 1e3 / k for p, v in parts.items()},
        "idle_s_by_innermost_span": dict(sorted(
            ((n, v / 1e6) for n, v in by_name.items()), key=lambda kv: -kv[1])),
        "kernels_per_step_by_launching_span": by_span,
        "backward_formulas_ms": sum(formulas) if formulas else None,
        "spans_per_step": {n: c / k for n, c in
                           Counter(s["name"] for s in snap["spans"]).items()},
        "counters_per_step": {n: v / k for n, v in snap["counters"].items()},
        "launches_per_step": {n: v / k for n, v in snap["launches"].items()},
    }
    return state, summary


def chrome(prof) -> dict:
    """``prof``'s Chrome trace as ``export_chrome_trace`` writes it."""
    with tempfile.TemporaryDirectory() as tmp:
        raw = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(raw))
        return json.loads(raw.read_text())


def export(prof, tracer, path: Path) -> None:
    """``prof``'s Chrome trace with ``tracer``'s spans added as a host track
    ("spans", a row a thread) on the same clock (the file's
    ``baseTimeNanoseconds``), for Perfetto."""
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = chrome(prof)
    doc["traceEvents"] += [{"ph": "M", "name": "process_name", "pid": "spans",
                            "args": {"name": "repro_torch spans"}}]
    doc["traceEvents"] += tracer.chrome_events(base_ns=int(doc.get("baseTimeNanoseconds", 0)))
    path.write_text(json.dumps(doc))


# ------------------------------------------------------- what tracing costs --
MODES = ("off", "spans", "profiler", "profiler+spans")


def host_cost(prog, state, feed, first: int, k: int, rounds: int):
    """Host ms a step of k steps between synchronised ends in each of
    ``MODES`` (the program's tracer on or off, the CUDA-only profiler on or
    off), the modes taken in turn, ``rounds`` times, each round starting
    one mode later. Returns (state, {mode: [ms a step, a round]})."""
    from repro_torch.core import telemetry

    dev, out, i = prog.device, {m: [] for m in MODES}, first
    for r in range(rounds):
        for m in MODES[r % len(MODES):] + MODES[:r % len(MODES)]:
            prof = profile(activities=_device_only(dev)) if "profiler" in m else None
            if prof is not None:
                prof.start()
            tracing = (telemetry.tracing(telemetry.StepTracer()) if "spans" in m
                       else contextlib.nullcontext())
            harness._sync(dev)
            t0 = time.perf_counter()
            with tracing:
                for _ in range(k):
                    state, _ = prog(state, feed, i)
                    i += 1
                harness._sync(dev)
            out[m].append(1e3 * (time.perf_counter() - t0) / k)
            if prof is not None:
                prof.stop()
    return state, out


def span_us(dev, n: int = 20_000) -> dict:
    """Host µs of one empty span, opened and closed n times on this
    thread: tracing off, on, and on under the device-only profile."""
    from repro_torch.core import telemetry

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("portbench.probe"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"off": loop()}
    with telemetry.tracing(telemetry.StepTracer(max_spans=n)):
        out["spans"] = loop()
    prof = profile(activities=_device_only(dev))
    prof.start()
    with telemetry.tracing(telemetry.StepTracer(max_spans=n)):
        out["profiler+spans"] = loop()
    prof.stop()
    return out


# ------------------------------------------------------------------ read --
def read(traces, key: str, part: str | None = None):
    """Mean over ranks of the span block's ``key`` (``part`` of it where it
    is a dict), or None where no rank has it (a program without spans)."""
    vals = []
    for t in traces:
        v = (t.get("spans") or {}).get(key)
        if isinstance(v, dict):
            v = v.get(part)
        if v is not None:
            vals.append(v)
    return statistics.fmean(vals) if vals else None


# ------------------------------------------------------------------- main --
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="a one-card cell's traced window, then the "
                                 "span block; one JSON line")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cost-rounds", type=int, default=3,
                    help="rounds of host_cost after the span block (0: none)")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = harness.load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                             args.workload, root)
    if cell.chips != 1:
        print(f"spans: {cell.name} asks for {cell.chips} cards; this runs one", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    result = run_cell(cell, args.seed, args.seconds, dev, args.cost_rounds)
    result["card"] = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, dev, cost_rounds: int = 0) -> dict:
    """The cell's program after its checked steps: the traced window
    (unchanged), then the span block, then ``cost_rounds`` rounds of
    ``host_cost``; the readers' values, the block's summary and what
    tracing costs."""
    tr = cell.traffic
    prog = harness.Program(cell, dev, 1, trace=True)
    feed = harness.Feed(cell, seed, 0, dev)
    state = prog.init_state(seed)
    first = tr["checked_steps"]
    last = 0.0
    for i in range(first):
        harness._sync(dev)
        t0 = time.perf_counter()
        state, _ = prog(state, feed, i)
        harness._sync(dev)
        last = time.perf_counter() - t0
    n = max(2, int(seconds / max(last, 1e-6)) + 1)
    k = min(tr["trace_steps"], n)
    state, _, summary, _ = trace.traced_window(prog, state, feed, first, n, k, 1)
    summary["flops_per_step"] = harness.flops_per_token(cell) * cell.rows * tr["seq"]
    state, summary["spans"] = span_block(prog, state, feed, first + n + k + 1, k, 1)
    state, cost = host_cost(prog, state, feed, first + n + 2 * k + 1, k, cost_rounds)
    readers = {m["name"]: harness.load_module("metrics", m["name"]).read([summary])
               for m in cell.per_layer if m["name"] != "peak_mem_gib"}
    sp = summary["spans"]
    window_step = 1e3 * summary["loop_s"] / len(summary["step_ms"])
    device_only_step = 1e3 * summary["window_s"] / summary["steps"]
    return {"cell": cell.name, "seed": seed, "window_steps": n, "traced_steps": k,
            "readers": readers, "spans": sp,
            "idle_forward_ms": read([summary], "idle_ms_per_step_by_part", "forward"),
            "idle_backward_ms": read([summary], "idle_ms_per_step_by_part", "backward"),
            "idle_other_ms": read([summary], "idle_ms_per_step_by_part", "other"),
            "backward_formulas_ms": read([summary], "backward_formulas_ms"),
            "host_ms_per_step": {"window_untraced": window_step,
                                 "device_only_block": device_only_step,
                                 "span_block": sp["host_ms_per_step"]},
            "host_ms_per_step_by_mode": cost, "span_us": span_us(dev),
            "busy_ms_per_step": 1e3 * summary["busy_s"] / summary["steps"]}


if __name__ == "__main__":
    sys.exit(main())
