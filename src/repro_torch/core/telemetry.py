"""Telemetry: structured event tracing, counters/timers, and exporters.

Zero-overhead-when-off instrumentation for the scheduler simulator.  Three
parts:

1. **Structured event trace** — typed records for job lifecycle (submit,
   admit/delay/reject, alloc-change, freeze/unfreeze, migrate, complete) and
   per-solve decision records, emitted through a pluggable sink.  Sinks:
   in-memory list (:class:`MemorySink`), bounded ring (:class:`RingSink`),
   streaming JSONL (:class:`JSONLSink`, O(1) memory for 100k+-job traces),
   and a streaming Chrome trace-event writer (:class:`ChromeTraceSink`).

2. **Counter/timer registry** — :class:`Registry` hands out
   :class:`Counter`/:class:`Timer` objects resolved once at engine setup.
   The disabled path is a module-level no-op singleton
   (:data:`NULL_RECORDER`), so hot loops pay a single attribute check
   (``rec.on``) when telemetry is off.

3. **Exporters** — Chrome trace-event JSON (one track per node / GPU slot,
   loadable in Perfetto via https://ui.perfetto.dev) and a metrics rollup
   (time-weighted utilization, queue-depth stats, JCT histogram, per-policy
   counter table).

Usage::

    from repro_torch.core import telemetry as tele
    t = tele.Telemetry(sink=tele.MemorySink())
    res = simulate(jobs, capacity, policy, telemetry=t)
    res.telemetry.utilization        # time-weighted busy-GPU fraction
    res.telemetry.counters           # {"solve.calls": ..., "heap.pops": ...}
    res.telemetry.events             # list of event dicts (MemorySink only)

Events are plain dicts with a ``kind`` key; :data:`EVENT_SCHEMAS` defines the
required fields per kind and :func:`validate_event` checks them.  All numeric
payloads are coerced to plain ``int``/``float`` at emission time so every
sink can ``json.dumps`` without numpy-scalar surprises.
"""

from __future__ import annotations

import heapq
import json
import math
from collections import deque
from dataclasses import dataclass, field
from typing import IO, Any

# ---------------------------------------------------------------------------
# Event schemas
# ---------------------------------------------------------------------------

#: Required fields per event kind -> {field_name: type}.  ``float`` accepts
#: ints too (JSON has one number type); extra fields are always allowed.
EVENT_SCHEMAS: dict[str, dict[str, type]] = {
    # One per simulation, first event.
    "run": {
        "t": float,
        "policy": str,
        "capacity": int,
        "n_jobs": int,
        "gpus_per_node": int,
    },
    # Job lifecycle.
    "submit": {"t": float, "job": int, "arrival": float},
    "admit": {"t": float, "job": int},
    "delay": {"t": float, "job": int},
    "reject": {"t": float, "job": int},
    "alloc": {"t": float, "job": int, "old_w": int, "w": int},
    "freeze": {"t": float, "job": int, "until": float},
    "unfreeze": {"t": float, "job": int},
    "migrate": {"t": float, "job": int, "node": int},
    "complete": {"t": float, "job": int, "jct": float},
    # Fault injection (PR 10): a node incident, a gang killed by one
    # (with its checkpoint-age-dependent lost work), and a killed gang
    # re-entering the queue.
    "fault": {"t": float, "node": int, "fault": str},
    "evict": {"t": float, "job": int, "node": int, "lost": float,
              "lost_frac": float},
    "recover": {"t": float, "job": int},
    # Per-solve decision record.
    "solve": {"t": float, "policy": str, "changed": int, "reuse": bool, "n_live": int},
    # One per simulation, last event.
    "end": {"t": float, "n_done": int},
}


def validate_event(ev: dict) -> None:
    """Raise ``ValueError`` if *ev* is not a well-formed telemetry event."""
    kind = ev.get("kind")
    schema = EVENT_SCHEMAS.get(kind)  # type: ignore[arg-type]
    if schema is None:
        raise ValueError(f"unknown event kind: {kind!r}")
    for name, typ in schema.items():
        if name not in ev:
            raise ValueError(f"{kind} event missing field {name!r}: {ev}")
        val = ev[name]
        if typ is float:
            ok = isinstance(val, (int, float)) and not isinstance(val, bool)
        elif typ is int:
            ok = isinstance(val, int) and not isinstance(val, bool)
        elif typ is bool:
            ok = isinstance(val, bool)
        else:
            ok = isinstance(val, typ)
        if not ok:
            raise ValueError(
                f"{kind} event field {name!r} has type {type(val).__name__}, "
                f"expected {typ.__name__}: {ev}"
            )


# ---------------------------------------------------------------------------
# Counters and timers
# ---------------------------------------------------------------------------


class Counter:
    """A named monotonically-increasing integer."""

    __slots__ = ("name", "n")

    def __init__(self, name: str) -> None:
        self.name = name
        self.n = 0

    def inc(self, k: int = 1) -> None:
        self.n += k

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.n})"


class Timer:
    """Accumulates wall-clock seconds across labelled spans."""

    __slots__ = ("name", "total_s", "count")

    def __init__(self, name: str) -> None:
        self.name = name
        self.total_s = 0.0
        self.count = 0

    def add(self, seconds: float) -> None:
        self.total_s += seconds
        self.count += 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Timer({self.name}={self.total_s:.6f}s/{self.count})"


class _NullCounter:
    """No-op counter; shared singleton for the disabled path."""

    __slots__ = ()
    name = "null"
    n = 0

    def inc(self, k: int = 1) -> None:
        pass


class _NullTimer:
    __slots__ = ()
    name = "null"
    total_s = 0.0
    count = 0

    def add(self, seconds: float) -> None:
        pass


NULL_COUNTER = _NullCounter()
NULL_TIMER = _NullTimer()


class Registry:
    """Hands out memoized :class:`Counter`/:class:`Timer` handles by name.

    Resolve handles once at setup (``c = reg.counter("heap.pops")``) and call
    ``c.inc()`` in the hot loop — no dict lookup per increment.
    """

    __slots__ = ("_counters", "_timers")

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._timers: dict[str, Timer] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            t = self._timers[name] = Timer(name)
        return t

    def counters(self) -> dict[str, int]:
        return {k: v.n for k, v in sorted(self._counters.items())}

    def timers(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v.total_s, "count": v.count}
            for k, v in sorted(self._timers.items())
        }


class _NullRegistry:
    __slots__ = ()

    def counter(self, name: str) -> _NullCounter:
        return NULL_COUNTER

    def timer(self, name: str) -> _NullTimer:
        return NULL_TIMER

    def counters(self) -> dict[str, int]:
        return {}

    def timers(self) -> dict[str, dict[str, float]]:
        return {}


NULL_REGISTRY = _NullRegistry()


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


class MemorySink:
    """Keeps every event in a plain list (``sink.events``)."""

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: list[dict] = []

    def emit(self, ev: dict) -> None:
        self.events.append(ev)

    def close(self) -> None:
        pass


class RingSink:
    """Bounded in-memory sink: keeps only the most recent *maxlen* events."""

    __slots__ = ("_ring",)

    def __init__(self, maxlen: int = 65536) -> None:
        self._ring: deque[dict] = deque(maxlen=maxlen)

    @property
    def events(self) -> list[dict]:
        return list(self._ring)

    def emit(self, ev: dict) -> None:
        self._ring.append(ev)

    def close(self) -> None:
        pass


class JSONLSink:
    """Streams one JSON object per line to *path*; O(1) memory.

    The sink of choice for 100k+-job traces: nothing is buffered beyond the
    underlying file object's write buffer.
    """

    __slots__ = ("path", "_fh")

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh: IO[str] | None = open(path, "w")

    def emit(self, ev: dict) -> None:
        fh = self._fh
        if fh is not None:
            fh.write(json.dumps(ev, separators=(",", ":")))
            fh.write("\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> list[dict]:
    """Load a JSONL event file back into a list of event dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class TeeSink:
    """Fans every event out to multiple sinks."""

    __slots__ = ("sinks",)

    def __init__(self, sinks: list) -> None:
        self.sinks = list(sinks)

    def emit(self, ev: dict) -> None:
        for s in self.sinks:
            s.emit(ev)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class ChromeTraceSink:
    """Streams events straight to Chrome trace-event JSON (Perfetto-loadable).

    Tracks are ``pid`` = node index, ``tid`` = GPU slot within the node.  A
    job holding ``w`` GPUs occupies the ``w`` lowest free slots; every alloc
    change closes the job's open occupancy intervals (``"X"`` complete
    events, ``ts``/``dur`` in microseconds of *simulated* time) and reopens
    them at the new width.  Freeze/unfreeze/migrate show up as instant
    events (``"i"``) on the job's first slot, and a ``busy_gpus`` counter
    track (``"C"``) gives the utilization curve.

    Memory is O(capacity + active jobs), independent of trace length — the
    JSON array is written incrementally and terminated in :meth:`close`.
    """

    __slots__ = ("path", "_fh", "_first", "_free", "_held", "_gpn", "_capacity")

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh: IO[str] | None = open(path, "w")
        self._fh.write('{"displayTimeUnit":"ms","traceEvents":[')
        self._first = True
        self._free: list[int] = []  # min-heap of free GPU slot indices
        self._held: dict[int, list[tuple[int, float]]] = {}  # job -> [(slot, since_t)]
        self._gpn = 1
        self._capacity = 0

    # -- low-level --------------------------------------------------------

    def _write(self, obj: dict) -> None:
        fh = self._fh
        if fh is None:
            return
        if self._first:
            self._first = False
        else:
            fh.write(",")
        fh.write(json.dumps(obj, separators=(",", ":")))

    def _pid_tid(self, slot: int) -> tuple[int, int]:
        return slot // self._gpn, slot % self._gpn

    def _instant(self, t: float, job: int, name: str) -> None:
        spans = self._held.get(job)
        slot = spans[0][0] if spans else 0
        pid, tid = self._pid_tid(slot)
        self._write(
            {"ph": "i", "name": name, "ts": t * 1e6, "pid": pid, "tid": tid, "s": "t",
             "args": {"job": job}}
        )

    def _busy(self, t: float) -> None:
        used = self._capacity - len(self._free)
        self._write(
            {"ph": "C", "name": "busy_gpus", "ts": t * 1e6, "pid": 0, "tid": 0,
             "args": {"busy": used}}
        )

    # -- sink interface ---------------------------------------------------

    def emit(self, ev: dict) -> None:
        if self._fh is None:
            return
        kind = ev["kind"]
        t = ev["t"]
        if kind == "run":
            self._capacity = ev["capacity"]
            self._gpn = max(1, ev.get("gpus_per_node") or 1)
            self._free = list(range(self._capacity))
            heapq.heapify(self._free)
            n_nodes = (self._capacity + self._gpn - 1) // self._gpn
            for node in range(n_nodes):
                self._write(
                    {"ph": "M", "name": "process_name", "ts": 0, "pid": node,
                     "tid": 0, "args": {"name": f"node{node}"}}
                )
                for g in range(self._gpn):
                    if node * self._gpn + g >= self._capacity:
                        break
                    self._write(
                        {"ph": "M", "name": "thread_name", "ts": 0, "pid": node,
                         "tid": g, "args": {"name": f"gpu{g}"}}
                    )
            self._busy(t)
        elif kind == "alloc":
            job = ev["job"]
            w = ev["w"]
            spans = self._held.pop(job, [])
            for slot, since in spans:
                pid, tid = self._pid_tid(slot)
                dur = max(0.0, t - since)
                self._write(
                    {"ph": "X", "name": f"job{job}", "cat": "gang",
                     "ts": since * 1e6, "dur": dur * 1e6, "pid": pid, "tid": tid,
                     "args": {"job": job, "w": ev["old_w"]}}
                )
                heapq.heappush(self._free, slot)
            if w > 0:
                new_spans = []
                for _ in range(min(w, len(self._free))):
                    slot = heapq.heappop(self._free)
                    new_spans.append((slot, t))
                self._held[job] = new_spans
            self._busy(t)
        elif kind == "complete":
            # alloc->0 precedes complete in the engines; this is a fallback.
            job = ev["job"]
            spans = self._held.pop(job, [])
            for slot, since in spans:
                pid, tid = self._pid_tid(slot)
                self._write(
                    {"ph": "X", "name": f"job{job}", "cat": "gang",
                     "ts": since * 1e6, "dur": (t - since) * 1e6,
                     "pid": pid, "tid": tid, "args": {"job": job}}
                )
                heapq.heappush(self._free, slot)
            if spans:
                self._busy(t)
        elif kind == "evict":
            # a node failure killed the gang: close its occupancy spans
            # (same geometry as complete) and free the slots
            job = ev["job"]
            spans = self._held.pop(job, [])
            for slot, since in spans:
                pid, tid = self._pid_tid(slot)
                self._write(
                    {"ph": "X", "name": f"job{job}", "cat": "gang",
                     "ts": since * 1e6, "dur": (t - since) * 1e6,
                     "pid": pid, "tid": tid, "args": {"job": job}}
                )
                heapq.heappush(self._free, slot)
            if spans:
                self._busy(t)
        elif kind == "fault":
            self._write(
                {"ph": "i", "name": ev["fault"], "ts": t * 1e6,
                 "pid": ev["node"], "tid": 0, "s": "p",
                 "args": {"node": ev["node"]}}
            )
        elif kind in ("freeze", "unfreeze", "migrate", "recover"):
            self._instant(t, ev["job"], kind)
        elif kind == "end":
            for job, spans in list(self._held.items()):
                for slot, since in spans:
                    pid, tid = self._pid_tid(slot)
                    self._write(
                        {"ph": "X", "name": f"job{job}", "cat": "gang",
                         "ts": since * 1e6, "dur": (t - since) * 1e6,
                         "pid": pid, "tid": tid, "args": {"job": job}}
                    )
            self._held.clear()
            self._busy(t)
        # submit/admit/delay/reject/solve carry no timeline geometry.

    def close(self) -> None:
        if self._fh is not None:
            self._fh.write("]}")
            self._fh.close()
            self._fh = None


def write_chrome_trace(path: str, events: list[dict]) -> None:
    """Convert a recorded event list to a Chrome trace-event file offline."""
    sink = ChromeTraceSink(path)
    try:
        for ev in events:
            sink.emit(ev)
    finally:
        sink.close()


# ---------------------------------------------------------------------------
# Rollup result
# ---------------------------------------------------------------------------


@dataclass
class TelemetryResult:
    """End-of-run metrics rollup attached to ``SimResult.telemetry``."""

    policy: str
    capacity: int
    n_jobs: int
    makespan: float
    utilization: float | None  # time-weighted mean busy-GPU fraction
    busy_gpu_seconds: float
    queue_peak: int
    queue_mean: float  # time-weighted mean waiting-job count
    n_completed: int
    n_rejected: int
    n_migrations: int
    avg_jct_s: float | None
    # fault injection (PR 10): incidents seen, gangs killed, gpu-seconds
    # wasted on rolled-back progress / restart freezes, and goodput =
    # useful progress-seconds / busy gpu-seconds
    n_faults: int = 0
    n_evictions: int = 0
    lost_gpu_seconds: float = 0.0
    frozen_gpu_seconds: float = 0.0
    goodput: float | None = None
    jct_histogram: dict[str, int] = field(default_factory=dict)  # log2 bins
    counters: dict[str, int] = field(default_factory=dict)
    timers: dict[str, dict[str, float]] = field(default_factory=dict)
    sink: Any = None

    @property
    def events(self) -> list[dict] | None:
        """Recorded events, if the sink keeps them in memory."""
        return getattr(self.sink, "events", None)

    def rollup(self) -> dict:
        """Plain-dict summary (JSON-serializable) for reports/CI artifacts."""
        return {
            "policy": self.policy,
            "capacity": self.capacity,
            "n_jobs": self.n_jobs,
            "makespan": self.makespan,
            "utilization": self.utilization,
            "busy_gpu_seconds": self.busy_gpu_seconds,
            "queue_peak": self.queue_peak,
            "queue_mean": self.queue_mean,
            "n_completed": self.n_completed,
            "n_rejected": self.n_rejected,
            "n_migrations": self.n_migrations,
            "avg_jct_s": self.avg_jct_s,
            "n_faults": self.n_faults,
            "n_evictions": self.n_evictions,
            "lost_gpu_seconds": self.lost_gpu_seconds,
            "frozen_gpu_seconds": self.frozen_gpu_seconds,
            "goodput": self.goodput,
            "jct_histogram": dict(self.jct_histogram),
            "counters": dict(self.counters),
            "timers": dict(self.timers),
        }


def _jct_bin(jct: float) -> str:
    """Log2 histogram bin label for a JCT in seconds: the largest power
    of two <= jct (``frexp`` gives the exponent in O(1))."""
    if jct < 1.0:
        return "<1s"
    return f"{1 << (math.frexp(jct)[1] - 1)}s"


# ---------------------------------------------------------------------------
# Recorder (per-run)
# ---------------------------------------------------------------------------


class Recorder:
    """Per-simulation event recorder + summary accumulator.

    Created by :meth:`Telemetry.recorder` at engine setup.  Engines call the
    ``submit``/``admit``/``alloc``/... methods at the corresponding decision
    points; the recorder maintains time-weighted integrals (busy GPUs,
    queue depth) and streams each event to the sink.

    Bit-consistency note: the busy/queue integrals advance only when
    ``dt > 0``, and the busy count is an integer, so the order of
    same-timestamp events (which differs between the table and reference
    engines) cannot change the float accumulation — both engines produce
    bitwise-equal utilization.
    """

    on = True

    __slots__ = (
        "_sink", "registry", "policy", "capacity", "n_jobs",
        "c_solves", "c_reused", "c_delta", "t_solve",
        "_t", "_busy", "_waiting", "_busy_int", "_wait_int", "_peak_wait",
        "_w", "_sub", "_pend", "_pend_due", "_jct_hist", "_jct_sum",
        "_n_done", "_n_rejected", "_migs", "_closed",
        "_gpu_int", "_gpu_t", "_frz", "_frz_s", "_lost",
        "_n_evict", "_n_faults",
    )

    def __init__(
        self,
        sink,
        registry: Registry,
        policy: str,
        capacity: int,
        n_jobs: int,
        gpus_per_node: int = 0,
        t0: float = 0.0,
    ) -> None:
        self._sink = sink
        self.registry = registry
        self.policy = policy
        self.capacity = int(capacity)
        self.n_jobs = int(n_jobs)
        self.c_solves = registry.counter("solve.calls")
        self.c_reused = registry.counter("solve.reused")
        self.c_delta = registry.counter("solve.changed_rows")
        self.t_solve = registry.timer("solve.wall_s")
        self._t = float(t0)
        self._busy = 0
        self._waiting: set[int] = set()
        self._busy_int = 0.0
        self._wait_int = 0.0
        self._peak_wait = 0
        self._w: dict[int, int] = {}
        self._sub: dict[int, float] = {}
        self._pend: dict[int, float] = {}  # job -> frozen-until (unfreeze due)
        self._pend_due = math.inf          # earliest pending unfreeze (cached)
        self._jct_hist: dict[str, int] = {}
        self._jct_sum = 0.0
        self._n_done = 0
        self._n_rejected = 0
        self._migs = 0
        self._closed = False
        # goodput accounting (PR 10).  Per-job so same-timestamp event
        # ordering differences between the engines cannot reorder the
        # float sums: each job's events are chronological in both
        # engines, and finish() folds the per-job values in sorted-key
        # order — bitwise-equal totals on both engines.
        self._gpu_int: dict[int, float] = {}  # job -> gpu-seconds so far
        self._gpu_t: dict[int, float] = {}    # job -> last integral flush
        self._frz: dict[int, tuple[float, int]] = {}  # job -> (until, w)
        self._frz_s: dict[int, float] = {}    # job -> frozen gpu-seconds
        self._lost: dict[int, float] = {}     # job -> wasted gpu-seconds
        self._n_evict = 0
        self._n_faults = 0
        if sink is not None:
            sink.emit(
                {
                    "kind": "run",
                    "t": float(t0),
                    "policy": policy,
                    "capacity": int(capacity),
                    "n_jobs": int(n_jobs),
                    "gpus_per_node": int(gpus_per_node),
                }
            )

    # -- internals --------------------------------------------------------

    def _tick(self, t: float) -> None:
        dt = t - self._t
        if dt > 0.0:
            self._busy_int += self._busy * dt
            self._wait_int += len(self._waiting) * dt
            self._t = t

    def _enqueue(self, job: int) -> None:
        self._waiting.add(job)
        if len(self._waiting) > self._peak_wait:
            self._peak_wait = len(self._waiting)

    def _emit(self, ev: dict) -> None:
        sink = self._sink
        if sink is not None:
            if self._pend_due <= ev["t"]:
                self._flush_pend(ev["t"])
            sink.emit(ev)

    def _flush_pend(self, t: float) -> None:
        """Emit unfreeze events whose due time has passed, in (until, job)
        order, and refresh the cached earliest-due bound (the bound may
        sit below the true minimum after a re-freeze overwrote an entry —
        that only costs a spurious scan here, never a missed flush)."""
        due = [(u, j) for j, u in self._pend.items() if u <= t]
        if due:
            due.sort()
            sink = self._sink
            for u, j in due:
                del self._pend[j]
                sink.emit({"kind": "unfreeze", "t": float(u), "job": j})
        self._pend_due = min(self._pend.values()) if self._pend else math.inf

    # -- lifecycle events -------------------------------------------------

    def submit(self, t: float, job: int, arrival: float) -> None:
        self._sub[job] = arrival
        if self._sink is not None:
            self._emit({"kind": "submit", "t": t, "job": job,
                        "arrival": arrival})

    def admit(self, t: float, job: int) -> None:
        self._tick(t)
        self._enqueue(job)
        if self._sink is not None:
            self._emit({"kind": "admit", "t": t, "job": job})

    def delay(self, t: float, job: int) -> None:
        self._tick(t)
        self._enqueue(job)
        if self._sink is not None:
            self._emit({"kind": "delay", "t": t, "job": job})

    def reject(self, t: float, job: int) -> None:
        self._tick(t)
        self._waiting.discard(job)
        self._n_rejected += 1
        if self._sink is not None:
            self._emit({"kind": "reject", "t": t, "job": job})

    def alloc(self, t: float, job: int, old_w: int, w: int) -> None:
        self._tick(t)
        self._busy += w - old_w
        if w > 0:
            self._waiting.discard(job)
        else:
            self._enqueue(job)
            if self._pend.pop(job, None) is not None and self._pend:
                self._pend_due = min(self._pend.values())
        # per-job gpu-seconds integral (goodput): close the old-width span
        if old_w > 0:
            self._gpu_int[job] = (self._gpu_int.get(job, 0.0)
                                  + (t - self._gpu_t.get(job, t)) * old_w)
        self._gpu_t[job] = t
        self._w[job] = w
        if self._sink is not None:
            self._emit({"kind": "alloc", "t": t, "job": job, "old_w": old_w,
                        "w": w})

    def freeze(self, t: float, job: int, until: float) -> None:
        # frozen gpu-seconds (goodput) — unconditional, unlike the
        # sink-gated unfreeze bookkeeping below: the span is the union
        # with any still-pending freeze, weighted by the job's current
        # width
        prev = self._frz.get(job)
        add = (until - t) - (max(0.0, prev[0] - t) if prev else 0.0)
        w = self._w.get(job, 0)
        if add > 0.0 and w > 0:
            self._frz_s[job] = self._frz_s.get(job, 0.0) + add * w
        self._frz[job] = (until, w)
        sink = self._sink
        if sink is not None:
            if self._pend_due <= t:
                self._flush_pend(t)
            sink.emit({"kind": "freeze", "t": t, "job": job, "until": until})
            self._pend[job] = until
            if until < self._pend_due:
                self._pend_due = until

    def migrate(self, t: float, job: int, node: int) -> None:
        self._migs += 1
        self._emit(
            {"kind": "migrate", "t": float(t), "job": int(job), "node": int(node)}
        )

    def complete(self, t: float, job: int) -> None:
        self._tick(t)
        w = self._w.pop(job, 0)
        self._busy -= w
        self._waiting.discard(job)
        self._pend.pop(job, None)
        # done for good: the per-job goodput scratch is no longer needed
        # (_lost/_frz_s persist — finish() sums them)
        self._gpu_int.pop(job, None)
        self._gpu_t.pop(job, None)
        self._frz.pop(job, None)
        arrival = self._sub.pop(job, None)
        jct = t - arrival if arrival is not None else 0.0
        self._jct_sum += jct
        b = _jct_bin(jct)
        self._jct_hist[b] = self._jct_hist.get(b, 0) + 1
        self._n_done += 1
        if self._sink is not None:
            self._emit({"kind": "complete", "t": t, "job": job, "jct": jct})

    # -- fault injection (PR 10) ------------------------------------------

    def fault(self, t: float, node: int, fault: str) -> None:
        """A node incident fired (fail/drain/recover/degrade)."""
        self._n_faults += 1
        self._emit({"kind": "fault", "t": float(t), "node": int(node),
                    "fault": fault})

    def evict(self, t: float, job: int, node: int, lost: float,
              lost_frac: float) -> None:
        """A node failure killed ``job``'s gang: release its GPUs, flush
        its gpu-seconds integral, and charge the wasted share (the
        fraction of its progress that rolled back to the last
        checkpoint)."""
        self._tick(t)
        w = self._w.pop(job, 0)
        self._busy -= w
        self._waiting.discard(job)
        if self._pend.pop(job, None) is not None and self._pend:
            self._pend_due = min(self._pend.values())
        if w > 0:
            self._gpu_int[job] = (self._gpu_int.get(job, 0.0)
                                  + (t - self._gpu_t.get(job, t)) * w)
        self._gpu_t.pop(job, None)
        if lost_frac > 0.0:
            self._lost[job] = (self._lost.get(job, 0.0)
                               + self._gpu_int.get(job, 0.0) * lost_frac)
        frz = self._frz.pop(job, None)
        if frz is not None and frz[0] > t:
            # the freeze was cut short by the kill — claw back the tail
            self._frz_s[job] = (self._frz_s.get(job, 0.0)
                                - (frz[0] - t) * frz[1])
        self._n_evict += 1
        self._emit({"kind": "evict", "t": float(t), "job": int(job),
                    "node": int(node), "lost": float(lost),
                    "lost_frac": float(lost_frac)})

    def recover(self, t: float, job: int) -> None:
        """An evicted job re-entered the queue through admission."""
        self._tick(t)
        self._enqueue(job)
        self._emit({"kind": "recover", "t": float(t), "job": int(job)})

    # -- decision records -------------------------------------------------

    def solve_reused(self) -> None:
        # counter-only fast path for reused/empty solves (~80% of solves
        # on steady traces): no event is emitted — a reused solve's whole
        # decision content (delta 0, reuse True) is already captured by
        # the solve.calls/solve.reused counters, and skipping the record
        # keeps the enabled path inside the bench overhead ceiling
        self.c_solves.n += 1
        self.c_reused.n += 1

    def solve(self, t: float, changed: int, reuse: bool, n_live: int) -> None:
        # the hottest recorder method (one call per reallocation event):
        # direct counter bumps, no coercions — engines pass plain scalars
        self.c_solves.n += 1
        if reuse:
            self.c_reused.n += 1
        self.c_delta.n += changed
        sink = self._sink
        if sink is not None:
            if self._pend_due <= t:
                self._flush_pend(t)
            sink.emit({"kind": "solve", "t": t, "policy": self.policy,
                       "changed": changed, "reuse": reuse,
                       "n_live": n_live})

    # -- finalization -----------------------------------------------------

    def finish(self, t: float) -> TelemetryResult:
        """Close out the run: flush, emit ``end``, close the sink, roll up."""
        t = float(t)
        self._tick(t)
        if self._sink is not None:
            self._flush_pend(float("inf"))
            self._sink.emit({"kind": "end", "t": t, "n_done": self._n_done})
            if not self._closed:
                self._sink.close()
                self._closed = True
        denom = self.capacity * t
        util = (self._busy_int / denom) if denom > 0 else None
        # goodput: fold per-job values in sorted-key order so both
        # engines sum bitwise-identically
        lost = sum(self._lost[j] for j in sorted(self._lost))
        frozen = sum(self._frz_s[j] for j in sorted(self._frz_s))
        goodput = (max(0.0, (self._busy_int - lost - frozen)
                       / self._busy_int)
                   if self._busy_int > 0 else None)
        return TelemetryResult(
            policy=self.policy,
            capacity=self.capacity,
            n_jobs=self.n_jobs,
            makespan=t,
            utilization=util,
            busy_gpu_seconds=self._busy_int,
            queue_peak=self._peak_wait,
            queue_mean=(self._wait_int / t) if t > 0 else 0.0,
            n_completed=self._n_done,
            n_rejected=self._n_rejected,
            n_migrations=self._migs,
            avg_jct_s=(self._jct_sum / self._n_done) if self._n_done else None,
            n_faults=self._n_faults,
            n_evictions=self._n_evict,
            lost_gpu_seconds=lost,
            frozen_gpu_seconds=frozen,
            goodput=goodput,
            jct_histogram=dict(sorted(self._jct_hist.items())),
            counters=self.registry.counters(),
            timers=self.registry.timers(),
            sink=self._sink,
        )


class _NullRecorder:
    """Disabled-path recorder: every method is a no-op.

    Hot loops check ``rec.on`` once per block; policy internals see
    ``registry is None`` (via ``ctx.tel``) and skip counting entirely.
    """

    on = False
    registry = None
    __slots__ = ()

    def submit(self, t, job, arrival):
        pass

    def admit(self, t, job):
        pass

    def delay(self, t, job):
        pass

    def reject(self, t, job):
        pass

    def alloc(self, t, job, old_w, w):
        pass

    def freeze(self, t, job, until):
        pass

    def migrate(self, t, job, node):
        pass

    def complete(self, t, job):
        pass

    def fault(self, t, node, fault):
        pass

    def evict(self, t, job, node, lost, lost_frac):
        pass

    def recover(self, t, job):
        pass

    def solve(self, t, changed, reuse, n_live):
        pass

    def solve_reused(self):
        pass

    def finish(self, t):
        return None


NULL_RECORDER = _NullRecorder()


# ---------------------------------------------------------------------------
# Top-level handle
# ---------------------------------------------------------------------------


class Telemetry:
    """Enabled telemetry configuration passed to ``simulate(telemetry=...)``.

    ``sink=None`` collects counters and the metrics rollup without recording
    individual events (cheapest enabled mode).  Pass ``registry`` to share
    one counter registry across several runs; by default each run gets a
    fresh one.
    """

    enabled = True

    __slots__ = ("sink", "registry")

    def __init__(self, sink=None, registry: Registry | None = None) -> None:
        self.sink = sink
        self.registry = registry

    def recorder(
        self, policy: str, capacity: int, n_jobs: int, gpus_per_node: int = 0
    ) -> Recorder:
        reg = self.registry if self.registry is not None else Registry()
        return Recorder(
            self.sink, reg, str(policy), int(capacity), int(n_jobs),
            gpus_per_node=int(gpus_per_node),
        )


class _NullTelemetry:
    enabled = False
    sink = None
    registry = None
    __slots__ = ()

    def recorder(self, policy, capacity, n_jobs, gpus_per_node=0):
        return NULL_RECORDER


NULL = _NullTelemetry()


# ---------------------------------------------------------------------------
# Offline analysis helpers
# ---------------------------------------------------------------------------


def metrics_rollup(events: list[dict]) -> TelemetryResult:
    """Replay a recorded event stream into a fresh metrics rollup.

    Uses the exact same accumulation code as the live :class:`Recorder`, so
    an offline rollup of a JSONL trace matches the live ``SimResult.telemetry``
    float-for-float (counters are not in the event stream and come back
    empty; solve events still rebuild the ``solve.*`` counters).
    """
    rec: Recorder | None = None
    end_t = 0.0
    for ev in events:
        kind = ev["kind"]
        t = ev["t"]
        end_t = max(end_t, t)
        if kind == "run":
            rec = Recorder(
                None, Registry(), ev["policy"], ev["capacity"], ev["n_jobs"],
                gpus_per_node=ev.get("gpus_per_node", 0), t0=t,
            )
        elif rec is None:
            raise ValueError("event stream does not start with a 'run' event")
        elif kind == "submit":
            rec.submit(t, ev["job"], ev["arrival"])
        elif kind == "admit":
            rec.admit(t, ev["job"])
        elif kind == "delay":
            rec.delay(t, ev["job"])
        elif kind == "reject":
            rec.reject(t, ev["job"])
        elif kind == "alloc":
            rec.alloc(t, ev["job"], ev["old_w"], ev["w"])
        elif kind == "freeze":
            rec.freeze(t, ev["job"], ev["until"])
        elif kind == "migrate":
            rec.migrate(t, ev["job"], ev["node"])
        elif kind == "complete":
            rec.complete(t, ev["job"])
        elif kind == "fault":
            rec.fault(t, ev["node"], ev["fault"])
        elif kind == "evict":
            rec.evict(t, ev["job"], ev["node"], ev["lost"], ev["lost_frac"])
        elif kind == "recover":
            rec.recover(t, ev["job"])
        elif kind == "solve":
            rec.solve(t, ev["changed"], ev["reuse"], ev["n_live"])
        elif kind == "end":
            end_t = t
    if rec is None:
        raise ValueError("empty event stream")
    return rec.finish(end_t)


def format_counters(per_policy: dict[str, dict[str, int]]) -> str:
    """Render ``{policy: {counter: value}}`` as an aligned text table."""
    names: list[str] = []
    for ctrs in per_policy.values():
        for k in ctrs:
            if k not in names:
                names.append(k)
    names.sort()
    rows = [["policy", *names]]
    for pol, ctrs in per_policy.items():
        rows.append([pol, *[str(ctrs.get(k, 0)) for k in names]])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Step tracing (the port's train step)
# ---------------------------------------------------------------------------
#
# Spans and counters inside the port's train step, off unless a
# :class:`StepTracer` is installed with :func:`tracing`.  Off, ``span()``
# returns the shared :data:`NULL_SPAN` after one check of the module's
# tracer and ``count()`` returns at once: no clock is read, no profiler
# range is entered, and nothing synchronises the device.  On, each span
# is stamped on both ends with ``time.time_ns()``, the clock that
# ``torch.profiler``'s timeline is kept on (its trace starts at
# ``kineto_results.trace_start_ns()``), and opens a
# ``torch.profiler.record_function`` of its own name, so a profiler with
# CPU activity shows it on the host and, around the kernels launched in
# it, on the device.  Spans are kept in memory, up to ``max_spans``, and
# written only when asked (:meth:`StepTracer.snapshot`,
# :meth:`StepTracer.write_chrome_trace`).
#
#     tracer = tele.StepTracer()
#     with tele.tracing(tracer):
#         state, loss = step(state, batch, lr)
#     tracer.snapshot()   # {"spans": [...], "counters": {...}, "launches": {...}}

import itertools  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

#: the span that opens a step: its id is the ``step`` of every span inside it
STEP_SPAN = "train.step"


@dataclass(slots=True)
class Span:
    """One traced span: ``parent`` and ``step`` are span ids (None outside
    any), ``thread`` the opening thread's native id, times in ns of
    ``time.time_ns()`` (``end_ns`` 0 while open)."""

    name: str
    id: int
    parent: int | None
    step: int | None
    thread: int
    start_ns: int
    end_ns: int = 0


class _NullSpan:
    """No-op span context; shared singleton for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _OpenSpan:
    __slots__ = ("_tracer", "_name", "_span", "_range")

    def __init__(self, tracer: StepTracer, name: str) -> None:
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> Span:
        self._range = self._tracer._record_function(self._name)
        self._range.__enter__()
        self._span = self._tracer._open(self._name)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tracer._close(self._span)
        self._range.__exit__(*exc)
        return False


class StepTracer:
    """Spans (a bounded in-memory list) and counters (a :class:`Registry`)
    of the code run under :func:`tracing`.

    A span opened on a thread with no span of its own open (autograd's
    device thread, which runs the backward of CUDA tensors) takes as parent
    the innermost open span of the thread that installed the tracer. Each
    snapshot holds the kernels' launches (``kernels.ops.launch_counts``)
    since the tracer was installed or last flushed.
    """

    def __init__(self, max_spans: int = 1_000_000) -> None:
        from torch.profiler import record_function

        from repro_torch.kernels.ops import launch_counts

        self._record_function = record_function
        self._launch_counts = launch_counts
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self.registry = Registry()
        self.owner: int | None = None
        self._ids = itertools.count()
        self._stacks: dict[int, list[Span]] = {}
        # each thread's native id and open spans, read without a system
        # call (get_native_id is one) on every span
        self._local = threading.local()
        self._launch_base: dict[str, int] = {}

    def span(self, name: str) -> _OpenSpan:
        return _OpenSpan(self, name)

    def count(self, name: str, k: int = 1) -> None:
        self.registry.counter(name).inc(k)

    def _open(self, name: str) -> Span:
        local = self._local
        if not hasattr(local, "stack"):
            local.thread, local.stack = threading.get_native_id(), []
            self._stacks[local.thread] = local.stack
        thread, stack = local.thread, local.stack
        if stack:
            parent = stack[-1]
        else:
            home = self._stacks.get(self.owner) if thread != self.owner else None
            parent = home[-1] if home else None
        sid = next(self._ids)
        step = sid if name == STEP_SPAN else (parent.step if parent else None)
        s = Span(name, sid, parent.id if parent else None, step, thread,
                 time.time_ns())
        stack.append(s)
        if len(self.spans) < self.max_spans:
            self.spans.append(s)
        else:
            self.dropped += 1
        return s

    def _close(self, s: Span) -> None:
        s.end_ns = time.time_ns()
        self._stacks[s.thread].pop()

    def install(self) -> None:
        """Make the calling thread the tracer's home and start counting
        launches from here."""
        self.owner = threading.get_native_id()
        self._launch_base = dict(self._launch_counts())

    def snapshot(self) -> dict:
        """The spans closed so far, the counters and the kernel launches
        since the tracer was installed or last flushed, as plain data."""
        now = self._launch_counts()
        return {"owner": self.owner, "dropped": self.dropped,
                "spans": [dict(name=s.name, id=s.id, parent=s.parent, step=s.step,
                               thread=s.thread, start_ns=s.start_ns, end_ns=s.end_ns)
                          for s in self.spans if s.end_ns],
                "counters": self.registry.counters(),
                "launches": {k: n - self._launch_base.get(k, 0) for k, n in now.items()}}

    def flush(self) -> dict:
        """:meth:`snapshot`, then start afresh: closed spans dropped,
        counters zeroed, launches counted from here."""
        snap = self.snapshot()
        self.spans = [s for s in self.spans if not s.end_ns]
        self.dropped = 0
        self.registry = Registry()
        self._launch_base = dict(self._launch_counts())
        return snap

    def chrome_events(self, base_ns: int = 0) -> list[dict]:
        """The closed spans as Chrome trace-event complete events ("X") of
        the process "spans", one track a thread, ``ts`` in µs after
        ``base_ns`` (a trace's ``baseTimeNanoseconds``)."""
        return [{"ph": "X", "name": s.name, "cat": "span", "pid": "spans", "tid": s.thread,
                 "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                 "args": {"id": s.id, "parent": s.parent, "step": s.step}}
                for s in self.spans if s.end_ns]

    def write_chrome_trace(self, path: str) -> None:
        """The spans as a Chrome trace-event file (Perfetto-loadable), with
        the counters and launches under ``otherData``."""
        snap = self.snapshot()
        with open(path, "w") as fh:
            json.dump({"displayTimeUnit": "ms", "traceEvents": self.chrome_events(),
                       "otherData": {k: snap[k] for k in
                                     ("counters", "launches", "dropped")}}, fh)


_TRACER: StepTracer | None = None


def span(name: str):
    """A context manager around one span of the installed tracer; with
    none installed, the shared :data:`NULL_SPAN`."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.span(name)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the installed tracer's counter ``name``; nothing when
    none is installed."""
    if _TRACER is not None:
        _TRACER.count(name, k)


class tracing:
    """``with tracing(tracer):`` installs ``tracer`` for the code inside,
    with the calling thread as its home, and restores the tracer that was
    installed before (None: tracing off)."""

    __slots__ = ("_tracer", "_outer")

    def __init__(self, tracer: StepTracer) -> None:
        self._tracer = tracer

    def __enter__(self) -> StepTracer:
        global _TRACER
        self._outer = _TRACER
        self._tracer.install()
        _TRACER = self._tracer
        return self._tracer

    def __exit__(self, *exc) -> bool:
        global _TRACER
        _TRACER = self._outer
        return False
