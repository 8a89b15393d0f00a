"""Cluster scheduler simulation — paper §7.

Event-driven simulation of a C-GPU cluster with Poisson job arrivals.
Strategies are :class:`repro_torch.core.scheduler.SchedulingPolicy` instances
resolved through the policy registry (``scheduler.get_policy``): the
paper's Table-3 set (``precompute``, ``exploratory``, ``fixed_k``) plus
any registered extension (``srtf``, ``utility_greedy``, ...).
Reallocation happens at arrivals, completions and periodic intervals;
every allocation change costs the measured checkpoint-stop-restart pause
(``cluster.restart_cost``, ~10 s, §6).

The cluster itself is a :class:`repro_torch.collectives.cost.ClusterModel`:
capacity, hardware coefficients, an optional node topology (jobs whose
ring spans nodes run on cluster-scaled speed tables) and a GADGET-style
contention penalty (concurrent w>=2 jobs share links and slow each other
down).  A flat homogeneous ClusterModel — the default built from a bare
``capacity`` int — reproduces the paper's setup bit-identically.

With ``ClusterModel(placement=...)`` both engines additionally run the
node-level placement engine (:mod:`repro_torch.core.placement`): every gang
gets a concrete per-node assignment from the placement strategy,
spanning/contention status derives from the *actual* assignment under
fragmentation (each job's speed is its flat table row times its
placement factor, tracked in ``place_factor``/``spanning``), the
migration/defrag pass may consolidate spanning gangs (charging the
restart freeze), and the admission rule may delay (``delayed`` retry
list) or reject arrivals (``SimResult.rejected``).  A placement engine
over a flat cluster is a structural no-op — factors stay exactly 1.0 and
trajectories are bit-identical to the placement-free path (gated by the
60-job golden values and the 1000-job sha256 parity tests).

Two engines, one trajectory:

  * ``engine="table"`` (default) — the hot path, structure-of-arrays with
    cross-tick incremental state.  The active set lives in ``_SoAState``:
    numpy ``remaining`` / ``w`` / ``frozen`` / ``speed_now`` arrays in
    reference active-list order (order is load-bearing for tie-breaks and
    FIFO grants) occupying a sliding window of doubling-growth arrays —
    head completions advance the window in O(1), interior ones shift the
    shorter side (never the whole set — removal is O(min side)).  Speed tables are *interned*: jobs with identical
    speed-determining parameters share one row of a distinct-rows matrix
    through a ``rows`` indirection (``JobSpec.speed_table`` returns
    shared cached arrays, bit-identical to per-scalar ``speed`` calls),
    so a homogeneous 10k-job fleet stores one row, not a 10k-row matrix
    recopied per completion.  Allocation is one ``policy.allocate`` call
    over the SoA views (:class:`scheduler.AllocView`) carrying the
    :class:`scheduler.IncrementalContext` — the admission-seq spine the
    persistent gain-heaps hang solver state off between ticks, so a
    reallocation costs O(changed jobs), not O(active jobs).  Per-event
    scans (completion estimates, progress advance, unfreeze validation,
    contention counts) touch only the dirty slice: the <= capacity rows
    holding workers, tracked incrementally, plus rows admitted since the
    last scan — a saturated 100k-job backlog costs events nothing.
    ``slotted`` policies return a sparse :class:`scheduler.AllocDelta`
    (only the rows whose allocation may have moved) that the engine
    applies in O(Δ) — no dense target, no full-width compare — and when
    the running set is small (<= 16 rows, srtf's steady state) the
    per-event scans run as plain-float scalar loops over a cached
    effective-speed list: the same IEEE-754 elementwise operations the
    vectorized path performs, so the trajectory stays bit-identical.
    Deterministic events (reschedule ticks, restart-freeze expiries)
    live in a bucketed calendar queue (``_CalendarQueue``, heap-order
    identical, O(1) amortized for this dense near-future stream), and
    the next arrival is an index into the time-sorted job list.  This is
    what makes 1000-job traces finish in well under a second and
    10k–100k-job traces first-class (seconds to ~a minute per strategy).
    Completion estimates are deliberately *recomputed* each event: the
    trajectory ``remaining -= dt * speed`` re-derives the completion time
    from the current (now, remaining) pair at every event, so a cached
    completion event would drift from the reference by one ulp per tick —
    recomputation is what keeps the two engines bit-identical.  Pure
    reschedule ticks skip re-solving only for policies that declare
    ``static = True`` (``fixed_k``, ``utility_greedy``), whose target
    provably depends on nothing but the active-set identity/order; the
    others re-solve every tick because their targets move with
    ``remaining`` (on the Table-3 workloads ~20% of same-active-set
    re-solves change the target, so skipping them would change results).
  * ``engine="reference"`` — the seed O(J)-rescan loop, preserved with the
    seed's cost profile in ``repro_torch.core._reference`` as the parity oracle
    and the "seed" side of benchmarks/bench_scheduler.py.

Both engines share the exploratory-phase gang-grant clamp (a job entering
its explore phase reserves ``min(8, remaining capacity)`` instead of the
old all-or-nothing 8/0 grant, which starved later explorers outright).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from time import perf_counter

import numpy as np

from repro_torch.collectives.cost import ClusterModel
from repro_torch.core import _reference, scheduler as sched
from repro_torch.core import telemetry as _tele
from repro_torch.core.jobs import JobSpec
# Shared §6/§7 constants (the explore schedule is policy-owned now);
# re-exported here because callers historically read them off this module.
from repro_torch.core.scheduler import (EXPLORE_SEGMENT, EXPLORE_WS,  # noqa: F401
                                  RESCHEDULE_EVERY)
from repro_torch.core._reference import _Active  # noqa: F401  (compat re-export)

# The restart pause (paper §6, ~10 s) is configured per cluster:
# ``ClusterModel(restart_cost=...)``.  There is deliberately no module
# constant — a module-level knob would silently no-op now that both
# engines read ``cluster.restart_cost``.


@dataclasses.dataclass
class SimResult:
    strategy: str
    completion_times: dict[int, float]
    arrival_times: dict[int, float]
    peak_concurrency: int
    # placement-engine observability (empty/0 on legacy clusters):
    # arrivals the admission rule turned away, and defrag gang moves
    rejected: tuple[int, ...] = ()
    migrations: int = 0
    # fault injection (PR 10): gangs killed by node failures (0 on
    # fault-free runs; compared by the engine-parity gates)
    evictions: int = 0
    # end-of-run metrics rollup (``telemetry.TelemetryResult``) when the
    # run was telemetered (``simulate(..., telemetry=...)``), else None
    telemetry: object | None = None

    @property
    def avg_jct_hours(self) -> float:
        jcts = [self.completion_times[j] - self.arrival_times[j]
                for j in self.completion_times]
        return float(np.mean(jcts)) / 3600.0

    @property
    def utilization(self) -> float | None:
        """Time-weighted mean busy-GPU fraction over the run.

        Allocated GPUs count as busy — a frozen (restarting) gang still
        holds its GPUs.  Computed from the telemetry event integrals, so
        it is ``None`` unless the run was telemetered; both engines
        produce bitwise-equal values (asserted by the parity gates).
        """
        t = self.telemetry
        return None if t is None else t.utilization


def _allocate(strategy: str, active: list[_Active], capacity: int,
              now: float) -> dict[int, int]:
    """Target allocation for an ``_Active`` list — a thin adapter over the
    policy registry, kept for tests and ad-hoc callers that hold per-job
    objects instead of SoA state.  Builds the views once and delegates to
    ``policy.allocate``."""
    cluster = ClusterModel(capacity=capacity)
    policy = sched.get_policy(strategy)
    target = policy.allocate(_reference._view_of(active, cluster), cluster,
                             now)
    return {a.spec.job_id: int(w) for a, w in zip(active, target)}


# The table-path adapter collapsed into the same registry call (the
# per-job cached table rows it used to read are superseded by the
# cluster-keyed ``JobSpec.speed_table`` cache the views are built from).
_allocate_table = _allocate


def simulate(jobs: list[JobSpec], capacity: int | None = None,
             strategy: str | sched.SchedulingPolicy = "precompute",
             engine: str = "table",
             cluster: ClusterModel | None = None,
             telemetry: object | None = None) -> SimResult:
    """Simulate ``jobs`` on a cluster under a scheduling policy.

    ``strategy`` is a registry spec string (``"precompute"``,
    ``"fixed_8"``, ``"srtf"``, ...) or a policy instance.  Size the
    cluster with either ``capacity`` (a flat homogeneous cluster of that
    many GPUs — the paper's setup; default 64) or ``cluster`` (a full
    :class:`ClusterModel` with topology, contention and restart cost) —
    passing both with disagreeing sizes is an error, not a silent pick.

    ``telemetry`` is a :class:`repro_torch.core.telemetry.Telemetry` handle to
    record the run (events, counters, utilization — attached to
    ``SimResult.telemetry``); ``None`` (the default) runs the
    zero-overhead disabled path and leaves ``SimResult.telemetry`` None.
    The trajectory is bit-identical either way (gated by the parity
    suite).
    """
    if cluster is None:
        cluster = ClusterModel(capacity=64 if capacity is None else capacity)
    elif capacity is not None and capacity != cluster.capacity:
        raise ValueError(
            f"conflicting cluster size: capacity={capacity} but "
            f"cluster.capacity={cluster.capacity}; pass one or make them "
            f"agree")
    policy = sched.get_policy(strategy)
    # stall guard (e.g. a fixed gang larger than the cluster means every
    # job gets the all-or-nothing 0 grant forever and the event loop
    # would tick on reschedules for eternity)
    policy.validate(cluster)
    tel = _tele.NULL if telemetry is None else telemetry
    if engine == "table":
        return _simulate_table(jobs, cluster, policy, tel)
    if engine == "reference":
        return _reference.simulate_reference(jobs, cluster, policy, tel)
    raise ValueError(f"unknown engine {engine!r}")


# Event kinds in the fast engine's static-event queue.
_EV_RESCHED = 0
_EV_UNFREEZE = 1

# Shared "no completions this event" sentinel: the scalar advance loop
# compares by identity and only allocates a real list on the first find,
# so the common no-completion event allocates nothing.  Never mutated.
_NO_COMP: list = []


class _CalendarQueue:
    """Bucketed calendar queue for the fast engine's static events.

    Reschedule ticks and restart-unfreeze expiries form a dense,
    near-future, almost-monotone stream: every event lands within
    ``RESCHEDULE_EVERY`` (or ``restart_cost``) of the current time, so a
    calendar of ``width``-second buckets pops in O(1) amortized where a
    binary heap pays O(log pending) and comparison overhead per stale
    entry.  Pop order is identical to ``heapq`` over ``(t, kind)``
    tuples: buckets partition time monotonically and each bucket keeps
    its (few) entries ``bisect``-sorted by the same key, so the head of
    the first non-empty bucket *is* the global lexicographic minimum.
    The cursor only moves forward except when a push lands behind it
    (an unfreeze scheduled while the cursor sits on a far-future
    reschedule tick), which resets it to that bucket.
    """

    __slots__ = ("width", "buckets", "cursor", "n")

    def __init__(self, width: float):
        self.width = width
        self.buckets: dict[int, list[tuple[float, int]]] = {}
        self.cursor = 0
        self.n = 0

    def push(self, t: float, kind: int) -> None:
        b = int(t / self.width)
        lst = self.buckets.get(b)
        if lst is None:
            self.buckets[b] = [(t, kind)]
        else:
            bisect.insort(lst, (t, kind))
        if b < self.cursor or not self.n:
            self.cursor = b
        self.n += 1

    def peek(self) -> tuple[float, int] | None:
        if not self.n:
            return None
        while True:
            lst = self.buckets.get(self.cursor)
            if lst:
                return lst[0]
            self.cursor += 1

    def pop(self) -> tuple[float, int]:
        head = self.peek()
        assert head is not None, "pop from an empty calendar queue"
        lst = self.buckets[self.cursor]
        lst.pop(0)
        if not lst:
            del self.buckets[self.cursor]
        self.n -= 1
        return head


class _SoAState:
    """Slot-stable structure-of-arrays active set (fast engine).

    One row per *admitted* job, indexed by its admission slot: row
    ``s`` is the s-th job ever admitted, and rows never move.  Slot
    order is arrival order — the order the reference engine's active
    list preserves and every solver tie-break keys off — so the live
    subsequence of the slot space *is* the reference list.  A completion
    flips ``alive[s]`` off in O(1) (plus amortized-O(1) bookkeeping
    below) instead of shifting array rows: the min-side memmove the old
    windowed layout paid per interior completion was SRTF's worst case
    (its completions land mid-window by design) and priced 1M-job
    traces out entirely.

    Dead slots are skipped on enumeration through ``nxt``, a
    path-compressed next-live pointer chain (``nxt[s]`` = first
    possibly-live slot after a dead ``s``), giving O(α) amortized hops;
    ``lo``/``hi`` bound the live region and ``n`` counts it.

    ``pref`` caches the FIFO candidate prefix — the first
    ``min(n, capacity)`` live slots, the only jobs any seeded solver
    can grant workers — maintained incrementally (append on arrival,
    bisect-patch + next-live refill on a prefix death), so a solver's
    ``prefix(k)`` call is an O(1) ndarray slice instead of an O(n) live
    scan.

    Speed tables are *interned*: ``rows[s]`` indexes job s's row in a
    matrix holding only the distinct tables of the fleet (keyed by the
    object identity of the cached ``JobSpec.speed_table`` array), so a
    10k-job homogeneous trace stores one 65-float row, not a 10k x 65
    matrix.
    """

    _ARRAYS = ("ids", "remaining", "w", "frozen", "speed_now",
               "explore_started", "max_w", "place_factor", "spanning",
               "rows")

    __slots__ = _ARRAYS + ("n", "lo", "hi", "alive", "nxt", "tables",
                           "n_rows", "tables_pos", "pref", "pref_cap",
                           "pref_version", "_pref_arr", "_pref_dirty",
                           "_row_ids", "_row_pin", "ctx", "_view")

    def __init__(self, table_width: int, cap: int = 16,
                 prefix_cap: int | None = None):
        self.n = 0                          # live jobs
        self.lo = 0                         # first possibly-live slot
        self.hi = 0                         # one past the last admitted
        self.ids = np.zeros(cap, np.int64)
        self.remaining = np.zeros(cap)
        self.w = np.zeros(cap, np.int64)
        self.frozen = np.zeros(cap)
        self.speed_now = np.zeros(cap)      # table[w[i]] (0 when w == 0)
        self.explore_started = np.full(cap, -np.inf)
        self.max_w = np.zeros(cap, np.int64)
        # placement-engine rows: speed multiplier over the flat table for
        # the job's current gang assignment, and its actual spanning flag
        # (always 1.0 / False on legacy clusters)
        self.place_factor = np.ones(cap)
        self.spanning = np.zeros(cap, bool)
        self.rows = np.zeros(cap, np.int64)
        self.alive = np.zeros(cap, bool)
        self.nxt = np.zeros(cap, np.int64)
        self.tables = np.zeros((4, table_width))
        self.n_rows = 0
        # every interned row has f(w) > 0 for all w >= 1 (checked once
        # per distinct row) — lets the engine skip per-event speed masks
        self.tables_pos = True
        # FIFO prefix cache: first min(n, pref_cap) live slots (the
        # engine builds tables capacity+1 wide, so that is the default)
        self.pref: list[int] = []
        self.pref_cap = (max(table_width - 1, 1) if prefix_cap is None
                         else prefix_cap)
        self.pref_version = 0   # bumped on any prefix membership change
        self._pref_arr = np.empty(0, np.int64)
        self._pref_dirty = False
        self._row_ids: dict[int, int] = {}
        self._row_pin: list[np.ndarray] = []    # keeps id() keys alive
        self.ctx = sched.IncrementalContext()
        self._view: sched.AllocView | None = None

    def _make_room(self) -> None:
        """Slot space full: double every array (slots are absolute and
        never move, so this is one copy of the admitted region —
        amortized O(1) per admission)."""
        cap = 2 * len(self.ids)
        hi = self.hi
        for name in self._ARRAYS + ("alive", "nxt"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            new[:hi] = old[:hi]
            setattr(self, name, new)

    def _row_id(self, table_row: np.ndarray) -> int:
        """Interned row index for a speed-table array (object identity —
        ``JobSpec.speed_table`` returns shared cached arrays)."""
        rid = self._row_ids.get(id(table_row))
        if rid is None:
            rid = self.n_rows
            if rid == len(self.tables):
                tables = np.zeros((2 * rid, self.tables.shape[1]))
                tables[:rid] = self.tables
                self.tables = tables
            self.tables[rid, :] = table_row
            self._row_ids[id(table_row)] = rid
            self._row_pin.append(table_row)
            self.n_rows = rid + 1
            if not bool((table_row[1:] > 0.0).all()):
                self.tables_pos = False
        return rid

    def add(self, spec: JobSpec, table_row: np.ndarray,
            explore_started: float | None) -> int:
        i = self.hi
        if i == len(self.ids):
            self._make_room()
        self.ids[i] = spec.job_id
        self.remaining[i] = spec.epochs
        self.w[i] = 0
        self.frozen[i] = 0.0
        self.speed_now[i] = 0.0
        self.explore_started[i] = (-np.inf if explore_started is None
                                   else explore_started)
        self.max_w[i] = spec.max_w
        self.place_factor[i] = 1.0
        self.spanning[i] = False
        self.rows[i] = self._row_id(table_row)
        self.alive[i] = True
        self.nxt[i] = i + 1     # read only once dead: the successor slot
        self.hi = i + 1
        self.n += 1
        if len(self.pref) < self.pref_cap:
            self.pref.append(i)
            self.pref_version += 1
            self._pref_dirty = True
        return i

    def _find(self, s: int) -> int:
        """First live slot >= ``s`` (caller guarantees one exists), with
        path compression over the dead slots walked."""
        alive, nxt = self.alive, self.nxt
        r = s
        while not alive[r]:
            r = int(nxt[r])
        if r > s:
            while not alive[s]:
                t = int(nxt[s])
                nxt[s] = r
                s = t
        return r

    def remove(self, gone: list[int]) -> None:
        """Mark the jobs at slots ``gone`` (ascending) dead: O(1) per
        slot plus amortized-O(1) ``lo`` advance and O(prefix-deaths)
        prefix patching — never an array shift."""
        alive = self.alive
        for s in gone:
            alive[s] = False
        self.n -= len(gone)
        lo, hi = self.lo, self.hi
        while lo < hi and not alive[lo]:
            lo += 1
        self.lo = lo
        pref = self.pref
        if pref and gone[0] <= pref[-1]:
            for s in gone:
                if not pref or s > pref[-1]:
                    break
                j = bisect.bisect_left(pref, s)
                if j < len(pref) and pref[j] == s:
                    del pref[j]
            # refill from the next live slots beyond the prefix so the
            # invariant len(pref) == min(n, pref_cap) holds
            while len(pref) < self.n and len(pref) < self.pref_cap:
                pref.append(self._find(pref[-1] + 1 if pref else lo))
            self.pref_version += 1
            self._pref_dirty = True

    def _prefix(self, k: int) -> np.ndarray:
        """Slots of the first ``k`` live jobs (k <= min(n, pref_cap))."""
        if self._pref_dirty:
            self._pref_arr = np.array(self.pref, np.int64)
            self._pref_dirty = False
        return self._pref_arr[:k]

    def live_slots(self) -> np.ndarray:
        """All live slots, ascending — the dense active-set order.  O(hi
        - lo): only the placement path and non-slotted (dense-contract)
        policies pay it."""
        return np.nonzero(self.alive[self.lo:self.hi])[0] + self.lo

    def view(self, placement=None) -> sched.AllocView:
        """The slotted policy-facing view: full slot-indexed arrays plus
        the refreshed incremental context.  The view object is reused
        across solves — only the scalars move between them; the array
        fields are rebound when the backing arrays grow (``_make_room``
        reassigns all of them together, so one identity check covers
        the lot) or a new table row is interned."""
        ctx = self.ctx
        ctx.pref_version = self.pref_version
        v = self._view
        if (v is None or v.remaining is not self.remaining
                or v.tables.shape[0] != self.n_rows):
            # ``alive`` is rebound together with ``remaining`` when the
            # arrays grow, so the identity check above covers the ctx
            # fields too
            ctx.alive = self.alive
            ctx.prefix = self._prefix
            v = self._view = sched.AllocView(
                remaining=self.remaining,
                tables=self.tables[:self.n_rows],
                max_w=self.max_w,
                explore_started=self.explore_started,
                rows=self.rows,
                placement=placement,
                live=self.alive, lo=self.lo, hi=self.hi,
                n_live=self.n,
                inc=ctx)
        else:
            v.placement = placement
            v.lo = self.lo
            v.hi = self.hi
            v.n_live = self.n
        return v

    def dense_view(self, ls: np.ndarray, placement=None) -> sched.AllocView:
        """A dense (reference-shaped) view gathered over live slots
        ``ls`` — the compatibility shim for non-slotted policies, which
        keep the plain dense-target ``allocate`` contract."""
        return sched.AllocView(remaining=self.remaining[ls],
                               tables=self.tables[:self.n_rows],
                               max_w=self.max_w[ls],
                               explore_started=self.explore_started[ls],
                               rows=self.rows[ls],
                               placement=placement)


def _simulate_table(jobs: list[JobSpec], cluster: ClusterModel,
                    policy: sched.SchedulingPolicy,
                    tel: object = _tele.NULL) -> SimResult:
    capacity = cluster.capacity
    restart_cost = cluster.restart_cost
    penalty = cluster.contention_penalty
    peng = None
    if cluster.placement is not None:
        from repro_torch.core.placement import PlacementEngine
        peng = PlacementEngine(cluster)
    pending = sorted(jobs, key=lambda j: j.arrival)
    n_jobs = len(pending)
    pi = 0                        # next-arrival cursor into `pending`
    # Fault injection (PR 10): one deterministic incident tape per
    # (cluster, fault_seed), delivered by a sorted cursor exactly like
    # arrivals.  Empty on fault-free clusters — the per-event cost is a
    # single int compare and the trajectory is bit-identical to pre-fault
    # code (gated by the goldens).
    fsched: tuple = ()
    ckpt = None
    if cluster.faults is not None:
        from repro_torch.core.faults import CheckpointPolicy, get_fault_model
        horizon = pending[-1].arrival if pending else 0.0
        fsched = get_fault_model(cluster.faults).schedule(
            cluster, cluster.fault_seed, horizon)
        ckpt = CheckpointPolicy(
            interval=(cluster.checkpoint_interval
                      if cluster.checkpoint_interval is not None
                      else CheckpointPolicy.interval),
            restart_cost=cluster.restart_cost)
    nf = len(fsched)
    fi = 0                        # next-fault cursor into `fsched`
    requeue_rem: dict[int, float] = {}  # evicted job -> remaining at requeue
    evictions = 0
    # slots don't carry specs; eviction-requeue needs them back
    spec_by_id = {j.job_id: j for j in jobs} if nf else None
    st = _SoAState(table_width=capacity + 1)
    # telemetry: one recorder per run; hot paths pay a single ``rec_on``
    # check when disabled (``rec`` is the module no-op singleton then)
    rec = tel.recorder(policy.spec, capacity, n_jobs,
                       getattr(cluster, "gpus_per_node", 0) or 0)
    rec_on = rec.on
    # solve-timer handle hoisted out of the event loop (bound method:
    # one call per reallocation instead of two attribute chases + call)
    t_solve_add = rec.t_solve.add if rec_on else None
    st.ctx.tel = rec.registry
    if peng is not None:
        peng.rec = rec
    done: dict[int, float] = {}
    arrivals = {j.job_id: j.arrival for j in jobs}
    delayed: list[JobSpec] = []   # admission-delayed, retried every event
    rejected: list[int] = []
    now = 0.0
    peak = 0
    next_resched = 0.0
    static_key: tuple | None = None
    static_target: np.ndarray | None = None
    # Static-event queue: restart-freeze expiries only, bucketed by tick
    # period, with lazy invalidation (stale entries are discarded at
    # peek time).  The reschedule tick needs no queue at all — it is
    # always exactly ``next_resched``, a scalar.
    events = _CalendarQueue(RESCHEDULE_EVERY)
    # Dirty-slice bookkeeping: at most `capacity` jobs hold workers at
    # once, so per-event scans (estimates, advance, unfreeze checks,
    # contention counts) run over `run` — the slots with w > 0 —
    # instead of the thousands of queued w=0 rows a saturated 10k-job
    # trace carries.  `run` is maintained *incrementally* from the
    # sparse allocation deltas (and the cached communicating-job count
    # with it); `fresh` holds slots admitted since the last completion
    # scan, the only other rows whose remaining work could newly sit at
    # <= 0.
    run = np.empty(0, np.int64)
    run_list: list[int] = []      # same slots as plain ints, sorted
    nr = 0                        # == len(run_list)
    run_set: set[int] = set()
    comm_n = 0
    fresh: list[int] = []
    # Under fault injection the applied allocation can be clamped below
    # what the solver asked for (surviving capacity), and evictions can
    # change membership without moving the (hi, done) static key — both
    # silently diverge a slotted solver's persistent incremental state
    # (or a static policy's cached target) from the engine's ground
    # truth.  Churn runs force the stateless dense contract instead;
    # fault-free runs keep every fast path (gated by the goldens).
    use_slotted = policy.slotted and not nf
    # Below this run-set size the per-event estimate/advance/completion
    # pass runs as a scalar Python loop instead of vectorized numpy —
    # same IEEE-754 ops element by element (gather/divide/multiply/
    # subtract and an exact min), so the trajectory is bit-identical,
    # but without the ~1-2 µs fixed cost per array op that dominates
    # when only a handful of jobs hold workers (srtf runs ~8 winners on
    # a 64-GPU cluster; the vector path keeps winning at ~64).
    small_run = 16 if peng is None else -1
    sp_l: list[float] = []        # effective speed per run_list slot
    speed_eff = np.empty(0)       # effective speed per run entry
    fac_ok = True                 # contention factor > 0 for this run set
    # Scalar run summaries.  ``max_frz`` is a conservative upper bound
    # on every running job's restart-freeze expiry: bumped at freeze
    # time, never recomputed (a member leaving ``run`` can only lower
    # the true max, so the bound stays sound and self-heals as time
    # passes it).  With max_frz in the past — the steady state; freezes
    # are short — the per-event estimate/advance pass needs no frozen
    # gather and no masking at all.  ``spd_ok`` (every running job has
    # nonzero speed) is the interned-table positivity flag on flat
    # clusters and a per-refresh check under a placement engine, whose
    # factors can zero a speed.
    max_frz = 0.0
    spd_ok = True

    def refresh_speed() -> None:
        """Re-derive the run set's *effective* speeds (contention factor
        folded in) once per membership/allocation change.  Every input —
        ``speed_now``, ``w``, ``spanning``, ``comm_n`` — only moves
        right before a refresh, so caching here is value-identical to
        the old per-event recompute (same ops on the same floats), and
        the per-event pass shrinks to a divide and a min."""
        nonlocal sp_l, speed_eff, fac_ok
        fac = cluster.contention_factor(comm_n) if penalty else 1.0
        fac_ok = fac > 0.0
        if nr <= small_run:
            spd = st.speed_now
            if fac != 1.0:
                wv = st.w
                sp_l = [spd[s] * fac if wv[s] >= 2 else spd[s]
                        for s in run_list]
            else:
                sp_l = [spd[s] for s in run_list]
        else:
            sr = st.speed_now[run]
            if fac != 1.0:
                comm = (st.spanning[run] if peng is not None
                        else st.w[run] >= 2)
                sr = np.where(comm, sr * fac, sr)
            speed_eff = sr

    def refresh_run_from_set() -> None:
        """Rebuild the sorted run list from the incrementally-updated
        slot set — O(|run| log |run|) with |run| <= capacity, never
        O(active jobs).  The ndarray twin is only materialized above the
        scalar-loop threshold.  Flat clusters only (placement recomputes
        dense)."""
        nonlocal run, run_list, nr, comm_n
        run_list = sorted(run_set)
        nr = len(run_list)
        if nr > small_run:
            run = np.fromiter(run_list, np.int64, nr)
        if penalty:
            if nr <= small_run:
                wv = st.w
                comm_n = sum(1 for s in run_list if wv[s] >= 2)
            else:
                comm_n = int((st.w[run] >= 2).sum())
        refresh_speed()

    def refresh_run_dense(ls: np.ndarray | None = None) -> None:
        nonlocal run, run_list, nr, comm_n, spd_ok
        if ls is None:
            ls = st.live_slots()
        w = st.w[ls]
        run = ls[w > 0]
        run_list = run.tolist()
        nr = len(run_list)
        run_set.clear()
        run_set.update(run_list)
        if penalty:
            comm_n = (int(st.spanning[ls].sum()) if peng is not None
                      else int((w >= 2).sum()))
        if peng is not None:
            spd_ok = (bool((st.speed_now[run] > 0.0).all()) if len(run)
                      else True)
        refresh_speed()

    def solve_dense(ls: np.ndarray, pv, now: float) -> np.ndarray:
        """A dense live-ordered target from the policy: non-slotted
        policies return one natively; slotted policies' sparse deltas
        are materialized into the context's reused scratch buffer (the
        placement pass needs the full gang vector)."""
        if not use_slotted:
            return policy.allocate(st.dense_view(ls, pv), cluster, now)
        delta = policy.allocate(st.view(pv), cluster, now)
        target = st.ctx.scratch(len(ls))
        target[:] = st.w[ls]
        if len(delta.slots):
            target[np.searchsorted(ls, delta.slots)] = delta.w
        return target

    p_allocate = policy.allocate
    p_static = policy.static and not nf
    slotted_fast = peng is None and use_slotted
    st_view = st.view

    def apply_alloc(now: float) -> None:
        nonlocal static_key, static_target, max_frz
        if slotted_fast:
            # the sparse fast path: the policy names the slots that may
            # have moved; everything else keeps its allocation — O(Δ)
            # per tick, no dense target, no full-width compare
            if p_static:
                # a static policy's target depends only on the active
                # set's identity/order: with the (admissions,
                # completions) key unchanged the applied allocation is
                # already the target.  The monotone counter pair
                # identifies the set: any membership change moves one.
                key = (st.hi, len(done))
                if key == static_key:
                    if rec_on:
                        rec.solve_reused()
                    return
                static_key = key
            delta = p_allocate(st_view(None), cluster, now)
            tslots, tw = delta.slots, delta.w
            if not len(tslots):
                if rec_on:
                    rec.solve_reused()
                return
            cur = st.w[tslots]
            chm = tw != cur
            if not chm.any():
                if rec_on:
                    rec.solve_reused()
                return
            gs = tslots[chm]
            wn = tw[chm]
            gs_l = gs.tolist()
            wn_l = wn.tolist()
            if rec_on:
                rec.solve(now, len(gs_l), False, st.n)
                for jid, ov, nv in zip(st.ids[gs].tolist(),
                                       cur[chm].tolist(), wn_l):
                    rec.alloc(now, jid, ov, nv)
            st.w[gs] = wn
            st.speed_now[gs] = st.tables[st.rows[gs], wn]
            for s, wv in zip(gs_l, wn_l):
                if wv > 0:
                    run_set.add(s)
                else:
                    run_set.discard(s)
            refresh_run_from_set()
            started = gs[wn > 0]
        else:
            pv = None if peng is None else peng.view()
            ls = st.live_slots()
            if p_static:
                key = (st.hi, len(done))
                if key != static_key:
                    static_key = key
                    # cached across events: copy out of the scratch
                    # buffer the next solve would overwrite
                    static_target = solve_dense(ls, pv, now).copy()
                target = static_target
            else:
                target = solve_dense(ls, pv, now)
            changed = np.nonzero(target != st.w[ls])[0]
            if peng is None:
                if not len(changed):
                    if rec_on:
                        rec.solve_reused()
                    return
                gi = ls[changed]
                if rec_on:
                    rec.solve(now, len(changed), False, st.n)
                    ids_ = st.ids
                    oldw = st.w[gi].tolist()
                    for s, ov, nv in zip(gi.tolist(), oldw,
                                         target[changed].tolist()):
                        rec.alloc(now, int(ids_[s]), ov, nv)
                st.w[gi] = target[changed]
                st.speed_now[gi] = st.tables[st.rows[gi], target[changed]]
                started = gi[target[changed] > 0]
            else:
                # placement pass runs even when no target changed: a
                # completion may have opened a defrag/consolidation move
                if rec_on:
                    if len(changed):
                        rec.solve(now, len(changed), False, st.n)
                    else:
                        rec.solve_reused()
                    oldw = st.w[ls[changed]].tolist()
                upd, factors, spans = peng.apply(st.ids[ls], target,
                                                 changed.tolist(), now)
                # alloc events fire after apply: under faults the engine
                # clamps grants to surviving capacity in-place, and the
                # logged width must be what the gang actually got
                if rec_on:
                    ids_ = st.ids
                    for s, ov, nv in zip(ls[changed].tolist(), oldw,
                                         target[changed].tolist()):
                        rec.alloc(now, int(ids_[s]), ov, nv)
                st.w[ls] = target
                if not len(upd):
                    return
                gi = ls[upd]
                st.place_factor[gi] = factors
                st.spanning[gi] = spans
                st.speed_now[gi] = (st.tables[st.rows[gi], target[upd]]
                                    * factors)
                started = gi[target[upd] > 0]
            refresh_run_dense(ls)
        until = now + restart_cost
        # batched restart freeze: every job whose allocation changed
        # unfreezes at the same instant, so one queue entry covers them
        # all (the per-job push loop was the last Python loop here)
        if len(started):
            st.frozen[started] = until
            if until > max_frz:
                max_frz = until
            events.push(until, _EV_UNFREEZE)
            if rec_on:
                for jid in st.ids[started].tolist():
                    rec.freeze(now, jid, until)

    stall = 0
    while pi < n_jobs or st.n or delayed:
        now0 = now
        popped = False
        # --- next event time -------------------------------------------
        # discard stale unfreeze events, then take the earlier of the
        # first valid one and the reschedule tick
        while True:
            head = events.peek()
            if head is None:
                t = next_resched
                break
            t = head[0]
            # batched unfreeze: valid while any live allocated job
            # still thaws exactly at t (re-freezes move `frozen` past
            # t and completions drop rows — either stales the entry).
            # The max_frz bound short-circuits the scan: t above it
            # can match nothing.
            if t > now and nr and t <= max_frz:
                if nr <= small_run:
                    frz = st.frozen
                    if any(frz[s] == t for s in run_list):
                        break
                elif bool(np.any(st.frozen[run] == t)):
                    break
            events.pop()
            popped = True
        if next_resched < t:
            t = next_resched
        t_min = t
        if pi < n_jobs and pending[pi].arrival < t_min:
            t_min = pending[pi].arrival
        if fi < nf and fsched[fi].t < t_min:
            t_min = fsched[fi].t
        # completion estimates are recomputed from (now, remaining) every
        # event on purpose — see module docstring (bit-identical
        # trajectory); only the w>0 slice can run, so only it is scanned
        frozen_r = speed_r = None
        fastp = False
        adv = None
        scalar = False
        comp_l: list[int] = _NO_COMP
        if nr and nr <= small_run:
            # scalar twin of the vectorized pass below: same per-element
            # IEEE ops (max/divide then an exact min; multiply/subtract
            # on advance), so every remaining-work value and completion
            # estimate carries the same bits — just without ~10 array-op
            # dispatches for a handful of running jobs.  The completion
            # threshold is checked on the freshly-written value inside
            # the advance loop — the same <= 1e-9 compare the vector
            # path runs as a separate candidate scan.
            scalar = True
            remv = st.remaining
            frz = st.frozen
            no_frz = max_frz <= now
            x_min = math.inf
            for i, s in enumerate(run_list):
                sv = sp_l[i]
                if sv > 0.0 and (no_frz or frz[s] <= now):
                    x = remv[s] / sv
                    if x < x_min:
                        x_min = x
            if x_min < math.inf:
                e_min = now + x_min
                if e_min < t_min:
                    t_min = e_min
            t_next = now if t_min < now else t_min
            if t_next > now:
                for i, s in enumerate(run_list):
                    f0 = frz[s]
                    dt = t_next - (f0 if f0 > now else now)
                    if dt > 0.0:
                        rv = remv[s] - dt * sp_l[i]
                        remv[s] = rv
                        if rv <= 1e-9:
                            if comp_l is _NO_COMP:
                                comp_l = [s]
                            else:
                                comp_l.append(s)
            now = t_next
        elif nr:
            # GADGET-style link sharing is folded into ``speed_eff`` at
            # refresh time: every concurrently-allocated ring job
            # (w >= 2, frozen or not — it holds its links) runs at
            # contention_factor(k) of nominal speed; under a placement
            # engine only *actually node-spanning* rings contend.
            speed_r = speed_eff
            spd_ok_now = spd_ok and fac_ok
            if peng is None:
                spd_ok_now = spd_ok_now and st.tables_pos
            if max_frz <= now and spd_ok_now:
                # nothing frozen, everything runnable: the select mask
                # is provably all-True, so skip building it.  min(now +
                # x_i) == now + min(x_i) exactly (monotone rounding), so
                # the full-width add is skipped too — bits unchanged.
                fastp = True
                e_min = now + (st.remaining[run] / speed_r).min()
                if e_min < t_min:
                    t_min = e_min
            else:
                frozen_r = st.frozen[run]
                sel = (frozen_r <= now) & (speed_r > 0.0)
                if sel.any():
                    est = now + st.remaining[run[sel]] / speed_r[sel]
                    e_min = est.min()
                    if e_min < t_min:
                        t_min = e_min
        if not scalar:
            # --- advance progress (vector twin) --------------------------
            t_next = now if t_min < now else t_min
            if nr:
                if fastp:
                    dts = t_next - now
                    if dts > 0.0:
                        adv = run
                        st.remaining[run] -= dts * speed_r
                else:
                    dt = t_next - np.maximum(frozen_r, now)
                    pos = dt > 0.0
                    if pos.any():
                        adv = run[pos]
                        st.remaining[adv] -= dt[pos] * speed_r[pos]
            now = t_next

        # --- completions -------------------------------------------------
        # only rows that advanced (or were just admitted) can newly reach
        # the threshold — the dirty slice of the old full-width scan
        finished = False
        glist: list[int] | None = None
        if scalar:
            if fresh:
                # fresh (just-admitted) slots use the same threshold —
                # dedupe against the advance-loop finds
                remv = st.remaining
                cl = comp_l + [s for s in fresh if remv[s] <= 1e-9]
                fresh = []
                if cl:
                    glist = sorted(set(cl))
            elif comp_l is not _NO_COMP:
                glist = comp_l        # ascending already: run_list order
        else:
            if fresh:
                cand = (np.asarray(fresh, np.int64) if adv is None
                        else np.concatenate((adv,
                                             np.asarray(fresh, np.int64))))
                fresh = []
            else:
                cand = adv
            if cand is not None and len(cand):
                fin = st.remaining[cand] <= 1e-9
                if fin.any():
                    # ascending slots == arrival order, like the old dense
                    # scan (python set/sort beats np.unique at these sizes)
                    glist = sorted(set(cand[fin].tolist()))
        if glist is not None:
            finished = True
            for i in glist:
                jid = int(st.ids[i])
                done[jid] = now
                if peng is not None:
                    peng.release(jid)
                if rec_on:
                    rec.complete(now, jid)
            st.remove(glist)
            if peng is None:
                for i in glist:
                    run_set.discard(i)
                refresh_run_from_set()
            else:
                refresh_run_dense()

        # --- faults ------------------------------------------------------
        # incidents due at `now` fire after completions (a job that
        # finished at the kill instant keeps its finish) and before
        # arrivals/reallocation, so the next solve sees the shrunk
        # cluster.  `fi < nf` is the only cost on fault-free runs.
        faulted = False
        while fi < nf and fsched[fi].t <= now + 1e-9:
            fe = fsched[fi]
            fi += 1
            faulted = True
            if rec_on:
                rec.fault(now, fe.node, fe.kind)
            if fe.kind == "fail":
                victims = peng.fail(fe.node)
                if victims:
                    vset = set(victims)
                    ids_ = st.ids
                    remv = st.remaining
                    # ascending live slots == reference active-list order
                    vslots = [s for s in st.live_slots().tolist()
                              if int(ids_[s]) in vset]
                    evicted = []
                    for s in vslots:
                        jid = int(ids_[s])
                        spec = spec_by_id[jid]
                        done_p = spec.epochs - float(remv[s])
                        lost = ckpt.lost_progress(done_p)
                        evicted.append(
                            (jid, spec, float(remv[s]) + lost, lost,
                             lost / done_p if done_p > 0.0 else 0.0))
                    st.remove(vslots)
                    evictions += len(vslots)
                    # killed gangs lose un-checkpointed progress and
                    # re-enter through the normal admission path
                    for jid, spec, new_rem, lost, lost_frac in evicted:
                        if rec_on:
                            rec.evict(now, jid, fe.node, lost, lost_frac)
                        requeue_rem[jid] = new_rem
                        verdict = peng.admit(spec, st.n, len(delayed), now)
                        if verdict == "admit":
                            s2 = st.add(spec, spec.speed_table(cluster),
                                        now if policy.explores else None)
                            st.remaining[s2] = requeue_rem.pop(jid)
                            fresh.append(s2)
                            peng.register(spec)
                            if rec_on:
                                rec.recover(now, jid)
                        elif verdict == "reject":
                            requeue_rem.pop(jid)
                            rejected.append(jid)
                            if rec_on:
                                rec.reject(now, jid)
                        else:
                            delayed.append(spec)
                            if rec_on:
                                rec.delay(now, jid)
                    refresh_run_dense()
            elif fe.kind == "drain":
                peng.drain(fe.node)
            elif fe.kind == "recover":
                peng.recover(fe.node)
            else:
                peng.degrade(fe.node, fe.factor)

        # --- arrivals ----------------------------------------------------
        arrived = False
        if delayed:
            # admission-delayed jobs are retried first at every event
            # (they arrived before anything admitted below)
            still: list[JobSpec] = []
            for j in delayed:
                verdict = peng.admit(j, st.n, len(still), now)
                if verdict == "admit":
                    s2 = st.add(j, j.speed_table(cluster),
                                now if policy.explores else None)
                    if requeue_rem:
                        # evicted-then-delayed: resume from the rolled-back
                        # progress, not from scratch
                        rr = requeue_rem.pop(j.job_id, None)
                        if rr is not None:
                            st.remaining[s2] = rr
                    fresh.append(s2)
                    peng.register(j)
                    arrived = True
                    if rec_on:
                        rec.admit(now, j.job_id)
                elif verdict == "reject":
                    rejected.append(j.job_id)
                    if rec_on:
                        rec.reject(now, j.job_id)
                else:
                    still.append(j)
            if still and not arrived and not st.n and pi == n_jobs:
                raise RuntimeError(
                    f"admission rule {cluster.admission!r} stalled: "
                    f"{len(still)} delayed jobs on an idle cluster")
            delayed = still
        while pi < n_jobs and pending[pi].arrival <= now + 1e-9:
            j = pending[pi]
            pi += 1
            if rec_on:
                rec.submit(now, j.job_id, j.arrival)
            if peng is not None:
                verdict = peng.admit(j, st.n, len(delayed), now)
                if verdict == "delay":
                    delayed.append(j)
                    if rec_on:
                        rec.delay(now, j.job_id)
                    continue
                if verdict == "reject":
                    rejected.append(j.job_id)
                    if rec_on:
                        rec.reject(now, j.job_id)
                    continue
                peng.register(j)
            # the cluster-keyed table row (flat clusters share the int-path
            # cache, so this is the exact seed table); sized to `capacity`,
            # not j.max_w: j.max_w may exceed the cluster (mixed fleets),
            # and a capacity-sized row makes every interned table row the
            # same width — the solver never probes past
            # min(j.max_w, capacity) anyway.
            fresh.append(st.add(j, j.speed_table(cluster),
                                now if policy.explores else None))
            arrived = True
            if rec_on:
                rec.admit(now, j.job_id)

        if st.n > peak:
            peak = st.n

        # --- reallocation ------------------------------------------------
        rescheduled = False
        if arrived or finished or faulted or now + 1e-9 >= next_resched:
            if st.n:
                if rec_on:
                    _t0 = perf_counter()
                    apply_alloc(now)
                    t_solve_add(perf_counter() - _t0)
                else:
                    apply_alloc(now)
            next_resched = now + RESCHEDULE_EVERY
            rescheduled = True

        # --- termination guard (sub-ulp completion estimates) ------------
        # Once the clock passes ~2^28 s, the shortest completion estimate
        # can round to exactly ``now`` (x_min < ulp(now)/2): then
        # t_next == now, dt == 0, remaining work never advances, and with
        # no arrival / completion / queue pop / reschedule the iteration
        # is a deterministic fixed point — the loop (and the seed loop,
        # which computes the same doubles) would spin forever.  Three
        # consecutive inert iterations prove the fixed point (one
        # repetition already would, but the calendar cursor may still be
        # settling on the first); the jobs whose estimate rounds to
        # ``now`` then complete AT ``now`` — the event time an explicit
        # completion-event queue would have fired at after the same
        # rounding.  A trace that terminates without this guard never
        # runs even one repeated inert iteration, so every
        # previously-terminating trajectory is bit-identical.
        if (arrived or finished or faulted or popped or rescheduled
                or now > now0):
            stall = 0
        else:
            stall += 1
            if stall >= 3:
                remv = st.remaining
                frz = st.frozen
                idle = max_frz <= now
                stuck = []
                for i, s in enumerate(run_list):
                    sv = (sp_l[i] if nr <= small_run
                          else float(speed_eff[i]))
                    if (sv > 0.0 and (idle or frz[s] <= now)
                            and now + remv[s] / sv == now):
                        stuck.append(s)
                if not stuck:
                    raise RuntimeError(
                        f"event loop stalled at t={now!r} with no "
                        f"sub-ulp completion candidate")
                for s in stuck:
                    remv[s] = 0.0
                # ride the just-admitted completion scan: the next
                # event's candidate pass unions ``fresh`` with the
                # advanced rows and applies the same <= 1e-9 threshold
                fresh.extend(stuck)
                stall = 0

    return SimResult(strategy=policy.spec, completion_times=done,
                     arrival_times=arrivals, peak_concurrency=peak,
                     rejected=tuple(rejected),
                     migrations=0 if peng is None else peng.migrations,
                     evictions=evictions,
                     telemetry=rec.finish(now))


# The paper's Table-3 strategy sweep, plus the registry extensions.
TABLE3_STRATEGIES = ("precompute", "exploratory", "fixed_8", "fixed_4",
                     "fixed_2", "fixed_1", "srtf", "utility_greedy")


def run_table3(seed: int = 0, capacity: int | None = None,
               contention: dict[str, tuple[float, int]] | None = None,
               engine: str = "table",
               pattern: str = "poisson",
               strategies: tuple[str, ...] | None = None,
               cluster: ClusterModel | None = None
               ) -> dict[str, dict[str, float]]:
    """Reproduce Table 3: avg JCT (hours) per strategy x contention level.

    ``pattern`` selects the arrival/size process from the workload-pattern
    library (``jobs.WORKLOAD_PATTERNS``); the paper's own Table 3 is the
    default ``"poisson"`` trace.  ``strategies`` defaults to the paper's
    six plus the registry extensions (srtf, utility_greedy); ``cluster``
    swaps the flat 64-GPU cluster for any :class:`ClusterModel` (e.g. a
    multi-node topology with a contention penalty).
    """
    from repro_torch.core.jobs import make_workload
    contention = contention or {"extreme": (250.0, 206),
                                "moderate": (500.0, 114),
                                "none": (1000.0, 44)}
    strategies = TABLE3_STRATEGIES if strategies is None else strategies
    out: dict[str, dict[str, float]] = {}
    for level, (gap, n_jobs) in contention.items():
        jobs = make_workload(pattern, n_jobs, gap, seed)
        out[level] = {}
        for s in strategies:
            res = simulate(jobs, capacity, s, engine=engine, cluster=cluster)
            out[level][s] = res.avg_jct_hours
    return out
