"""Resource allocation — paper §4 — and the scheduling-policy registry.

The problem (§4.1):   min Σ_j t_j,  t_j = Q_j / f_j(w_j),
                      Σ_j w_j <= C,  w_j in Z+           (NP-hard, non-convex)

Solvers:
  * ``doubling_heuristic``  — §4.2, the paper's contribution: start every job
    at 1 worker, repeatedly *double* the job with the best average marginal
    gain (Q/f(w) - Q/f(2w)) / w.  Doubling steps over the power-of-two
    cliff (8 -> 9 is a per-GPU regression under doubling-halving; 8 -> 16 is
    not), where +1 greedy stalls.
  * ``optimus_greedy``      — the Optimus baseline: +1 worker at a time.
  * ``exact_dp``            — exact DP over worker counts (validation).
  * ``fixed``               — every job requests a constant w (§7 baselines).

Solver API layers, one semantics:

  * *SoA* (``doubling_heuristic_soa`` / ``optimus_greedy_soa`` /
    ``fixed_soa``) take the simulator's structure-of-arrays state directly
    — a remaining-work ndarray plus a 2-D speed-table ndarray — and return
    an int64 allocation array aligned with the input, so the event loop
    never materializes per-job tuples.  Initial w=1 gains are one
    vectorized pass over the ``min(n, capacity)`` candidate prefix (the
    only jobs a FIFO-seeded solver can ever grant workers); the
    doubling/+1 loop is the same lazy max-heap as the table layer.
  * *Incremental* (``_PersistentDoublingHeap`` / ``_PersistentOptimusHeap``
    / ``_PersistentSRTFHeap``, engaged automatically when the fast engine's
    :class:`IncrementalContext` rides on the view) carry the gain-heap /
    remaining-time order *across* reallocation ticks, keyed by a
    generation-stamped admission sequence: a tick pushes entries only for
    jobs whose remaining work moved (arrivals, jobs that ran) and lazily
    discards entries for completed or re-stamped jobs — O(Δ log J) per
    tick instead of an O(J) rebuild, allocation-for-allocation identical
    to the fresh solvers (fuzz-, property- and trace-gated).
  * *Table-driven* (``doubling_heuristic_table`` & friends) take jobs as
    (job_id, Q, speed_table) where ``speed_table[w]`` is f(w) for
    w = 0..max index.  Gains come from O(1) array lookups, and the
    doubling/greedy loops pop a lazy max-heap instead of rescanning all J
    jobs per step.  A job's marginal gain depends only on its own (Q, w),
    so heap entries never need recomputation: an entry is pushed when the
    job reaches w and is simply discarded as stale if the job's allocation
    has moved on by the time it is popped.
  * *Callable-based* (``doubling_heuristic`` & friends) keep the original
    (job_id, Q, speed_fn) signature as thin adapters: they sample the
    callable once into a table and delegate.  Allocation-for-allocation
    identical to the pre-table implementations (the ``*_ref`` seed
    versions now live in ``repro_torch.core._reference``, used only by parity
    tests and ``benchmarks/bench_scheduler.py``).

Tie-breaking matches the original scan exactly: among equal best gains the
job earliest in the input sequence wins, which the heap encodes by ordering
entries (-gain, input_index).

On top of the solvers sits the **policy registry** (bottom of this
module): every cluster strategy — the paper's ``precompute`` /
``exploratory`` / ``fixed_k`` plus SRTF, the Optimus +1-greedy and the
GADGET-style utility greedy — is a :class:`SchedulingPolicy` with one
``allocate(state, cluster, now)`` entry point over the SoA views
(:class:`AllocView`).  Both simulator engines, the benchmarks and the
tests construct policies exclusively through :func:`get_policy`, so a new
strategy is one registered class — not three parallel solver stacks.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.collectives.cost import ClusterModel

Alloc = dict[int, int]
JobTuple = tuple[int, float, Callable[[int], float]]  # (id, Q, speed_fn)
# (id, Q, speed_table) with speed_table[w] = f(w), index 0 unused (= 0.0);
# any indexable works, but a plain list avoids ndarray-scalar overhead
TableJobTuple = tuple[int, float, Sequence[float]]


def _gain_double(Q: float, f, w: int) -> float:
    """Average marginal gain of doubling w -> 2w, per added GPU (eq. 6)."""
    t_now = Q / max(f(w), 1e-12)
    t_next = Q / max(f(2 * w), 1e-12)
    return (t_now - t_next) / w


def _gain_double_table(Q: float, table, w: int) -> float:
    """Eq. 6 gain from a speed table — same float ops as ``_gain_double``."""
    t_now = Q / max(table[w], 1e-12)
    t_next = Q / max(table[2 * w], 1e-12)
    return (t_now - t_next) / w


def _table_bound(capacity: int, max_w) -> int:
    """Largest w any solver ever evaluates: min(max_w, capacity).

    Doubling only scores w -> 2w when the extra w workers still fit
    (used + w <= capacity with used >= w, so 2w <= capacity) and
    2w <= max_w; +1 greedy only scores w+1 <= capacity and <= max_w.
    With per-job caps the bound is the largest cap in the fleet.
    """
    if max_w is None:
        return capacity
    if hasattr(max_w, "__len__"):
        return min(max(max_w) if len(max_w) else capacity, capacity)
    return min(max_w, capacity)


def _caps(max_w, n: int) -> list:
    """Normalize ``max_w`` to one cap per job.

    The doubling solvers accept ``max_w`` as None (unbounded), a scalar
    (every job shares the cap — the paper's single-node-fleet setup), or a
    sequence/ndarray of per-job caps aligned with the job order
    (heterogeneous fleets, e.g. the ``mixed_maxw`` workload pattern).
    """
    if hasattr(max_w, "__len__"):
        caps = list(max_w)
        assert len(caps) == n, f"per-job max_w length {len(caps)} != {n}"
        return caps
    return [max_w] * n


def _caps_head(max_w, n: int, n1: int) -> list:
    """``_caps`` for the first ``n1`` jobs only — the SoA solvers never
    grant workers past the ``min(n, capacity)`` prefix, so the rest of a
    per-job cap array is never read."""
    if hasattr(max_w, "__len__"):
        assert len(max_w) == n, f"per-job max_w length {len(max_w)} != {n}"
        head = max_w[:n1]
        return head.tolist() if isinstance(head, np.ndarray) else list(head)
    return [max_w] * n1


def _gains_w1(Q, tables, rows) -> list[float]:
    """Vectorized w=1 gain pass shared by the fresh SoA solvers and the
    persistent heaps' refresh: per added GPU, (Q/f(1) - Q/f(2)) / 1 —
    identical for the doubling and +1 step rules at w=1, and elementwise
    (the same float values regardless of which jobs share the vector)."""
    t_now = Q / np.maximum(tables[rows, 1], 1e-12)
    t_next = Q / np.maximum(tables[rows, 2], 1e-12)
    return (t_now - t_next).tolist()


def _grow_array(arr: np.ndarray, m: int, fill) -> np.ndarray:
    """``arr`` doubled (repeatedly) to hold at least ``m`` entries, new
    slots set to ``fill`` — the one growth pattern every per-seq array in
    this module shares."""
    cap = len(arr)
    if m <= cap:
        return arr
    while cap < m:
        cap *= 2
    new = np.full(cap, fill, arr.dtype)
    new[:len(arr)] = arr
    return new


def _out_buf(out, n: int) -> np.ndarray:
    """Zeroed int64 target of length ``n``: a fresh array, or the head
    of a caller-reused scratch buffer (the fresh SoA solvers' remaining
    per-solve O(n) allocation, opt-out for hot callers)."""
    if out is None:
        return np.zeros(n, dtype=np.int64)
    out = out[:n]
    out[:] = 0
    return out


def _sample_table(f: Callable[[int], float], max_index: int) -> list[float]:
    return [0.0] + [f(w) for w in range(1, max_index + 1)]


def doubling_heuristic_table(jobs: Sequence[TableJobTuple], capacity: int,
                             max_w=None) -> Alloc:
    """§4.2 doubling heuristic over precomputed speed tables.

    Lazy max-heap over doubling gains: O((J + doublings) log J) instead of
    the reference implementation's O(J) rescan per doubling step.
    ``max_w`` may be a scalar or per-job caps (see ``_caps``).
    """
    jobs = list(jobs)
    caps = _caps(max_w, len(jobs))
    alloc: Alloc = {}
    used = 0
    heap: list[tuple[float, int, int]] = []   # (-gain, input index, w)
    for idx, (jid, Q, table) in enumerate(jobs):
        if used < capacity:
            alloc[jid] = 1
            used += 1
            mw = caps[idx]
            if (mw is None or 2 <= mw) and 2 < len(table):
                g = _gain_double_table(Q, table, 1)
                if g > 0.0:
                    heap.append((-g, idx, 1))
        else:
            alloc[jid] = 0
    heapq.heapify(heap)
    while heap:
        neg_g, idx, w = heapq.heappop(heap)
        jid, Q, table = jobs[idx]
        if alloc[jid] != w:
            continue                      # stale: job already doubled past w
        if used + w > capacity:
            continue    # never feasible again (used only grows) -> discard
        used += w
        w2 = 2 * w
        alloc[jid] = w2
        mw = caps[idx]
        if ((mw is None or 2 * w2 <= mw) and used + w2 <= capacity
                and 2 * w2 < len(table)):
            g = _gain_double_table(Q, table, w2)
            if g > 0.0:
                heapq.heappush(heap, (-g, idx, w2))
    return alloc


def doubling_heuristic_soa(Q, tables, capacity: int,
                           max_w=None, rows=None, out=None):
    """§4.2 doubling heuristic over structure-of-arrays job state.

    The SoA twin of ``doubling_heuristic_table`` for the simulator hot
    path: ``Q`` is a float ndarray of remaining work (one entry per job,
    in allocation order), ``tables`` a 2-D ndarray whose row ``rows[i]``
    is job i's speed table (``rows=None`` means row i), and the result is
    an int64 ndarray of worker counts aligned with ``Q`` — no per-job
    tuples or dicts are materialized.  The initial w=1 gains are computed
    in one vectorized pass; the doubling loop is the same lazy max-heap
    with ``(-gain, input index, w)`` entries, so allocations (and
    tie-breaks) are bit-identical to the table/reference solvers.

    Inside the doubling loop everything is plain Python ints/floats
    (ndarray-scalar indexing would triple the per-pop cost); ``float`` /
    ``.tolist()`` conversions of float64 values are exact, so this costs
    nothing in identity.

    Only the first ``min(n, capacity)`` jobs can ever hold workers (the
    FIFO w=1 seeding exhausts the cluster), so the per-job lists are
    materialized for that prefix alone — the per-solve cost is
    O(min(n, C) + heap work) plus one O(n) zero-filled output array
    (pass ``out``, a reusable int64 buffer of length >= n, to avoid
    even that; the engine's hot path avoids dense targets entirely via
    the :class:`AllocDelta` contract).
    """
    n = len(Q)
    n1 = min(n, capacity)
    out = _out_buf(out, n)
    if n1 == 0:
        return out
    head = [1] * n1
    row_of = (list(range(n1)) if rows is None
              else np.asarray(rows)[:n1].tolist())
    caps = _caps_head(max_w, n, n1)
    used = n1
    W = tables.shape[1] - 1
    heap: list[tuple[float, int, int]] = []
    if 2 <= W:
        gains = _gains_w1(Q[:n1], tables, row_of)
        heap = [(-g, i, 1) for i, g in enumerate(gains)
                if g > 0.0 and (caps[i] is None or 2 <= caps[i])]
        heapq.heapify(heap)
    q_of = Q[:n1].tolist()
    while heap:
        neg_g, idx, w = heapq.heappop(heap)
        if head[idx] != w:
            continue                      # stale: job already doubled past w
        if used + w > capacity:
            continue    # never feasible again (used only grows) -> discard
        used += w
        w2 = 2 * w
        head[idx] = w2
        mw = caps[idx]
        if ((mw is None or 2 * w2 <= mw) and used + w2 <= capacity
                and 2 * w2 <= W):
            table = tables[row_of[idx]]
            gq = q_of[idx]
            g = (gq / max(float(table[w2]), 1e-12)
                 - gq / max(float(table[2 * w2]), 1e-12)) / w2
            if g > 0.0:
                heapq.heappush(heap, (-g, idx, w2))
    out[:n1] = head
    return out


def optimus_greedy_soa(Q, tables, capacity: int, max_w=None, rows=None,
                       out=None):
    """Optimus [8] +1-greedy over structure-of-arrays job state — the SoA
    twin of ``optimus_greedy_table``, with the same prefix-only
    materialization (and reusable ``out`` buffer) as
    ``doubling_heuristic_soa``."""
    n = len(Q)
    n1 = min(n, capacity)
    out = _out_buf(out, n)
    if n1 == 0:
        return out
    head = [1] * n1
    row_of = (list(range(n1)) if rows is None
              else np.asarray(rows)[:n1].tolist())
    caps = _caps_head(max_w, n, n1)
    used = n1
    W = tables.shape[1] - 1
    heap: list[tuple[float, int, int]] = []
    if 2 <= W:
        gains = _gains_w1(Q[:n1], tables, row_of)
        heap = [(-g, i, 1) for i, g in enumerate(gains)
                if g > 0.0 and (caps[i] is None or 2 <= caps[i])]
        heapq.heapify(heap)
    q_of = Q[:n1].tolist()
    while used < capacity and heap:
        neg_g, idx, w = heapq.heappop(heap)
        if head[idx] != w:
            continue                                   # stale entry
        w1 = w + 1
        head[idx] = w1
        used += 1
        mw = caps[idx]
        if (mw is None or w1 + 1 <= mw) and w1 + 1 <= W:
            table = tables[row_of[idx]]
            gq = q_of[idx]
            g = (gq / max(float(table[w1]), 1e-12)
                 - gq / max(float(table[w1 + 1]), 1e-12))
            if g > 0.0:
                heapq.heappush(heap, (-g, idx, w1))
    out[:n1] = head
    return out


def fixed_soa(n: int, capacity: int, w_fixed: int, out=None):
    """SoA twin of ``fixed``: first ``capacity // w_fixed`` jobs get the
    all-or-nothing gang of ``w_fixed`` (FIFO), the rest get 0."""
    out = _out_buf(out, n)
    out[:min(n, capacity // w_fixed)] = w_fixed
    return out


# --------------------------------------------------------------------------
# Incremental cross-tick solver state + the sparse allocation-delta
# contract.
#
# A fresh solve rebuilds its gain-heap from every active job at every
# reallocation event — O(J) init per tick, the wall 10k-job traces hit
# once thousands of queued jobs sit behind a 64-GPU cluster.  The
# persistent structures below carry solver state *across* ticks instead:
# a tick only touches jobs whose remaining work changed since the last
# solve (arrivals, jobs that ran) and lazily discards entries for jobs
# that completed or whose work moved on — O(Δ log J) per tick.
#
# The *output* is sparse too: on the fast-engine path a policy returns
# an :class:`AllocDelta` — only the rows whose allocation may have
# moved — instead of a dense length-n target vector, so a steady-state
# tick costs O(Δ) target traffic instead of an O(n) ``np.zeros`` plus a
# full-width ``target != w`` compare.  The completeness obligation is
# on the policy: every row whose correct target differs from the
# engine's current allocation must be listed (listing unchanged rows is
# allowed — the engine filters).  All built-in policies discharge it
# with the same argument: the rows they can ever grant live in the
# FIFO candidate prefix (whose membership is monotone for a live job),
# plus an explicitly tracked previous-winner set for the policies that
# grant outside the prefix (srtf, exploratory).
#
# Identity contract: every structure reproduces its fresh solver
# bit-for-bit (same float ops per entry, same (gain, arrival-order) heap
# tie-breaks), gated by the engine parity suites and the
# incremental-vs-fresh fuzz/hypothesis tests.  Entries are keyed by the
# job's *admission slot* (the fast engine's arrays are slot-stable:
# rows never move, so slot order == arrival order == the reference
# list order the tie-breaks are defined over).
# --------------------------------------------------------------------------


class AllocDelta:
    """Sparse allocation result (fast-engine path only).

    ``w[k]`` is the new worker count for the job at admission slot
    ``slots[k]``; every live job not listed keeps its current
    allocation.  A policy returning a delta must list every slot whose
    correct target differs from the engine's current allocation;
    listing rows that did not change is fine (the engine compares and
    filters), listing a dead slot is not.
    """

    __slots__ = ("slots", "w")

    def __init__(self, slots: np.ndarray, w: np.ndarray):
        self.slots = slots
        self.w = w

    def __repr__(self) -> str:
        return f"AllocDelta({self.slots.tolist()}, {self.w.tolist()})"


_EMPTY_DELTA_ARR = np.empty(0, np.int64)


def _delta_empty() -> AllocDelta:
    return AllocDelta(_EMPTY_DELTA_ARR, _EMPTY_DELTA_ARR)


class IncrementalContext:
    """Cross-tick solver state for one fast-engine run.

    The engine owns one instance per ``simulate`` call and refreshes
    ``alive``/``prefix`` before every solve; policies keep their
    persistent structures (gain-heaps, remaining-time heaps, explore
    cursors) in ``store``.  ``alive[s]`` says whether admission slot
    ``s`` still holds a live job; ``prefix(k)`` returns the slots of
    the first ``k`` live jobs in arrival order (the FIFO candidate
    prefix every seeded solver grants from), maintained incrementally
    by the engine so a call is an O(1) slice.  ``scratch(n)`` hands out
    a reused int64 buffer for the few places that still materialize a
    dense target (placement mode, dense-policy compatibility) so no
    per-solve ``np.zeros(n)`` survives on the engine path.  The
    reference oracle never builds a context, so every policy falls back
    to its fresh dense solver there — which is exactly what the parity
    gates compare against.
    """

    __slots__ = ("alive", "prefix", "pref_version", "store", "_scratch",
                 "_ones", "tel")

    def __init__(self):
        self.alive: np.ndarray | None = None
        self.prefix: Callable[[int], np.ndarray] | None = None
        # bumped by the engine whenever prefix *membership* changes (an
        # append below the cap, or a prefix death + refill) — the memo
        # key for saturated all-ones answers
        self.pref_version = 0
        self.store: dict[str, object] = {}
        self._scratch = np.empty(0, np.int64)
        self._ones = np.empty(0, np.int64)
        # telemetry counter registry (``telemetry.Registry``) or None
        # when telemetry is off — solvers count heap ops only when set
        self.tel = None

    def scratch(self, n: int) -> np.ndarray:
        """A reused int64 buffer of length ``n`` (contents arbitrary)."""
        if len(self._scratch) < n:
            self._scratch = np.empty(
                max(n, 2 * len(self._scratch), 64), np.int64)
        return self._scratch[:n]

    def ones(self, n: int) -> np.ndarray:
        """A reused all-ones int64 buffer (saturated deltas; callers
        must treat it as read-only)."""
        if len(self._ones) < n:
            self._ones = np.ones(max(n, 2 * len(self._ones), 64),
                                 np.int64)
        return self._ones[:n]


class _StampedGainHeap:
    """Generation-stamped persistent base heap shared by the doubling and
    Optimus solvers.

    Holds one w=1 gain entry per candidate-prefix job (the first
    ``min(n_live, capacity)`` live jobs — the only jobs a FIFO-seeded
    solver can ever grant workers; a live job's rank among live jobs
    never grows, so prefix membership is monotone under the full cluster
    capacity).  An entry ``(-gain, slot, 1, stamp)`` stays valid while
    the job's remaining work is unchanged; when it changes (the job ran)
    the per-slot stamp is bumped and a fresh entry pushed, the old one
    discarded lazily at pop time.  Per-solve cost is O(dirty + heap
    copy) instead of a full O(prefix) rebuild — and under saturation
    (prefix == capacity) the solve short-circuits to all-ones without
    touching the heap at all.
    """

    __slots__ = ("last_q", "stamp", "base", "sat_key",
                 "_tel_src", "_c_push", "_c_pop", "_c_dirty", "_c_reb")

    def __init__(self):
        self.last_q = np.full(64, np.nan)
        self.stamp = np.zeros(64, np.int64)
        self.base: list[tuple[float, int, int, int]] = []
        # (pref_version, n1) memo of the last saturated all-ones delta
        # (see _SatCache for why it never needs clearing)
        self.sat_key: tuple[int, int] | None = None
        # telemetry counter handles, bound once per registry: the solve
        # path flushes with plain attribute bumps instead of dict lookups
        self._tel_src = None

    def _tel_bind(self, tel) -> None:
        self._tel_src = tel
        self._c_push = tel.counter("heap.pushes")
        self._c_pop = tel.counter("heap.pops")
        self._c_dirty = tel.counter("heap.dirty_rows")
        self._c_reb = tel.counter("heap.rebuilds")

    def _grow_to(self, m: int) -> None:
        self.last_q = _grow_array(self.last_q, m, np.nan)
        self.stamp = _grow_array(self.stamp, m, 0)

    def _refresh(self, state: "AllocView", P: np.ndarray) -> None:
        """Bring the base heap up to date with prefix slots ``P``.

        Jobs whose remaining work changed since their entry was stamped
        (NaN-seeded, so new arrivals are dirty by construction) get a
        fresh w=1 entry; stale ones die by stamp at pop time.  When most
        of the prefix is dirty anyway (a saturated cluster doubles every
        prefix job every tick) a from-scratch rebuild is cheaper than
        accumulating one stale entry per push — the valid entry set is
        identical either way, except that a rebuild drops entries for
        jobs currently *outside* the prefix (the exploratory dynamic
        pool shrinks and regrows), so those are NaN-marked to count as
        dirty when they re-enter."""
        n1 = len(P)
        self._grow_to(int(P[-1]) + 1)
        q = state.remaining[P]
        dirty = np.nonzero(self.last_q[P] != q)[0]
        if not len(dirty):
            return
        tel = state.inc.tel if state.inc is not None else None
        if tel is not None:
            if tel is not self._tel_src:
                self._tel_bind(tel)
            self._c_dirty.n += len(dirty)
        rebuild = 2 * len(dirty) >= n1
        if rebuild:
            dirty = np.arange(n1)
            dslots = P
        else:
            dslots = P[dirty]
        self.stamp[dslots] += 1
        self.last_q[dslots] = q[dirty]
        rows = dslots if state.rows is None else state.rows[dslots]
        # the same vectorized w=1 gain pass as the fresh solvers, over
        # the dirty slice only
        gains = _gains_w1(q[dirty], state.tables, rows)
        caps_d = state.max_w[dslots]
        if state.max_w_clamp is not None:
            caps_d = np.minimum(caps_d, state.max_w_clamp)
        caps_d = caps_d.tolist()
        stamps = self.stamp[dslots].tolist()
        if rebuild:
            outside = {e[1] for e in self.base}
            self.base = [(-g, s, 1, stm)
                         for g, s, mw, stm in zip(gains, dslots.tolist(),
                                                  caps_d, stamps)
                         if g > 0.0 and 2 <= mw]
            heapq.heapify(self.base)
            outside.difference_update(dslots.tolist())
            for s in outside:
                self.last_q[s] = np.nan
            if tel is not None:
                self._c_reb.n += 1
                self._c_push.n += len(self.base)
            return
        base = self.base
        n0 = len(base)
        for g, s, mw, stm in zip(gains, dslots.tolist(), caps_d, stamps):
            if g > 0.0 and 2 <= mw:
                heapq.heappush(base, (-g, s, 1, stm))
        if tel is not None:
            self._c_push.n += len(base) - n0

    def _maybe_compact(self, ctx: IncrementalContext, n1: int) -> None:
        if len(self.base) <= 4 * n1 + 64:
            return
        stamp, alive = self.stamp, ctx.alive
        self.base = [e for e in self.base
                     if stamp[e[1]] == e[3] and alive[e[1]]]
        heapq.heapify(self.base)


class _PersistentDoublingHeap(_StampedGainHeap):
    """Incremental/sparse mode of ``doubling_heuristic_soa``: returns an
    :class:`AllocDelta` over the candidate prefix (delta completeness:
    any live job holding workers sits in the prefix, so every row that
    can change is listed)."""

    def solve(self, state: "AllocView", capacity: int,
              ctx: IncrementalContext,
              prefix: np.ndarray | None = None) -> AllocDelta:
        if prefix is None:
            n1 = min(state.n_live, capacity)
            if n1 == 0:
                return _delta_empty()
            P = ctx.prefix(n1)
        else:
            P = prefix
            n1 = len(P)
            if n1 == 0:
                return _delta_empty()
        W = state.tables.shape[1] - 1
        if n1 >= capacity or W < 2:
            # saturation: the w=1 FIFO seeding already spends the whole
            # cluster, so no doubling is ever feasible (used + w >
            # capacity for every entry) — the fresh solver provably
            # returns all-ones and the heap never needs touching.  This
            # is the steady state of every backlogged trace, so it is
            # memoized: with prefix membership unchanged the engine
            # already holds the all-ones answer and the solve is O(1).
            # (Only on the direct path — a caller passing its own
            # prefix, exploratory's dynamic pool, zeroes last-winner
            # rows by whatever the delta *lists*, so it needs the full
            # listing every time.)
            if prefix is None:
                key = (ctx.pref_version, n1)
                if key == self.sat_key:
                    return _delta_empty()
                self.sat_key = key
            return AllocDelta(P, ctx.ones(n1))
        self._refresh(state, P)
        self._maybe_compact(ctx, n1)
        heap = self.base.copy()       # a copy of a heap is a heap
        n0 = len(heap)
        pops = 0
        used = n1
        stamp = self.stamp
        pos_in = {s: i for i, s in enumerate(P.tolist())}
        head = [1] * n1
        tables, rows = state.tables, state.rows
        rem, maxw = state.remaining, state.max_w
        clamp = state.max_w_clamp
        while heap:
            neg_g, s, w, stm = heapq.heappop(heap)
            pops += 1
            if stamp[s] != stm:
                continue              # job ran since this entry was pushed
            idx = pos_in.get(s)
            if idx is None:
                continue              # completed, or outside this prefix
            if head[idx] != w:
                continue              # stale: job already doubled past w
            if used + w > capacity:
                continue    # never feasible again (used only grows)
            used += w
            w2 = 2 * w
            head[idx] = w2
            mw = int(maxw[s])
            if clamp is not None and clamp < mw:
                mw = clamp
            if 2 * w2 <= mw and used + w2 <= capacity and 2 * w2 <= W:
                table = tables[s if rows is None else rows[s]]
                gq = float(rem[s])
                g = (gq / max(float(table[w2]), 1e-12)
                     - gq / max(float(table[2 * w2]), 1e-12)) / w2
                if g > 0.0:
                    heapq.heappush(heap, (-g, s, w2, stm))
        tel = ctx.tel
        if tel is not None:
            if tel is not self._tel_src:
                self._tel_bind(tel)
            self._c_pop.n += pops
            self._c_push.n += len(heap) + pops - n0
        return AllocDelta(P, np.array(head, np.int64))


class _PersistentOptimusHeap(_StampedGainHeap):
    """Incremental/sparse mode of ``optimus_greedy_soa`` (+1 steps)."""

    def solve(self, state: "AllocView", capacity: int,
              ctx: IncrementalContext) -> AllocDelta:
        n1 = min(state.n_live, capacity)
        if n1 == 0:
            return _delta_empty()
        P = ctx.prefix(n1)
        W = state.tables.shape[1] - 1
        if n1 >= capacity or W < 2:
            # saturation: `while used < capacity` never iterates — the
            # fresh solver provably returns all-ones (memoized like the
            # doubling heap's saturated branch)
            key = (ctx.pref_version, n1)
            if key == self.sat_key:
                return _delta_empty()
            self.sat_key = key
            return AllocDelta(P, ctx.ones(n1))
        self._refresh(state, P)
        self._maybe_compact(ctx, n1)
        heap = self.base.copy()
        n0 = len(heap)
        pops = 0
        used = n1
        stamp = self.stamp
        pos_in = {s: i for i, s in enumerate(P.tolist())}
        head = [1] * n1
        tables, rows = state.tables, state.rows
        rem, maxw = state.remaining, state.max_w
        clamp = state.max_w_clamp
        while used < capacity and heap:
            neg_g, s, w, stm = heapq.heappop(heap)
            pops += 1
            if stamp[s] != stm:
                continue
            idx = pos_in.get(s)
            if idx is None:
                continue
            if head[idx] != w:
                continue                               # stale entry
            w1 = w + 1
            head[idx] = w1
            used += 1
            mw = int(maxw[s])
            if clamp is not None and clamp < mw:
                mw = clamp
            if w1 + 1 <= mw and w1 + 1 <= W:
                table = tables[s if rows is None else rows[s]]
                gq = float(rem[s])
                g = (gq / max(float(table[w1]), 1e-12)
                     - gq / max(float(table[w1 + 1]), 1e-12))
                if g > 0.0:
                    heapq.heappush(heap, (-g, s, w1, stm))
        tel = ctx.tel
        if tel is not None:
            if tel is not self._tel_src:
                self._tel_bind(tel)
            self._c_pop.n += pops
            self._c_push.n += len(heap) + pops - n0
        return AllocDelta(P, np.array(head, np.int64))


class _PersistentSRTFHeap:
    """Cross-tick remaining-time order for SRTF.

    The fresh SRTF pass argsorts every active job's best-case remaining
    time at every reallocation — O(J log J) per tick, *the* dominant cost
    of 10k-job traces (thousands of queued jobs whose remaining work
    never changes between ticks re-sorted tens of thousands of times).
    Here the order lives in a persistent min-heap of ``(t_best, slot,
    stamp)`` entries: a job's entry stays valid while it sits in the
    queue (w=0 ⇒ remaining unchanged ⇒ t_best unchanged); only new
    arrivals are pushed.  Last tick's winners (the ≤capacity jobs that
    actually ran) never re-enter the heap at all: they are merged
    against the heap head as a sorted candidate list in the grant loop
    below, and only the losers among them are re-pushed.  Per-job
    ``(w*, f_best)`` is static — cached per interned (speed-table row,
    cap) pair rather than recomputed per job per tick.  A steady-state
    shortcut (winner order unchanged, no deaths, no competitive
    arrival) answers the ~60% of solves where nothing moves with an
    empty delta without touching the heap.

    The delta lists last tick's winners (zeroed unless re-granted) plus
    this tick's winners — SRTF can grant *any* live job, so completeness
    comes from the tracked winner set, not prefix monotonicity.
    """

    __slots__ = ("f_best", "w_star", "stamp", "caps", "heap", "winners",
                 "seen", "rowcache", "_prev_np", "_prev_fnp", "_cap_left",
                 "_prev_deaths", "_tel_src", "_c_push", "_c_pop")

    def __init__(self):
        # per-slot state as plain Python lists: every access is a scalar
        # read/write on the solve hot path, where list indexing beats
        # ndarray scalar boxing several-fold.  ``caps`` is the clamped
        # per-job worker cap, computed once at registration — ``max_w``
        # is per-job static and ``max_w_clamp`` is a constant of the
        # policy wrapper (largest node of a fixed topology), so it
        # cannot drift between solves of one engine run.
        self.f_best: list[float] = []
        self.w_star: list[int] = []
        self.stamp: list[int] = []
        self.caps: list[int] = []
        self.heap: list[tuple[float, int, int]] = []
        self.winners: list[int] = []         # slots granted w>0 last solve
        self.seen = 0                        # slots below this are known
        self.rowcache: dict[tuple[int, int], tuple[int, float]] = {}
        # winners' slots / clamped f_best as pop-ordered ndarrays for
        # the steady-state order check (one gather + tolist per solve),
        # and the capacity left over by the last full solve (nonzero
        # disables the deep-backlog arrival shortcut until a full solve
        # runs)
        self._prev_np = _EMPTY_DELTA_ARR
        self._prev_fnp = np.empty(0)
        # telemetry counter handles, bound once per registry (solve is
        # the hottest policy path: flushes are plain attribute bumps)
        self._tel_src = None
        self._c_push = None
        self._c_pop = None
        self._cap_left = 1
        # slot-space dead count (hi - n_live) at the last solve: if it
        # has not moved, no row was removed since, so every winner is
        # still alive without touching the alive array (admissions keep
        # the difference fixed — they bump hi and n_live together)
        self._prev_deaths = -1

    def _grow_to(self, m: int) -> None:
        pad = m - len(self.stamp)
        if pad > 0:
            self.f_best.extend([0.0] * pad)
            self.w_star.extend([0] * pad)
            self.stamp.extend([0] * pad)
            self.caps.extend([0] * pad)

    def _cap_of(self, state: "AllocView", s: int, W: int) -> int:
        cap_i = int(state.max_w[s])
        clamp = state.max_w_clamp
        if clamp is not None and clamp < cap_i:
            cap_i = clamp
        return cap_i if cap_i < W else W

    def _best(self, state: "AllocView", s: int, W: int) -> tuple[int, float]:
        """(w*, f_best) for slot ``s``: the speed-maximizing feasible
        worker count — same argmax/tie semantics as the fresh masked
        pass, cached per (interned row, cap)."""
        cap_i = self._cap_of(state, s, W)
        row = s if state.rows is None else int(state.rows[s])
        key = (row, cap_i)
        got = self.rowcache.get(key)
        if got is None:
            tab = state.tables[row]
            w_star = int(np.argmax(tab[1:cap_i + 1])) + 1
            got = (w_star, float(tab[w_star]))
            self.rowcache[key] = got
        return got

    def solve(self, state: "AllocView", capacity: int,
              ctx: IncrementalContext) -> AllocDelta:
        alive = ctx.alive
        prev = self.winners
        W = state.tables.shape[1] - 1
        rem = state.remaining
        if state.n_live == 0 or W < 1:
            self.winners = []
            self._prev_np = _EMPTY_DELTA_ARR
            pa = [s for s in prev if alive[s]]
            if not pa:
                return _delta_empty()
            return AllocDelta(np.array(pa, np.int64),
                              np.zeros(len(pa), np.int64))
        # steady-state shortcut: no admissions since the last solve and
        # every winner still alive means only the winners' remaining
        # work moved — and only downward, so each winner still precedes
        # every queued entry it beat last time.  If the winners' (t,
        # slot) order is also unchanged, a fresh solve would pop the
        # same slots in the same order against the same capacity
        # sequence and grant the same workers: the engine's held
        # allocation is already the answer.  (One gather + ``tolist``,
        # then plain-float compares: this check runs on every solve.)
        steady = False
        t_last = 0.0
        if prev and state.hi - state.n_live == self._prev_deaths:
            # no removal since the last solve (the death count is exact:
            # only running jobs — winners — ever complete), so every
            # winner is alive; only the (t, slot) order needs checking
            tl = (rem.take(self._prev_np) / self._prev_fnp).tolist()
            t_pv = -math.inf
            s_pv = -1
            for i, tv in enumerate(tl):
                s = prev[i]
                if tv < t_pv or (tv == t_pv and s < s_pv):
                    break
                t_pv = tv
                s_pv = s
            else:
                steady = True
                t_last = t_pv
        if steady and self.seen >= state.hi:
            return _delta_empty()
        heap = self.heap
        tel = ctx.tel
        if tel is not None and tel is not self._tel_src:
            self._tel_src = tel
            self._c_push = tel.counter("heap.pushes")
            self._c_pop = tel.counter("heap.pops")
        n_push = 0
        n_pop = 0
        # a new arrival can only change the outcome if it beats the last
        # winner (new slots sort after every winner slot on ties) —
        # *and* there was no spare capacity it could claim outright
        new_lose = steady and self._cap_left == 0
        # register new arrivals (slots [seen, hi) — admitted since the
        # last solve; a slot that already died again is skipped for good)
        if self.seen < state.hi:
            self._grow_to(state.hi)
            caps_l = self.caps
            for s in range(self.seen, state.hi):
                if not alive[s]:
                    continue
                caps_l[s] = self._cap_of(state, s, W)
                w_star, f = self._best(state, s, W)
                self.w_star[s] = w_star
                # stored pre-clamped: every consumer divides by
                # max(f, 1e-12), so clamp once at registration
                fcl = max(f, 1e-12)
                self.f_best[s] = fcl
                stm = self.stamp[s] + 1
                self.stamp[s] = stm
                tb = float(rem[s]) / fcl
                if tb < t_last:
                    new_lose = False
                heapq.heappush(heap, (tb, s, stm))
                n_push += 1
            self.seen = state.hi
        if new_lose:
            # deep-backlog arrival: every new job sorts behind the
            # still-valid winner sequence and the cluster was already
            # spent — the fresh pop order is provably unchanged
            if tel is not None and n_push:
                self._c_push.n += n_push
            return _delta_empty()
        # Last tick's winners never sit in the big heap between solves —
        # re-pushing and re-popping them every solve costs ~2 log n heap
        # ops each, where a sorted candidate list merged against the
        # heap head costs none.  Their heap entries were consumed when
        # they were first granted (popped) and they are re-pushed only
        # if the grant loop below never reaches them, so for every
        # winner slot no live heap entry exists and the merge never
        # compares a slot against itself.
        stamp = self.stamp
        f_best = self.f_best
        caps_l = self.caps
        w_star_l = self.w_star
        cands = [(float(rem[s]) / f_best[s], s) for s in prev if alive[s]]
        cands.sort()
        nc = len(cands)
        ci = 0
        cap = capacity
        winners: list[int] = []
        ws: list[int] = []
        tables, rows = state.tables, state.rows
        while cap > 0:
            # valid heap head (lazy skip of dead / re-stamped entries)
            while heap:
                th, sh, stm = heap[0]
                if stamp[sh] == stm and alive[sh]:
                    break
                heapq.heappop(heap)
                n_pop += 1
            if ci < nc:
                tc, sc = cands[ci]
                if heap and (th < tc or (th == tc and sh < sc)):
                    s = sh
                    heapq.heappop(heap)
                    n_pop += 1
                else:
                    s = sc
                    ci += 1
            elif heap:
                s = sh
                heapq.heappop(heap)
                n_pop += 1
            else:
                break
            cap_i = caps_l[s]
            hi = cap_i if cap_i < cap else cap
            w = w_star_l[s]
            if w > hi:      # clipped by remaining capacity: re-derive
                row = s if rows is None else int(rows[s])
                w = int(np.argmax(tables[row, 1:hi + 1])) + 1
            winners.append(s)
            ws.append(w)
            cap -= w
        # candidates the grant loop never reached rejoin the queue with
        # their refreshed t — exactly the state a re-pushed-but-unpopped
        # entry would have held
        for j in range(ci, nc):
            tc, sc = cands[j]
            stm = stamp[sc] + 1
            stamp[sc] = stm
            heapq.heappush(heap, (tc, sc, stm))
            n_push += 1
        if tel is not None:
            if n_push:
                self._c_push.n += n_push
            if n_pop:
                self._c_pop.n += n_pop
        self.winners = winners
        fb = self.f_best
        self._prev_np = np.fromiter(winners, np.int64, len(winners))
        self._prev_fnp = np.array([fb[s] for s in winners])
        self._cap_left = cap
        self._prev_deaths = state.hi - state.n_live
        if len(heap) > 2 * state.n_live + 1024:
            self.heap = [e for e in heap
                         if stamp[e[1]] == e[2] and alive[e[1]]]
            heapq.heapify(self.heap)
        d = {s: 0 for s in prev if alive[s]}
        for s, w in zip(winners, ws):
            d[s] = w
        if not d:
            return _delta_empty()
        return AllocDelta(np.fromiter(d.keys(), np.int64, len(d)),
                          np.fromiter(d.values(), np.int64, len(d)))


def optimus_greedy_table(jobs: Sequence[TableJobTuple], capacity: int,
                         max_w: int | None = None) -> Alloc:
    """Optimus [8] over precomputed speed tables, with a lazy max-heap."""
    jobs = list(jobs)
    alloc: Alloc = {}
    used = 0
    heap: list[tuple[float, int, int]] = []   # (-gain, input index, w)

    def entry(idx: int, Q: float, table, w: int):
        """Heap entry for the +1 gain at w, or None if never selectable."""
        if max_w is not None and w + 1 > max_w:
            return None
        if w + 1 >= len(table):
            return None    # beyond the table bound => capacity-infeasible
        g = Q / max(table[w], 1e-12) - Q / max(table[w + 1], 1e-12)
        return (-g, idx, w) if g > 0.0 else None

    for idx, (jid, Q, table) in enumerate(jobs):
        if used < capacity:
            alloc[jid] = 1
            used += 1
            e = entry(idx, Q, table, 1)
            if e is not None:
                heap.append(e)
        else:
            alloc[jid] = 0
    heapq.heapify(heap)
    while used < capacity and heap:
        neg_g, idx, w = heapq.heappop(heap)
        jid, Q, table = jobs[idx]
        if alloc[jid] != w:
            continue                                   # stale entry
        alloc[jid] = w + 1
        used += 1
        e = entry(idx, Q, table, w + 1)
        if e is not None:
            heapq.heappush(heap, e)
    return alloc


def exact_dp_table(jobs: Sequence[TableJobTuple], capacity: int,
                   max_w: int | None = None,
                   powers_of_two: bool = False) -> Alloc:
    """Exact minimizer of Σ Q_j / f_j(w_j) by DP over capacity, from tables.

    Same DP (and identical tie-breaking) as the callable version; per-job
    costs Q/f(w) are precomputed once per job instead of re-evaluating the
    speed model in the O(J * C * W) inner loop.
    """
    jobs = list(jobs)
    J = len(jobs)
    wmax = min(max_w or capacity, capacity)
    choices = ([2 ** k for k in range(int(math.log2(wmax)) + 1)]
               if powers_of_two else list(range(1, wmax + 1)))
    assert J <= capacity, "exact_dp assumes every job can get >=1 worker (Z+)"
    dp = {0: (0.0, ())}
    for (jid, Q, table) in jobs:
        costs = [Q / max(table[w], 1e-12) for w in choices]
        ndp: dict[int, tuple[float, tuple]] = {}
        for c, (cost, chosen) in dp.items():
            for w, t in zip(choices, costs):
                nc = c + w
                if nc > capacity:
                    continue
                cand = (cost + t, chosen + (w,))
                if nc not in ndp or cand[0] < ndp[nc][0]:
                    ndp[nc] = cand
        dp = ndp
    best_cost, best_alloc = min(dp.values(), key=lambda kv: kv[0])
    return {jid: w for (jid, _, _), w in zip(jobs, best_alloc)}


# --------------------------------------------------------------------------
# Callable-based API: thin adapters over the table solvers.
# --------------------------------------------------------------------------

def doubling_heuristic(jobs: Sequence[JobTuple], capacity: int,
                       max_w=None) -> Alloc:
    bound = _table_bound(capacity, max_w)
    tjobs = [(jid, Q, _sample_table(f, bound)) for (jid, Q, f) in jobs]
    return doubling_heuristic_table(tjobs, capacity, max_w)


def optimus_greedy(jobs: Sequence[JobTuple], capacity: int,
                   max_w: int | None = None) -> Alloc:
    bound = _table_bound(capacity, max_w)
    tjobs = [(jid, Q, _sample_table(f, bound)) for (jid, Q, f) in jobs]
    return optimus_greedy_table(tjobs, capacity, max_w)


def exact_dp(jobs: Sequence[JobTuple], capacity: int,
             max_w: int | None = None, powers_of_two: bool = False) -> Alloc:
    # the DP normalizes with `max_w or capacity` (0 means unbounded, seed
    # semantics), so the sampled table must use the same bound
    bound = min(max_w or capacity, capacity)
    tjobs = [(jid, Q, _sample_table(f, bound)) for (jid, Q, f) in jobs]
    return exact_dp_table(tjobs, capacity, max_w, powers_of_two)


def fixed(jobs: Sequence[JobTuple], capacity: int, w_fixed: int) -> Alloc:
    """Every job requests w_fixed GPUs, granted FIFO while capacity lasts."""
    alloc: Alloc = {}
    used = 0
    for (jid, _, _) in jobs:
        w = min(w_fixed, capacity - used)
        w = w if w == w_fixed else 0    # all-or-nothing gang allocation
        alloc[jid] = w
        used += w
    return alloc


def total_time(jobs: Sequence[JobTuple], alloc: Alloc) -> float:
    tot = 0.0
    for (jid, Q, f) in jobs:
        w = alloc.get(jid, 0)
        if w > 0:
            tot += Q / max(f(w), 1e-12)
    return tot


# --------------------------------------------------------------------------
# Scheduling-policy registry.
#
# A policy is the cluster-level strategy Table 3 sweeps: given the active
# set (as SoA views — the representation both simulator engines share) and
# the ClusterModel, produce a worker-count target per job.  Policies are
# constructed exclusively through ``get_policy("spec")`` so every consumer
# (simulator engines, run_table3, benchmarks, tests) resolves strategy
# strings in exactly one place, with validation instead of str.split
# crashes deep in the event loop.
# --------------------------------------------------------------------------

# §7 simulation constants the exploratory policy and both engines share.
EXPLORE_SEGMENT = 150.0      # 2.5 minutes at each of 1, 2, 4, 8 (§7)
EXPLORE_WS = (1, 2, 4, 8)
RESCHEDULE_EVERY = 150.0     # == EXPLORE_SEGMENT (segment switches land
                             # exactly on reschedule ticks — load-bearing)


@dataclasses.dataclass
class AllocView:
    """Structure-of-arrays view of the active set.

    Two shapes, one field set:

    * **Dense** (``live is None`` — the reference oracle, ad-hoc callers,
      and non-``slotted`` policies): arrays hold exactly the active set
      in reference-list order (arrival order with in-place removals —
      the order is load-bearing for solver tie-breaks, FIFO fixed grants
      and explore-gang grants), and ``allocate`` returns a dense int64
      target aligned with them.
    * **Slotted** (``live`` is a bool array — the fast engine's view for
      ``slotted`` policies): every array is the engine's full
      admission-slot-indexed backing store.  Slots never move; dead
      slots keep stale values and are excluded by ``live``/``lo``/
      ``hi``/``n_live``.  Slot order *is* arrival order, so tie-breaks
      carry over unchanged.  ``allocate`` returns an
      :class:`AllocDelta` over absolute slots instead of a dense
      target.

    ``tables`` may be wider than the active set (the simulator's
    preallocated matrix); row ``rows[i]`` — or row i when ``rows`` is
    None — is job/slot i's speed table.
    """
    remaining: np.ndarray                # (n,) remaining work (epochs)
    tables: np.ndarray                   # 2-D speed-table matrix
    max_w: np.ndarray                    # (n,) per-job scale-out caps
    explore_started: np.ndarray          # (n,) explore-phase start, -inf
                                         # when the job never profiles
    rows: np.ndarray | None = None       # job i's row in `tables`
    # node-level snapshot (repro_torch.core.placement.PlacementView) when the
    # cluster runs a placement engine; None on flat/legacy clusters
    placement: object | None = None
    # --- slotted-mode fields (fast engine only) ---
    live: np.ndarray | None = None       # bool per slot; None = dense mode
    lo: int = 0                          # first possibly-live slot
    hi: int = 0                          # one past the last admitted slot
    n_live: int = 0                      # number of live slots
    # pack wrapper's node-size cap on the slotted path: applied by the
    # solvers at point of use instead of materializing an O(n) clamped
    # copy of ``max_w``
    max_w_clamp: int | None = None
    # cross-tick solver state (fast engine only; None from the reference
    # oracle and ad-hoc callers, which makes every policy take its fresh
    # dense path — the identity baseline the parity gates compare
    # against)
    inc: IncrementalContext | None = None

    @property
    def n(self) -> int:
        return len(self.remaining)

    def row_of(self, i: int) -> np.ndarray:
        return self.tables[i if self.rows is None else self.rows[i]]


class SchedulingPolicy:
    """One cluster scheduling strategy.

    Subclasses set ``spec`` (the canonical string, e.g. ``"fixed_8"``) and
    implement :meth:`allocate`.  ``static`` declares that the target
    depends only on the active set's identity/order (not on remaining
    work), which lets the fast engine reuse a solve across pure reschedule
    ticks; ``explores`` makes the simulator stamp newly admitted jobs with
    an explore-phase start time.  ``slotted`` opts into the fast engine's
    slot-indexed views and the sparse :class:`AllocDelta` return contract
    (see :class:`AllocView`); policies that leave it False always receive
    dense views — the engine materializes them — so the ≤20-line
    dense-target recipe keeps working unmodified at any scale the dense
    gather can afford.
    """

    spec: str = "?"
    static: bool = False
    explores: bool = False
    slotted: bool = False

    def allocate(self, state: AllocView, cluster: ClusterModel,
                 now: float):
        """Dense views: return int64 worker counts aligned with
        ``state`` order.  Slotted views: return an :class:`AllocDelta`
        covering every slot whose target differs from the engine's
        current allocation."""
        raise NotImplementedError

    def validate(self, cluster: ClusterModel) -> None:
        """Reject cluster/policy combinations that can never make progress
        (called once by ``simulate`` before the event loop starts)."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


@dataclasses.dataclass(frozen=True)
class _PolicyEntry:
    factory: Callable[[str | None], SchedulingPolicy]
    example: str            # a runnable spec, e.g. "fixed_8" for "fixed"


_POLICY_REGISTRY: dict[str, _PolicyEntry] = {}


def register_policy(name: str,
                    factory: Callable[[str | None], SchedulingPolicy],
                    example: str | None = None) -> None:
    """Register a policy under ``name``.

    ``factory(param)`` receives the parameter suffix of the spec string
    (``"8"`` for ``"fixed_8"``, None for a bare name) and must validate
    it.  ``example`` is a runnable spec for registry-wide parity gates
    (defaults to ``name`` — required for parameterized policies whose
    bare name is not runnable).
    """
    if name in _POLICY_REGISTRY:
        raise ValueError(f"policy {name!r} already registered")
    _POLICY_REGISTRY[name] = _PolicyEntry(factory, example or name)


def registered_policies() -> dict[str, str]:
    """``{name: runnable example spec}`` for every registered policy —
    the iteration surface for the CI parity gate and the docs."""
    return {n: e.example for n, e in sorted(_POLICY_REGISTRY.items())}


def get_policy(spec: str | SchedulingPolicy) -> SchedulingPolicy:
    """Resolve a strategy spec string into a policy instance.

    Exact registry names win (``"utility_greedy"``); otherwise the part
    after the last underscore is the policy parameter (``"fixed_8"`` ->
    ``fixed`` with k=8).  Malformed specs fail here, loudly, instead of
    dying inside ``str.split``/``int()`` deep in the engine.
    """
    if isinstance(spec, SchedulingPolicy):
        return spec
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"policy spec must be a non-empty string, "
                         f"got {spec!r}")
    base, param = _split_spec(_POLICY_REGISTRY, spec)
    entry = _POLICY_REGISTRY.get(base)
    if entry is None:
        raise ValueError(
            f"unknown scheduling policy {spec!r}; registered: "
            f"{', '.join(sorted(_POLICY_REGISTRY))}")
    return entry.factory(param)


def _split_spec(registry, spec: str) -> tuple[str, str | None]:
    """Longest registered prefix at an underscore boundary wins, so a
    name parameterized by another spec ("pack_utility_greedy" -> pack
    with param "utility_greedy") parses as well as "fixed_8".  Shared by
    the policy and admission-rule registries."""
    base, param = spec, None
    while base not in registry and "_" in base:
        base, tail = base.rsplit("_", 1)
        param = tail if param is None else f"{tail}_{param}"
    return base, param


def _no_param(name: str, param: str | None, noun: str = "policy") -> None:
    if param is not None:
        raise ValueError(f"{noun} {name!r} takes no parameter, "
                         f"got {name}_{param}")


def _int_param(name: str, param: str | None, example: str,
               noun: str = "policy") -> int:
    if param is None:
        raise ValueError(f"{noun} {name!r} needs an integer parameter, "
                         f"e.g. {example!r}")
    try:
        value = int(param)
    except ValueError:
        raise ValueError(f"{noun} parameter must be an integer, got "
                         f"{name}_{param}") from None
    if value < 1:
        raise ValueError(f"{noun} parameter must be >= 1, got "
                         f"{name}_{param}")
    return value


def _persistent(state: AllocView, key: str, cls):
    """The policy's persistent solver state for this engine run, or None
    when the view is dense (reference oracle, ad-hoc views) and the
    fresh solver must run instead."""
    if state.live is None or state.inc is None:
        return None
    store = state.inc.store
    inst = store.get(key)
    if inst is None:
        inst = store[key] = cls()
    return inst


class _SatCache:
    """Per-run saturation memo: the ``(pref_version, n1)`` of the last
    all-ones (or all-k) delta the engine already applied.  While the key
    is unchanged the prefix membership is unchanged, so the saturated
    answer is already the engine's held allocation and the solve is an
    empty delta.  Leaving saturation always bumps the version (it takes
    a completion, and runners live in the prefix), so a stale hit across
    a saturation gap is impossible and the memo never needs clearing."""

    __slots__ = ("key",)

    def __init__(self):
        self.key: tuple[int, int] | None = None


class DoublingPolicy(SchedulingPolicy):
    """``precompute`` (§7): resource models known up front, the §4.2
    doubling heuristic over the whole active set at every reallocation.
    Under the fast engine the solve is incremental — a persistent
    generation-stamped gain-heap carried across ticks, returning a
    sparse delta over the candidate prefix."""

    spec = "precompute"
    slotted = True

    def allocate(self, state, cluster, now):
        inc = _persistent(state, "doubling", _PersistentDoublingHeap)
        if inc is not None:
            return inc.solve(state, cluster.capacity, state.inc)
        return doubling_heuristic_soa(state.remaining, state.tables,
                                      cluster.capacity, max_w=state.max_w,
                                      rows=state.rows)


class _ExploreInc:
    """Persistent explorer/dynamic split for ``exploratory``.

    ``explore_started`` is stamped at admission, so it is non-decreasing
    over admission slots, and a job stops exploring for good once its
    last segment elapses — together the explorer set is a suffix of the
    slot space with a monotone left edge.  ``cursor`` (first slot still
    exploring) only ever moves right, so maintaining the split costs
    O(arrivals) over a whole run instead of two fresh O(n) masks per
    solve; the dynamic pool reuses one persistent doubling heap.
    """

    __slots__ = ("cursor", "winners", "heap")

    def __init__(self):
        self.cursor = 0
        self.winners: list[int] = []       # slots granted w>0 last solve
        self.heap = _PersistentDoublingHeap()


class ExploratoryPolicy(SchedulingPolicy):
    """``exploratory`` (§7): a new job spends 2.5 min at each of
    w = 1, 2, 4, 8 to collect the (w, f(w)) points eq. 5 needs, inside a
    gang reservation of min(8, remaining capacity); everyone else shares
    what is left through the doubling heuristic."""

    spec = "exploratory"
    explores = True
    slotted = True

    def allocate(self, state, cluster, now):
        if state.live is not None:
            return self._allocate_slotted(state, cluster, now)
        n = state.n
        cap = cluster.capacity
        target = np.zeros(n, np.int64)
        # -inf marks never-profiling jobs; keep them out of the floor
        # divide (inf // x is nan + a RuntimeWarning)
        profiling = np.isfinite(state.explore_started)
        seg = np.full(n, np.inf)
        if profiling.any():
            seg[profiling] = ((now - state.explore_started[profiling])
                              // EXPLORE_SEGMENT)
        explorer = seg < len(EXPLORE_WS)
        for i in np.nonzero(explorer)[0]:
            grant = min(8, cap)
            target[i] = min(EXPLORE_WS[int(seg[i])], grant)
            cap -= grant
        assert cap >= 0, "explore gang grants exceeded cluster capacity"
        dyn = np.nonzero(~explorer)[0]
        rows = dyn if state.rows is None else state.rows[dyn]
        target[dyn] = doubling_heuristic_soa(
            state.remaining[dyn], state.tables, cap,
            max_w=state.max_w[dyn], rows=rows)
        return target

    def _allocate_slotted(self, state, cluster, now):
        es = _persistent(state, "exploratory", _ExploreInc)
        started = state.explore_started
        alive = state.inc.alive
        hi = state.hi
        n_seg = len(EXPLORE_WS)
        cur = max(es.cursor, state.lo)
        # advance past slots done exploring — (now - t0) // 150 only
        # grows, so a slot walked past never explores again; -inf-stamped
        # slots (never profiled) are skipped the same way
        while cur < hi:
            t0 = float(started[cur])
            if math.isfinite(t0) and (now - t0) // EXPLORE_SEGMENT < n_seg:
                break
            cur += 1
        es.cursor = cur
        cap = cluster.capacity
        pairs_s: list[int] = []
        pairs_w: list[int] = []
        if cur < hi:
            E = np.nonzero(alive[cur:hi])[0] + cur
            # the cursor walk relies on admission-stamped (monotone)
            # explore starts; live slots past it are all mid-explore
            assert np.isfinite(started[E]).all(), (
                "slotted exploratory requires every admitted job "
                "explore-stamped (explores=True engine contract)")
            seg = ((now - started[E]) // EXPLORE_SEGMENT).astype(np.int64)
            for sg in seg.tolist():
                grant = min(8, cap)
                pairs_w.append(min(EXPLORE_WS[sg], grant))
                cap -= grant
            pairs_s = E.tolist()
            assert cap >= 0, "explore gang grants exceeded cluster capacity"
        n1 = min(state.n_live - len(pairs_s), cap)
        d = {s: 0 for s in es.winners if alive[s]}
        d.update(zip(pairs_s, pairs_w))
        winners = [s for s, w in zip(pairs_s, pairs_w) if w > 0]
        if n1 > 0:
            # every live non-explorer sits below the cursor, so the
            # global live prefix *is* the dynamic-pool prefix
            dd = es.heap.solve(state, cap, state.inc,
                               prefix=state.inc.prefix(n1))
            d.update(zip(dd.slots.tolist(), dd.w.tolist()))
            winners.extend(dd.slots.tolist())
        es.winners = winners
        if not d:
            return _delta_empty()
        return AllocDelta(np.fromiter(d.keys(), np.int64, len(d)),
                          np.fromiter(d.values(), np.int64, len(d)))


class FixedPolicy(SchedulingPolicy):
    """``fixed_k`` (§7 baselines): every job requests a constant gang of
    k workers, granted all-or-nothing FIFO while capacity lasts."""

    static = True
    slotted = True

    def __init__(self, k: int):
        self.k = k
        self.spec = f"fixed_{k}"

    def allocate(self, state, cluster, now):
        if state.live is not None:
            # the gang count capacity // k is constant, so a winner's
            # live rank only falls — every row that can change is in the
            # current prefix
            m = min(state.n_live, cluster.capacity // self.k)
            if m == 0:
                return _delta_empty()
            # the all-k answer is memoized on prefix membership (the
            # first m live slots): unchanged key == already applied
            sat = _persistent(state, "fixed_sat", _SatCache)
            key = (state.inc.pref_version, m)
            if key == sat.key:
                return _delta_empty()
            sat.key = key
            return AllocDelta(state.inc.prefix(m),
                              np.full(m, self.k, np.int64))
        return fixed_soa(state.n, cluster.capacity, self.k)

    def validate(self, cluster):
        if self.k > cluster.capacity:
            raise ValueError(
                f"{self.spec!r} can never run a job on a "
                f"{cluster.capacity}-GPU cluster (gang size must be in "
                f"[1, capacity])")


class SRTFPolicy(SchedulingPolicy):
    """Shortest-remaining-time-first: jobs ranked by their best-case
    remaining service time (Q / max_w f(w)); each, in that order, gets its
    speed-maximizing feasible worker count until capacity runs out.

    The classic size-based discipline the doubling heuristic implicitly
    approximates under contention — here as an explicit policy so the two
    can be compared head-to-head on heavy-tailed workloads.
    """

    spec = "srtf"
    slotted = True

    def allocate(self, state, cluster, now):
        inc = _persistent(state, "srtf", _PersistentSRTFHeap)
        if inc is not None:
            return inc.solve(state, cluster.capacity, state.inc)
        n = state.n
        cap = cluster.capacity
        target = np.zeros(n, np.int64)
        W = state.tables.shape[1] - 1
        # ranking pass, vectorized (this policy is non-static, so allocate
        # re-runs at every event — a per-job Python loop here would be the
        # slowest path in the engine on 1000-job traces).  Slicing to the
        # fleet-wide cap (max_w is 8..16 vs a 64-wide table) and avoiding
        # the fancy-index row copy cut the 1000-job trace from ~1.0 s to
        # ~0.5 s; the speed-argmax is precomputed per job and only
        # re-derived in the loop when the remaining capacity clips it
        # (clipping drops trailing columns only, so ties still resolve to
        # the same, earliest, w).
        tabs = (state.tables[:n] if state.rows is None
                else state.tables[state.rows])
        caps = np.minimum(state.max_w, W)
        wcap = min(int(caps.max()), W) if n else 0
        if wcap < 1:
            return target
        masked = np.where(np.arange(1, wcap + 1)[None, :] <= caps[:, None],
                          tabs[:, 1:wcap + 1], 0.0)
        w_star = np.argmax(masked, axis=1) + 1
        f_best = masked[np.arange(n), w_star - 1]
        t_best = state.remaining / np.maximum(f_best, 1e-12)
        w_star = w_star.tolist()
        # stable sort: FIFO order breaks remaining-time ties
        for i in np.argsort(t_best, kind="stable").tolist():
            if cap <= 0:
                break
            hi = min(int(caps[i]), cap)
            if hi < 1:
                continue
            w = w_star[i]
            if w > hi:      # clipped by remaining capacity: re-derive
                w = int(np.argmax(tabs[i, 1:hi + 1])) + 1
            target[i] = w
            cap -= w
        return target


class UtilityGreedyPolicy(SchedulingPolicy):
    """GADGET-style utility greedy (arXiv 2202.01158): grow the job whose
    next ring-doubling adds the most cluster *throughput* per GPU.

    Start everyone at w=1 (FIFO), then repeatedly double the job with the
    best marginal utility (f(2w) - f(w)) / w.  Unlike the paper's
    ``precompute`` gain (eq. 6), the utility is Q-independent — the policy
    maximizes aggregate epochs/sec rather than total completion time, so
    it is blind to job sizes (and ``static``: a pure reschedule tick with
    an unchanged active set reuses the previous solve).
    """

    spec = "utility_greedy"
    static = True
    slotted = True

    def allocate(self, state, cluster, now):
        capacity = cluster.capacity
        slotted = state.live is not None
        if slotted:
            n1 = min(state.n_live, capacity)
            if n1 == 0:
                return _delta_empty()
            if n1 >= capacity:
                # saturation: the FIFO w=1 seeding spends the cluster,
                # no double ever fits — all-ones without heap work,
                # memoized on prefix membership (see _SatCache)
                sat = _persistent(state, "utility_sat", _SatCache)
                key = (state.inc.pref_version, n1)
                if key == sat.key:
                    return _delta_empty()
                sat.key = key
                return AllocDelta(state.inc.prefix(n1),
                                  state.inc.ones(n1))
            P = state.inc.prefix(n1)
            slots = P.tolist()
            caps = state.max_w[P]
            if state.max_w_clamp is not None:
                caps = np.minimum(caps, state.max_w_clamp)
            caps = caps.tolist()
        else:
            n = state.n
            n1 = min(n, capacity)
            out = np.zeros(n, dtype=np.int64)
            if n1 == 0:
                return out
            # only the FIFO w=1 prefix can ever be granted workers: keep
            # the per-job Python materialization to that prefix (10k-job
            # traces queue thousands of jobs behind it)
            slots = list(range(n1))
            caps = state.max_w[:n1].tolist()
        head = [1] * n1
        used = n1
        W = state.tables.shape[1] - 1
        heap: list[tuple[float, int, int]] = []
        for i in range(n1):
            if 2 <= min(caps[i], W):
                table = state.row_of(slots[i])
                g = float(table[2]) - float(table[1])
                if g > 0.0:
                    heap.append((-g, i, 1))
        heapq.heapify(heap)
        n_push = len(heap)
        n_pop = 0
        while heap:
            neg_g, idx, w = heapq.heappop(heap)
            n_pop += 1
            if head[idx] != w:
                continue                  # stale: job already doubled past w
            if used + w > capacity:
                continue                  # never feasible again -> discard
            used += w
            w2 = 2 * w
            head[idx] = w2
            if 2 * w2 <= min(caps[idx], W) and used + w2 <= capacity:
                table = state.row_of(slots[idx])
                g = (float(table[2 * w2]) - float(table[w2])) / w2
                if g > 0.0:
                    heapq.heappush(heap, (-g, idx, w2))
                    n_push += 1
        tel = state.inc.tel if state.inc is not None else None
        if tel is not None:
            tel.counter("heap.pushes").inc(n_push)
            tel.counter("heap.pops").inc(n_pop)
        if slotted:
            return AllocDelta(P, np.array(head, np.int64))
        out[:n1] = head
        return out


class OptimusPolicy(SchedulingPolicy):
    """``optimus``: the Optimus [8] +1-greedy baseline as a cluster
    policy — grow the job whose next *single* worker buys the most
    completion-time reduction.  The §4.2 motivation's head-to-head rival
    (+1 greedy stalls at the power-of-two cliff where doubling steps
    over it); under the fast engine it shares the persistent
    gain-heap machinery with ``precompute``."""

    spec = "optimus"
    slotted = True

    def allocate(self, state, cluster, now):
        inc = _persistent(state, "optimus", _PersistentOptimusHeap)
        if inc is not None:
            return inc.solve(state, cluster.capacity, state.inc)
        return optimus_greedy_soa(state.remaining, state.tables,
                                  cluster.capacity, max_w=state.max_w,
                                  rows=state.rows)


class PackPolicy(SchedulingPolicy):
    """Placement-aware wrapper (``pack_<policy>``): clamp every job's
    scale-out cap to the largest node, so gangs never span the slow
    inter-node fabric — the ≤20-line recipe for making any registered
    policy topology-aware (the inner policy sees flat speed tables under
    a placement engine and would otherwise overestimate spanning rings).
    """

    def __init__(self, inner: SchedulingPolicy):
        self.inner = inner
        self.spec = f"pack_{inner.spec}"
        self.static = inner.static
        self.explores = inner.explores
        self.slotted = inner.slotted

    def allocate(self, state, cluster, now):
        node_cap = max(n.gpus for n in cluster.node_specs())
        if state.live is not None:
            # slotted: a scalar clamp the solvers apply at point of use
            # — no O(n) copy of the slot-wide max_w array per solve
            clamp = (node_cap if state.max_w_clamp is None
                     else min(state.max_w_clamp, node_cap))
            clamped = dataclasses.replace(state, max_w_clamp=clamp)
        else:
            clamped = dataclasses.replace(
                state, max_w=np.minimum(state.max_w, node_cap))
        return self.inner.allocate(clamped, cluster, now)

    def validate(self, cluster):
        self.inner.validate(cluster)


class RecoveryAwarePolicy(SchedulingPolicy):
    """``recovery_aware``: SRTF ranking with fault-aware grants.

    Two changes against blind srtf, both read off the PlacementView's
    node-health snapshot (fault injection, ``repro_torch.core.faults``):

      * the total grant budget is the *surviving* (ok, non-draining)
        capacity, not the nameplate — grants the placement engine would
        clamp to dead nodes only churn restart freezes;
      * every gang is clamped to the largest healthy full-speed node, so
        gangs stay single-node: a node failure kills at most the gangs
        actually on it instead of every ring spanning it, and straggling
        (degraded) nodes are not sized into.

    Off-placement there is no node snapshot and the policy degrades to
    plain srtf ranking; on a fault-free placement cluster it packs like
    ``pack_srtf`` (largest-node clamp, no health mask).
    """

    spec = "recovery_aware"

    def allocate(self, state, cluster, now):
        if state.live is not None:
            # dense policy on a slotted view (ad-hoc callers, the
            # delta-vs-dense harness — the engines always hand dense
            # views): gather the live set and solve over it
            ls = np.flatnonzero(state.live[state.lo:state.hi]) + state.lo
            state = AllocView(
                remaining=state.remaining[ls], tables=state.tables,
                max_w=state.max_w[ls],
                explore_started=state.explore_started[ls],
                rows=ls if state.rows is None else state.rows[ls],
                placement=state.placement)
        n = state.n
        cap = cluster.capacity
        pv = state.placement
        node_cap = 0
        if pv is not None:
            gpus = pv.node_gpus
            if pv.ok is not None:
                healthy = pv.ok & ~pv.draining
                cap = min(cap, int(gpus[healthy].sum()))
                pick = healthy & (pv.speed_mult >= 1.0)
                if not pick.any():
                    pick = healthy
                node_cap = int(gpus[pick].max()) if pick.any() else 0
            else:
                node_cap = int(gpus.max())
        target = np.zeros(n, np.int64)
        if n == 0 or cap <= 0:
            return target
        W = state.tables.shape[1] - 1
        tabs = (state.tables[:n] if state.rows is None
                else state.tables[state.rows])
        caps = np.minimum(state.max_w, W)
        if node_cap:
            caps = np.minimum(caps, node_cap)
        wcap = min(int(caps.max()), W)
        if wcap < 1:
            return target
        masked = np.where(np.arange(1, wcap + 1)[None, :] <= caps[:, None],
                          tabs[:, 1:wcap + 1], 0.0)
        w_star = np.argmax(masked, axis=1) + 1
        f_best = masked[np.arange(n), w_star - 1]
        t_best = state.remaining / np.maximum(f_best, 1e-12)
        w_star = w_star.tolist()
        # stable sort: FIFO order breaks remaining-time ties (like srtf)
        for i in np.argsort(t_best, kind="stable").tolist():
            if cap <= 0:
                break
            hi = min(int(caps[i]), cap)
            if hi < 1:
                continue
            w = w_star[i]
            if w > hi:      # clipped by remaining budget: re-derive
                w = int(np.argmax(tabs[i, 1:hi + 1])) + 1
            target[i] = w
            cap -= w
        return target


def _parameterless(name: str, cls: type[SchedulingPolicy]):
    def factory(param: str | None) -> SchedulingPolicy:
        _no_param(name, param)
        return cls()
    return factory


register_policy("precompute", _parameterless("precompute", DoublingPolicy))
register_policy("exploratory",
                _parameterless("exploratory", ExploratoryPolicy))
register_policy("fixed",
                lambda p: FixedPolicy(_int_param("fixed", p, "fixed_8")),
                example="fixed_8")
register_policy("srtf", _parameterless("srtf", SRTFPolicy))
register_policy("optimus", _parameterless("optimus", OptimusPolicy))
register_policy("utility_greedy",
                _parameterless("utility_greedy", UtilityGreedyPolicy))
register_policy("recovery_aware",
                _parameterless("recovery_aware", RecoveryAwarePolicy))


def _pack_factory(param: str | None) -> SchedulingPolicy:
    if param is None:
        raise ValueError("policy 'pack' wraps another policy spec, "
                         "e.g. 'pack_srtf' or 'pack_precompute'")
    return PackPolicy(get_policy(param))


register_policy("pack", _pack_factory, example="pack_srtf")
