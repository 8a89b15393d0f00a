"""Parity oracle — the seed implementations, kept with the seed's cost
profile.

Everything in this module exists to *check* (and benchmark against) the
fast paths, never to run them:

  * ``doubling_heuristic_ref`` / ``optimus_greedy_ref`` / ``exact_dp_ref``
    — the pre-table O(J)-rescan solvers over (job_id, Q, speed_fn)
    callables.  The fast table/SoA solvers in ``repro_torch.core.scheduler``
    must stay allocation-for-allocation identical to these (asserted by
    tests/test_scheduler_tables.py and ``bench_scheduler.py --check``).
  * ``simulate_reference`` — the seed §7 event loop (O(J) candidate
    rescans, scalar ``JobSpec.speed`` calls throughout, list pops for
    arrivals).  ``simulate(..., engine="reference")`` dispatches here; the
    SoA engine must produce bit-identical completion times, and the
    benchmark's ≥20× speedup floor is measured against this loop.

For the paper's own strategies (precompute / exploratory / fixed_k) the
loop allocates through the ``*_ref`` solvers — the seed code path,
verbatim.  Any *other* registered policy is adapted onto its own
``allocate()`` over views built per solve, so the trajectory bookkeeping
(event ordering, scalar progress arithmetic) is still independently
exercised for new policies even though the allocator is shared.

Cluster awareness mirrors the fast engine exactly: a non-flat topology
swaps each job's scalar speed callable for a lookup into its
cluster-scaled speed table, and the GADGET-style contention factor
multiplies the speed of every concurrently-communicating (w >= 2) job.
Flat homogeneous clusters skip both branches and run the seed arithmetic
untouched.

(The only change since the seed: ``doubling_heuristic_ref`` accepts
per-job caps via ``_caps``, extended in lockstep with the fast solvers so
parity stays meaningful on heterogeneous fleets.)
"""
from __future__ import annotations

import dataclasses
import math
from time import perf_counter
from typing import Sequence

import numpy as np

from repro_torch.collectives.cost import ClusterModel
from repro_torch.core import scheduler as sched
from repro_torch.core import telemetry as _tele
from repro_torch.core.jobs import JobSpec
from repro_torch.core.scheduler import (Alloc, EXPLORE_SEGMENT, EXPLORE_WS,
                                  JobTuple, RESCHEDULE_EVERY, _caps,
                                  _gain_double)


def doubling_heuristic_ref(jobs: Sequence[JobTuple], capacity: int,
                           max_w=None) -> Alloc:
    jobs = list(jobs)
    caps = _caps(max_w, len(jobs))   # scalar or per-job, like the fast path
    alloc: Alloc = {}
    used = 0
    # 1 worker to every job (FIFO when oversubscribed)
    for (jid, _, _) in jobs:
        if used < capacity:
            alloc[jid] = 1
            used += 1
        else:
            alloc[jid] = 0
    # doubling by best average marginal gain
    while True:
        best, best_gain = None, 0.0
        for idx, (jid, Q, f) in enumerate(jobs):
            w = alloc[jid]
            if w == 0:
                continue
            mw = caps[idx]
            if mw is not None and 2 * w > mw:
                continue
            if used + w > capacity:   # doubling adds w more workers
                continue
            g = _gain_double(Q, f, w)
            if g > best_gain:
                best, best_gain = jid, g
        if best is None:
            return alloc
        used += alloc[best]
        alloc[best] *= 2


def optimus_greedy_ref(jobs: Sequence[JobTuple], capacity: int,
                       max_w: int | None = None) -> Alloc:
    jobs = list(jobs)
    alloc: Alloc = {}
    used = 0
    for (jid, _, _) in jobs:
        if used < capacity:
            alloc[jid] = 1
            used += 1
        else:
            alloc[jid] = 0
    while used < capacity:
        best, best_gain = None, 0.0
        for (jid, Q, f) in jobs:
            w = alloc[jid]
            if w == 0:
                continue
            if max_w is not None and w + 1 > max_w:
                continue
            g = Q / max(f(w), 1e-12) - Q / max(f(w + 1), 1e-12)
            if g > best_gain:
                best, best_gain = jid, g
        if best is None:
            return alloc
        alloc[best] += 1
        used += 1
    return alloc


def exact_dp_ref(jobs: Sequence[JobTuple], capacity: int,
                 max_w: int | None = None,
                 powers_of_two: bool = False) -> Alloc:
    jobs = list(jobs)
    J = len(jobs)
    wmax = min(max_w or capacity, capacity)
    choices = ([2 ** k for k in range(int(math.log2(wmax)) + 1)]
               if powers_of_two else list(range(1, wmax + 1)))
    assert J <= capacity, "exact_dp assumes every job can get >=1 worker (Z+)"
    dp = {0: (0.0, ())}
    for (jid, Q, f) in jobs:
        ndp: dict[int, tuple[float, tuple]] = {}
        for c, (cost, chosen) in dp.items():
            for w in choices:
                nc = c + w
                if nc > capacity:
                    continue
                t = 0.0 if w == 0 else Q / max(f(w), 1e-12)
                cand = (cost + t, chosen + (w,))
                if nc not in ndp or cand[0] < ndp[nc][0]:
                    ndp[nc] = cand
        dp = ndp
    best_cost, best_alloc = min(dp.values(), key=lambda kv: kv[0])
    return {jid: w for (jid, _, _), w in zip(jobs, best_alloc)}


# --------------------------------------------------------------------------
# The seed §7 event loop.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Active:
    spec: JobSpec
    remaining: float              # epochs
    w: int = 0
    frozen_until: float = 0.0     # restart pause
    explore_started: float | None = None
    # scalar f(w): the job's own ``spec.speed`` on a flat cluster (the
    # seed cost profile), a cluster-scaled table lookup on a topology
    speed_fn: object = None
    # placement-engine state: speed multiplier for the current gang
    # assignment and its actual spanning flag (1.0 / False off-placement)
    place_factor: float = 1.0
    spans: bool = False

    def __post_init__(self):
        if self.speed_fn is None:
            self.speed_fn = self.spec.speed

    def explore_w(self, now: float) -> int | None:
        """Worker count dictated by the explore phase, or None if done."""
        if self.explore_started is None:
            return None
        seg = int((now - self.explore_started) // EXPLORE_SEGMENT)
        if seg >= len(EXPLORE_WS):
            return None
        return EXPLORE_WS[seg]

    def speed(self, now: float) -> float:
        if now < self.frozen_until or self.w <= 0:
            return 0.0
        s = self.speed_fn(self.w)
        # guarded multiply: the flat seed arithmetic stays byte-for-byte
        # untouched (x * 1.0 would be exact too, but why touch it)
        return s if self.place_factor == 1.0 else s * self.place_factor


def _explore_grants(active: list[_Active], capacity: int, now: float,
                    alloc: dict[int, int], dynamic: list[_Active]) -> int:
    """Grant explore-phase jobs their gang reservation; returns leftover cap.

    Each profiling job reserves a gang of ``min(8, remaining capacity)``
    GPUs (clamped — the old all-or-nothing 8 grant handed later explorers
    exactly 0 and kept them out of the dynamic pool, silently starving
    them) and runs its schedule-dictated w inside that reservation.
    """
    cap = capacity
    for a in active:
        ew = a.explore_w(now)
        if ew is not None:
            grant = min(8, cap)
            alloc[a.spec.job_id] = min(ew, grant)
            cap -= grant
        else:
            dynamic.append(a)
    return cap


def _view_of(active: list[_Active], cluster: ClusterModel,
             placement=None) -> sched.AllocView:
    """SoA views over an ``_Active`` list, built per solve (oracle only)."""
    return sched.AllocView(
        remaining=np.array([a.remaining for a in active]),
        tables=np.stack([np.asarray(a.spec.speed_table(cluster))
                         for a in active]),
        max_w=np.array([a.spec.max_w for a in active], np.int64),
        explore_started=np.array(
            [-np.inf if a.explore_started is None else a.explore_started
             for a in active]),
        placement=placement)


def _allocate_seed(policy: sched.SchedulingPolicy, active: list[_Active],
                   capacity: int, now: float) -> dict[int, int]:
    """Seed allocation path for the paper's own strategies: callable-based
    ``*_ref`` solvers, the original cost profile."""
    if isinstance(policy, sched.FixedPolicy):
        tuples = [(a.spec.job_id, a.remaining, a.speed_fn) for a in active]
        return sched.fixed(tuples, capacity, policy.k)

    alloc: dict[int, int] = {}
    dynamic: list[_Active] = []
    if isinstance(policy, sched.ExploratoryPolicy):
        cap = _explore_grants(active, capacity, now, alloc, dynamic)
    else:  # precompute: all jobs schedulable immediately
        cap = capacity
        dynamic = list(active)
    tuples = [(a.spec.job_id, a.remaining, a.speed_fn) for a in dynamic]
    alloc.update(doubling_heuristic_ref(
        tuples, cap, max_w=[a.spec.max_w for a in dynamic]))
    return alloc


_SEED_POLICIES = (sched.DoublingPolicy, sched.ExploratoryPolicy,
                  sched.FixedPolicy)


def simulate_reference(jobs: list[JobSpec], cluster: ClusterModel,
                       policy: sched.SchedulingPolicy,
                       tel: object = _tele.NULL):
    """The pre-table event loop — the trajectory oracle.

    Must stay behaviorally identical to the SoA engine
    (``simulator._simulate_table``), asserted by tests and
    benchmarks/bench_scheduler.py.  Telemetry events mirror the fast
    engine's: the emitted *set* per timestamp is identical (trajectory
    parity), so the metrics rollup — an order-insensitive integral over
    ``dt > 0`` spans — is bitwise-equal between engines.
    """
    from repro_torch.core.simulator import SimResult

    capacity = cluster.capacity
    penalty = cluster.contention_penalty
    flat_fabric = cluster.gpus_per_node is None
    peng = None
    if cluster.placement is not None:
        from repro_torch.core.placement import PlacementEngine
        peng = PlacementEngine(cluster)
    rec = tel.recorder(policy.spec, capacity, len(jobs),
                       cluster.gpus_per_node or 0)
    rec_on = rec.on
    # solve-timer handle hoisted out of the event loop (bound method:
    # one call per reallocation instead of two attribute chases + call)
    t_solve_add = rec.t_solve.add if rec_on else None
    if peng is not None:
        peng.rec = rec
    pending = sorted(jobs, key=lambda j: j.arrival)
    # Fault injection: the same deterministic incident tape as the fast
    # engine — same model, same seed, same horizon, so the schedules are
    # bit-identical by construction (FaultModel.schedule is pure).
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
    fi = 0
    requeue_rem: dict[int, float] = {}
    evictions = 0
    active: list[_Active] = []
    done: dict[int, float] = {}
    arrivals = {j.job_id: j.arrival for j in jobs}
    delayed: list[JobSpec] = []
    rejected: list[int] = []
    now = 0.0
    peak = 0
    next_resched = 0.0
    seed_policy = isinstance(policy, _SEED_POLICIES)

    def _admit(j: JobSpec, now: float) -> None:
        a = _Active(spec=j, remaining=j.epochs)
        rr = requeue_rem.pop(j.job_id, None)
        if rr is not None:
            # evicted-then-readmitted: resume from rolled-back progress
            a.remaining = rr
        if not flat_fabric or peng is not None:
            # placement engines run over the *flat* table (speed_table
            # returns it when cluster.placement is set) and scale by the
            # per-assignment factor instead of baked spanning rows
            table = j.speed_table(cluster)
            a.speed_fn = lambda w, t=table: float(t[w])
        if policy.explores:
            a.explore_started = now
        if peng is not None:
            peng.register(j)
        active.append(a)

    def apply_alloc(now: float):
        if seed_policy:
            target = _allocate_seed(policy, active, capacity, now)
        else:
            soa = policy.allocate(
                _view_of(active, cluster,
                         None if peng is None else peng.view()),
                cluster, now)
            target = {a.spec.job_id: int(w) for a, w in zip(active, soa)}
        if peng is None:
            if rec_on:
                nchg = sum(1 for a in active
                           if target.get(a.spec.job_id, 0) != a.w)
                if nchg:
                    rec.solve(now, nchg, False, len(active))
                else:
                    rec.solve_reused()
            for a in active:
                w_new = target.get(a.spec.job_id, 0)
                if w_new != a.w:
                    if rec_on:
                        rec.alloc(now, a.spec.job_id, a.w, w_new)
                    a.w = w_new
                    if w_new > 0:
                        a.frozen_until = now + cluster.restart_cost
                        if rec_on:
                            rec.freeze(now, a.spec.job_id, a.frozen_until)
            return
        ids = [a.spec.job_id for a in active]
        tvec = [target.get(jid, 0) for jid in ids]
        changed = [i for i, a in enumerate(active) if tvec[i] != a.w]
        if rec_on:
            if changed:
                rec.solve(now, len(changed), False, len(active))
            else:
                rec.solve_reused()
        upd, factors, spans = peng.apply(ids, tvec, changed, now)
        # alloc events fire after apply (mirrors the fast engine): the
        # fault clamp can shrink tvec entries in-place, and the logged
        # width must be the grant the gang actually got
        if rec_on:
            for i in changed:
                rec.alloc(now, active[i].spec.job_id, active[i].w, tvec[i])
        for i, a in enumerate(active):
            a.w = tvec[i]
        for pos, f, sp in zip(upd.tolist(), factors.tolist(),
                              spans.tolist()):
            a = active[pos]
            a.place_factor = f
            a.spans = sp
            if a.w > 0:
                a.frozen_until = now + cluster.restart_cost
                if rec_on:
                    rec.freeze(now, a.spec.job_id, a.frozen_until)
        # also freeze explore-phase jobs at segment switches implicitly via
        # reschedule events (RESCHEDULE_EVERY == EXPLORE_SEGMENT).

    while pending or active or delayed:
        # --- next event time -------------------------------------------
        # next_resched is always a candidate, so the list is never empty
        fac = 1.0
        if penalty:
            if peng is not None:
                fac = cluster.contention_factor(
                    sum(1 for a in active if a.spans))
            else:
                fac = cluster.contention_factor(
                    sum(1 for a in active if a.w >= 2))
        t_candidates = [next_resched]
        if pending:
            t_candidates.append(pending[0].arrival)
        if fi < nf:
            t_candidates.append(fsched[fi].t)
        for a in active:
            s = a.speed(now)
            if s > 0:
                if fac != 1.0 and (a.spans if peng is not None
                                   else a.w >= 2):
                    s *= fac
                t_candidates.append(max(now, a.frozen_until)
                                    + a.remaining / s)
            elif a.w > 0 and a.frozen_until > now:
                t_candidates.append(a.frozen_until)
        t_next = max(now, min(t_candidates))

        # --- advance progress -------------------------------------------
        for a in active:
            run_from = max(now, a.frozen_until)
            dt = max(0.0, t_next - run_from)
            s = a.speed_fn(a.w) if a.w > 0 else 0.0
            if a.place_factor != 1.0:
                s *= a.place_factor
            if fac != 1.0 and (a.spans if peng is not None else a.w >= 2):
                s *= fac
            a.remaining -= dt * s

        now = t_next

        # --- completions -------------------------------------------------
        finished = [a for a in active if a.remaining <= 1e-9]
        for a in finished:
            done[a.spec.job_id] = now
            active.remove(a)
            if peng is not None:
                peng.release(a.spec.job_id)
            if rec_on:
                rec.complete(now, a.spec.job_id)

        # --- faults ------------------------------------------------------
        # mirrors the fast engine exactly: incidents fire after
        # completions, before arrivals; victims evict in active-list
        # order (== the fast engine's ascending live slots) and re-enter
        # through the normal admission path
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
                    vact = [a for a in active if a.spec.job_id in vset]
                    evicted = []
                    for a in vact:
                        done_p = a.spec.epochs - a.remaining
                        lost = ckpt.lost_progress(done_p)
                        evicted.append(
                            (a.spec.job_id, a.spec, a.remaining + lost,
                             lost,
                             lost / done_p if done_p > 0.0 else 0.0))
                        active.remove(a)
                    evictions += len(vact)
                    for jid, spec, new_rem, lost, lost_frac in evicted:
                        if rec_on:
                            rec.evict(now, jid, fe.node, lost, lost_frac)
                        requeue_rem[jid] = new_rem
                        verdict = peng.admit(spec, len(active),
                                             len(delayed), now)
                        if verdict == "admit":
                            _admit(spec, now)
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
            elif fe.kind == "drain":
                peng.drain(fe.node)
            elif fe.kind == "recover":
                peng.recover(fe.node)
            else:
                peng.degrade(fe.node, fe.factor)

        # --- arrivals ----------------------------------------------------
        arrived = False
        if delayed:
            still: list[JobSpec] = []
            for j in delayed:
                verdict = peng.admit(j, len(active), len(still), now)
                if verdict == "admit":
                    _admit(j, now)
                    arrived = True
                    if rec_on:
                        rec.admit(now, j.job_id)
                elif verdict == "reject":
                    rejected.append(j.job_id)
                    if rec_on:
                        rec.reject(now, j.job_id)
                else:
                    still.append(j)
            if still and not arrived and not active and not pending:
                raise RuntimeError(
                    f"admission rule {cluster.admission!r} stalled: "
                    f"{len(still)} delayed jobs on an idle cluster")
            delayed = still
        while pending and pending[0].arrival <= now + 1e-9:
            j = pending.pop(0)
            if rec_on:
                rec.submit(now, j.job_id, j.arrival)
            if peng is not None:
                verdict = peng.admit(j, len(active), len(delayed), now)
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
            _admit(j, now)
            arrived = True
            if rec_on:
                rec.admit(now, j.job_id)

        peak = max(peak, len(active))

        # --- reallocation ------------------------------------------------
        if arrived or finished or faulted or now + 1e-9 >= next_resched:
            if active:
                if rec_on:
                    _t0 = perf_counter()
                    apply_alloc(now)
                    t_solve_add(perf_counter() - _t0)
                else:
                    apply_alloc(now)
            next_resched = now + RESCHEDULE_EVERY

    return SimResult(strategy=policy.spec, completion_times=done,
                     arrival_times=arrivals, peak_concurrency=peak,
                     rejected=tuple(rejected),
                     migrations=0 if peng is None else peng.migrations,
                     evictions=evictions,
                     telemetry=rec.finish(now))
