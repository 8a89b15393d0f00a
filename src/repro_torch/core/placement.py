"""Node-level placement engine for the §7 simulator.

Through PR 3 the cluster was a flat pool: ``ClusterModel`` decided a job
"spans nodes" purely from ``w > gpus_per_node``, ignoring *which* nodes a
gang lands on, fragmentation, and per-node hardware differences.  GADGET
(arXiv 2202.01158) and the multi-tenant contention follow-up (arXiv
2207.07817) both show that placement and link contention reshuffle policy
rankings for ring-all-reduce jobs — this module is what makes the
non-flat scenarios real rather than cosmetic.

Core pieces:

  * :class:`repro_torch.collectives.cost.NodeSpec` (re-exported here) — GPU
    count plus optional per-node :class:`HardwareCoefficients` for
    heterogeneous fleets.
  * :class:`ClusterState` — SoA-friendly per-node free-GPU tracking
    (numpy ``free`` / ``node_gpus`` vectors) plus the live
    :class:`Placement` map, maintained incrementally across events.
  * :class:`PlacementStrategy` registry (``register_placement`` /
    ``get_placement`` / ``registered_placements``), mirroring the policy
    registry: ``packed`` (whole-gang first fit, then index-order fill),
    ``spread`` (max-free balancing), and ``best_fit`` (contention-aware:
    tightest single node that fits, else the fewest nodes — minimizes
    cross-node rings).
  * :class:`Placement` — one job's concrete gang assignment; its
    ``spans`` status derives from the *actual* per-node split under
    fragmentation, replacing the ``w > gpus_per_node`` shortcut.
  * The migration/defragmentation pass (``ClusterModel(defrag=True)``):
    a spanning gang that now fits on one node is consolidated there,
    charging ``restart_cost`` (the engines freeze the moved gang).
  * Admission control (``register_admission`` / ``get_admission``):
    ``admit_all`` (default no-op), ``queue_cap_<n>`` (reject arrivals
    once the active set holds n jobs), ``free_gpus_<k>`` (delay
    admission until k GPUs are free).

Both simulator engines drive one :class:`PlacementEngine` instance each
through the same call sequence (register → admit → apply → release), so
placement trajectories stay bit-identical between the SoA fast path and
the reference oracle.  On a flat cluster the engine is a structural
no-op: a single node means nothing ever spans, every speed factor is
exactly 1.0 (never computed, let alone multiplied approximately), and
completion times are bit-identical to the placement-free paths.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import telemetry as _tele
from repro_torch.collectives.cost import (ClusterModel, HardwareCoefficients,
                                    NodeSpec)
from repro_torch.core.scheduler import _int_param, _no_param, _split_spec

__all__ = [
    "NodeSpec", "Placement", "ClusterState", "PlacementView",
    "PlacementStrategy", "register_placement", "get_placement",
    "registered_placements", "AdmissionRule", "register_admission",
    "get_admission", "registered_admissions", "PlacementEngine",
    "ADMIT", "DELAY", "REJECT",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """One job's concrete gang assignment: ``((node, gpus), ...)``."""
    job_id: int
    assignment: tuple[tuple[int, int], ...]

    @property
    def w(self) -> int:
        return sum(g for _, g in self.assignment)

    @property
    def spans(self) -> bool:
        """Whether this ring actually crosses node boundaries — derived
        from the assignment, not from ``w > gpus_per_node``."""
        return len(self.assignment) > 1

    @property
    def node_ids(self) -> tuple[int, ...]:
        return tuple(i for i, _ in self.assignment)


class ClusterState:
    """Per-node free-GPU state, updated incrementally across events.

    Fault lifecycle (PR 10): ``fail_node`` kills a node (evicting every
    gang with a slot on it), ``drain_node`` decommissions it gracefully
    (running gangs stay, nothing new lands), ``recover_node`` returns it
    to service, and ``set_speed_mult`` marks it a straggler.  ``avail``
    is what placement may use — identical to ``free`` (the same array,
    not a copy) while every node is healthy, so the zero-fault paths are
    bit-identical to the pre-fault code.
    """

    __slots__ = ("node_gpus", "free", "placements", "ok", "draining",
                 "speed_mult", "_masked", "degraded")

    def __init__(self, nodes: tuple[NodeSpec, ...]):
        self.node_gpus = np.array([n.gpus for n in nodes], np.int64)
        self.free = self.node_gpus.copy()
        self.placements: dict[int, Placement] = {}
        self.ok = np.ones(len(self.node_gpus), bool)
        self.draining = np.zeros(len(self.node_gpus), bool)
        self.speed_mult = np.ones(len(self.node_gpus))
        self._masked = False      # any node failed or draining
        self.degraded = False     # any speed_mult != 1

    @property
    def n_nodes(self) -> int:
        return len(self.node_gpus)

    @property
    def avail(self) -> np.ndarray:
        """Free GPUs placement may actually use: ``free`` itself while
        every node is healthy, else a copy with failed/draining nodes
        masked to zero."""
        if not self._masked:
            return self.free
        out = self.free.copy()
        out[~(self.ok & ~self.draining)] = 0
        return out

    def total_free(self) -> int:
        return int(self.free.sum())

    def largest_free_block(self) -> int:
        return int(self.free.max())

    def total_avail(self) -> int:
        return int(self.avail.sum())

    def largest_avail_block(self) -> int:
        return int(self.avail.max())

    def placed_w(self, job_id: int) -> int:
        pl = self.placements.get(job_id)
        return 0 if pl is None else pl.w

    def assign(self, placement: Placement) -> None:
        assert placement.job_id not in self.placements, placement.job_id
        for node, gpus in placement.assignment:
            assert gpus > 0, placement
            self.free[node] -= gpus
            assert self.free[node] >= 0, (
                f"node {node} oversubscribed placing job "
                f"{placement.job_id}: {placement.assignment}")
        self.placements[placement.job_id] = placement

    def release(self, job_id: int) -> Placement | None:
        pl = self.placements.pop(job_id, None)
        if pl is not None:
            for node, gpus in pl.assignment:
                # a failed node's GPUs are gone until recover_node —
                # releasing a gang that held slots there must not
                # resurrect them (satellite: nodes are not immortal)
                if self.ok[node]:
                    self.free[node] += gpus
        return pl

    # -- fault lifecycle ---------------------------------------------------

    def _refresh_mask(self) -> None:
        self._masked = not bool((self.ok & ~self.draining).all())

    def fail_node(self, node: int) -> list[int]:
        """Kill ``node``: zero its capacity and evict every gang with a
        slot on it.  Returns the victim job ids (sorted)."""
        assert self.ok[node], f"node {node} is already failed"
        self.ok[node] = False
        self.free[node] = 0
        self._refresh_mask()
        victims = sorted(jid for jid, pl in self.placements.items()
                         if node in pl.node_ids)
        for jid in victims:
            self.release(jid)
        return victims

    def drain_node(self, node: int) -> None:
        """Graceful decommission: running gangs stay, nothing new lands
        on the node until ``recover_node``."""
        assert self.ok[node], f"cannot drain failed node {node}"
        self.draining[node] = True
        self._refresh_mask()

    def recover_node(self, node: int) -> None:
        """Return a failed or draining node to service."""
        if not self.ok[node]:
            self.ok[node] = True
            self.free[node] = self.node_gpus[node]
        self.draining[node] = False
        self._refresh_mask()

    def set_speed_mult(self, node: int, factor: float) -> None:
        """Mark ``node`` a straggler running at ``factor`` of nominal."""
        assert 0.0 < factor <= 1.0, factor
        self.speed_mult[node] = factor
        self.degraded = bool((self.speed_mult != 1.0).any())

    def check_invariants(self, capacity: int) -> None:
        """Test hook: no node oversubscribed, granted GPUs conserved
        against the *effective* (surviving) capacity, failed nodes
        empty."""
        assert (self.free >= 0).all(), self.free
        assert (self.free <= self.node_gpus).all(), self.free
        assert (self.free[~self.ok] == 0).all(), self.free
        placed = sum(pl.w for pl in self.placements.values())
        effective = capacity - int(self.node_gpus[~self.ok].sum())
        assert placed + self.total_free() == effective, (
            placed, self.total_free(), effective)
        per_node = np.zeros(self.n_nodes, np.int64)
        for pl in self.placements.values():
            assert pl.w > 0, pl
            for node, gpus in pl.assignment:
                per_node[node] += gpus
        assert (per_node[~self.ok] == 0).all(), per_node
        ok = self.ok
        assert (per_node[ok] + self.free[ok] == self.node_gpus[ok]).all(), \
            per_node


@dataclasses.dataclass(frozen=True)
class PlacementView:
    """Read-only snapshot handed to placement-aware policies via
    ``scheduler.AllocView.placement``: per-node capacities, current free
    GPUs, and the active strategy name.  On fault-capable clusters the
    health vectors are populated (``None`` otherwise) so policies can
    route around dead, draining, or straggling nodes."""
    node_gpus: np.ndarray
    free: np.ndarray
    strategy: str
    ok: np.ndarray | None = None
    draining: np.ndarray | None = None
    speed_mult: np.ndarray | None = None


# --------------------------------------------------------------------------
# Placement strategies.
# --------------------------------------------------------------------------

class PlacementStrategy:
    """Turns a gang size into a concrete per-node assignment.

    ``place`` may assume ``state.total_free() >= w`` (the engines only
    place what the policy's capacity-feasible allocation granted) and
    must return a tuple of ``(node, gpus)`` pairs summing to ``w``
    without oversubscribing any node.
    """

    name: str = "?"

    def place(self, state: ClusterState, w: int) -> tuple[tuple[int, int],
                                                          ...]:
        raise NotImplementedError

    @staticmethod
    def _fill(order, free, w) -> tuple[tuple[int, int], ...]:
        """Take GPUs from nodes in ``order`` until ``w`` are assigned."""
        asg = []
        need = w
        for i in order:
            take = min(need, int(free[i]))
            if take > 0:
                asg.append((int(i), take))
                need -= take
                if need == 0:
                    return tuple(asg)
        raise AssertionError(f"cannot place gang of {w} on free={free}")


class PackedPlacement(PlacementStrategy):
    """First fit: the whole gang on the first node with room; when
    fragmentation forces a split, fill nodes in index order (packing the
    fleet head — on heterogeneous fleets, list the fast nodes first)."""

    name = "packed"

    def place(self, state, w):
        free = state.avail
        for i in range(state.n_nodes):
            if free[i] >= w:
                return ((i, w),)
        return self._fill(range(state.n_nodes), free, w)


class SpreadPlacement(PlacementStrategy):
    """Load balancing: GPUs go to the node with the most free capacity,
    one at a time (ties break toward the lowest index).  Maximizes
    headroom per node — and, deliberately, cross-node rings: the classic
    placement that looks good on utilization dashboards and loses to
    packing once ring all-reduce pays for the fabric (GADGET §5)."""

    name = "spread"

    def place(self, state, w):
        free = state.avail.copy()
        taken = np.zeros(state.n_nodes, np.int64)
        for _ in range(w):
            i = int(np.argmax(free))
            free[i] -= 1
            taken[i] += 1
        return tuple((int(i), int(taken[i]))
                     for i in np.nonzero(taken)[0])


class BestFitPlacement(PlacementStrategy):
    """Contention-aware best fit: the *tightest* single node that fits
    (leaving big blocks intact for later gangs); when the gang must span,
    use the fewest nodes — largest free blocks first — to minimize the
    number of cross-node ring segments."""

    name = "best_fit"

    def place(self, state, w):
        free = state.avail
        best, best_left = -1, None
        for i in range(state.n_nodes):
            left = int(free[i]) - w
            if left >= 0 and (best_left is None or left < best_left):
                best, best_left = i, left
        if best >= 0:
            return ((best, w),)
        # np.argsort(-free, stable) orders by free desc, index asc on ties
        order = np.argsort(-free, kind="stable")
        return self._fill(order, free, w)


_PLACEMENT_REGISTRY: dict[str, type[PlacementStrategy]] = {}


def register_placement(cls: type[PlacementStrategy]) -> None:
    """Register a strategy class under ``cls.name``."""
    if cls.name in _PLACEMENT_REGISTRY:
        raise ValueError(f"placement strategy {cls.name!r} already "
                         f"registered")
    _PLACEMENT_REGISTRY[cls.name] = cls


def registered_placements() -> tuple[str, ...]:
    return tuple(sorted(_PLACEMENT_REGISTRY))


def get_placement(name: str) -> PlacementStrategy:
    cls = _PLACEMENT_REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown placement strategy {name!r}; registered: "
            f"{', '.join(registered_placements())}")
    return cls()


register_placement(PackedPlacement)
register_placement(SpreadPlacement)
register_placement(BestFitPlacement)


# --------------------------------------------------------------------------
# Admission control.
# --------------------------------------------------------------------------

ADMIT, DELAY, REJECT = "admit", "delay", "reject"


@dataclasses.dataclass(frozen=True)
class AdmissionView:
    """What an admission rule may look at when a job arrives."""
    n_active: int
    n_delayed: int
    total_free: int
    largest_free_block: int


class AdmissionRule:
    """Decides, per arriving job, ``ADMIT`` / ``DELAY`` (retried at every
    subsequent event) / ``REJECT`` (never runs; recorded in
    ``SimResult.rejected``)."""

    spec: str = "?"

    def decide(self, spec, view: AdmissionView, now: float) -> str:
        raise NotImplementedError

    def validate(self, cluster: ClusterModel) -> None:
        """Reject rule/cluster combinations that can never admit."""


class AdmitAll(AdmissionRule):
    spec = "admit_all"

    def decide(self, spec, view, now):
        return ADMIT


class QueueCap(AdmissionRule):
    """Classic load shedding: reject arrivals once the active set already
    holds ``n`` jobs."""

    def __init__(self, n: int):
        self.n = n
        self.spec = f"queue_cap_{n}"

    def decide(self, spec, view, now):
        return REJECT if view.n_active >= self.n else ADMIT


class FreeGpus(AdmissionRule):
    """Backpressure: delay admission until at least ``k`` GPUs are free,
    so a new gang never lands on a fully saturated cluster."""

    def __init__(self, k: int):
        self.k = k
        self.spec = f"free_gpus_{k}"

    def decide(self, spec, view, now):
        return ADMIT if view.total_free >= self.k else DELAY

    def validate(self, cluster):
        if self.k > cluster.capacity:
            raise ValueError(
                f"{self.spec!r} can never admit on a "
                f"{cluster.capacity}-GPU cluster (k must be <= capacity)")


_ADMISSION_REGISTRY: dict[str, object] = {}


def register_admission(name: str, factory) -> None:
    """Register an admission rule; ``factory(param)`` receives the spec
    suffix (``"64"`` for ``"queue_cap_64"``, None for a bare name)."""
    if name in _ADMISSION_REGISTRY:
        raise ValueError(f"admission rule {name!r} already registered")
    _ADMISSION_REGISTRY[name] = factory


def registered_admissions() -> tuple[str, ...]:
    return tuple(sorted(_ADMISSION_REGISTRY))


def get_admission(spec: str) -> AdmissionRule:
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"admission spec must be a non-empty string, "
                         f"got {spec!r}")
    base, param = _split_spec(_ADMISSION_REGISTRY, spec)
    factory = _ADMISSION_REGISTRY.get(base)
    if factory is None:
        raise ValueError(
            f"unknown admission rule {spec!r}; registered: "
            f"{', '.join(registered_admissions())}")
    return factory(param)


def _admit_all_factory(param):
    _no_param("admit_all", param, noun="admission rule")
    return AdmitAll()


register_admission("admit_all", _admit_all_factory)
register_admission("queue_cap",
                   lambda p: QueueCap(_int_param("queue_cap", p,
                                                 "queue_cap_64",
                                                 noun="admission rule")))
register_admission("free_gpus",
                   lambda p: FreeGpus(_int_param("free_gpus", p,
                                                 "free_gpus_8",
                                                 noun="admission rule")))


# --------------------------------------------------------------------------
# The engine.
# --------------------------------------------------------------------------

class PlacementEngine:
    """Owns the node-level state for one simulation run.

    Both simulator engines drive it identically: ``register`` at arrival,
    ``admit`` for admission control, ``apply`` at every reallocation
    event (returns which rows need their speed refreshed, with the new
    placement factors and spanning flags), ``release`` at completion.
    """

    def __init__(self, cluster: ClusterModel):
        self.cluster = cluster
        self.nodes = cluster.node_specs()
        self.state = ClusterState(self.nodes)
        self.strategy = get_placement(cluster.placement)
        self.admission = get_admission(cluster.admission)
        self.spec_of: dict[int, object] = {}
        self.migrations = 0
        # telemetry recorder (set by the engines when telemetry is on);
        # the no-op singleton keeps the defrag pass unconditional
        self.rec = _tele.NULL_RECORDER
        # (sorted node ids, spans) -> effective HardwareCoefficients
        self._hw_cache: dict = {}
        self._uniform_hw = all(n.hw is None or n.hw == cluster.hw
                               for n in self.nodes)
        # fault-capable run: apply() clamps grants to surviving capacity
        # (gated so the zero-fault path is byte-identical)
        self.faulty = cluster.faults is not None
        # jobs whose speed factor must refresh at the next apply() even
        # though their gang did not change (straggler degradation)
        self.dirty: set[int] = set()

    # -- arrivals ----------------------------------------------------------

    def register(self, spec) -> None:
        self.spec_of[spec.job_id] = spec

    def admit(self, spec, n_active: int, n_delayed: int, now: float) -> str:
        # avail == free (same values) while every node is healthy
        view = AdmissionView(n_active=n_active, n_delayed=n_delayed,
                             total_free=self.state.total_avail(),
                             largest_free_block=(
                                 self.state.largest_avail_block()))
        verdict = self.admission.decide(spec, view, now)
        assert verdict in (ADMIT, DELAY, REJECT), verdict
        return verdict

    # -- fault delivery ----------------------------------------------------

    def fail(self, node: int) -> list[int]:
        """Node death: returns the evicted job ids (sorted).  Killing an
        already-dead node is a no-op — stochastic churn can draw the
        same node twice with overlapping outages."""
        if not self.state.ok[node]:
            return []
        return self.state.fail_node(node)

    def drain(self, node: int) -> None:
        if self.state.ok[node] and not self.state.draining[node]:
            self.state.drain_node(node)

    def recover(self, node: int) -> None:
        self.state.recover_node(node)

    def degrade(self, node: int, factor: float) -> None:
        """Straggler: the node runs at ``factor``; gangs already placed
        there get their speed refreshed at the next apply()."""
        self.state.set_speed_mult(node, factor)
        for jid, pl in self.state.placements.items():
            if node in pl.node_ids:
                self.dirty.add(jid)

    # -- policy-facing view ------------------------------------------------

    def view(self) -> PlacementView:
        # all arrays are copies: a policy mutating its snapshot must not
        # corrupt the engine's live bookkeeping
        st = self.state
        return PlacementView(node_gpus=st.node_gpus.copy(),
                             free=st.free.copy(),
                             strategy=self.strategy.name,
                             ok=st.ok.copy() if self.faulty else None,
                             draining=(st.draining.copy()
                                       if self.faulty else None),
                             speed_mult=(st.speed_mult.copy()
                                         if self.faulty else None))

    # -- the per-event placement pass --------------------------------------

    def apply(self, ids, target, changed, now: float = 0.0):
        """Re-place changed gangs, run the defrag pass, and report.

        ``ids``/``target`` are the active set (ids and new worker counts,
        active-list order); ``changed`` are the positions whose count
        differs from the currently placed gang.  Returns ``(upd,
        factors, spans)``: the positions whose speed must be refreshed
        (changed plus migrated), each with its new placement factor and
        actual spanning flag.  Factors multiply the *flat* speed table —
        exactly 1.0 for a non-spanning gang on default-hardware nodes.
        ``now`` is the simulated time, only used to timestamp telemetry
        migrate events.
        """
        st = self.state
        for pos in changed:
            st.release(int(ids[pos]))
        for pos in changed:
            w = int(target[pos])
            if w > 0:
                jid = int(ids[pos])
                if self.faulty:
                    # a fault-blind policy may grant more than the
                    # surviving nodes hold — clamp (mutating ``target``
                    # so the engines record the placed count)
                    room = int(st.avail.sum())
                    if w > room:
                        w = room
                        target[pos] = w
                        if w == 0:
                            continue
                st.assign(Placement(jid, self.strategy.place(st, w)))
        moved = self._defrag(ids, now) if self.cluster.defrag else ()
        dirty: list[int] = []
        if self.dirty:
            live = {int(ids[p]): p for p in range(len(ids))}
            dirty = [live[j] for j in self.dirty if j in live]
            self.dirty.clear()
        upd = sorted(set(changed) | set(moved) | set(dirty))
        factors = np.ones(len(upd))
        spans = np.zeros(len(upd), bool)
        for k, pos in enumerate(upd):
            f, sp = self._job_factor(int(ids[pos]))
            factors[k] = f
            spans[k] = sp
        return np.asarray(upd, np.int64), factors, spans

    def release(self, job_id: int) -> None:
        self.state.release(job_id)

    def _defrag(self, ids, now: float = 0.0) -> list[int]:
        """Single consolidation pass in active-list order: a spanning
        gang that now fits on one node moves to the *fastest* such node
        (its own GPUs there count as available; ties broken tightest
        fit, then lowest index), and only when the move strictly beats
        the current placement factor — on a heterogeneous fleet a slow
        node may free up that would make the gang slower than its
        spanning ring, and paying ``restart_cost`` for that is never
        worth it.  Later gangs see the space earlier moves freed."""
        st = self.state
        moved = []
        for pos in range(len(ids)):
            jid = int(ids[pos])
            pl = st.placements.get(jid)
            if pl is None or not pl.spans:
                continue
            w = pl.w
            own = dict(pl.assignment)
            cur_f, _ = self._job_factor(jid)
            best, best_f, best_left = -1, cur_f, None
            av = st.avail      # == st.free (live array) while healthy
            masked = av is not st.free
            for i in range(st.n_nodes):
                if masked and not (st.ok[i] and not st.draining[i]):
                    continue   # never consolidate onto a dead/draining node
                left = int(av[i]) + own.get(i, 0) - w
                if left < 0:
                    continue
                f = self._assignment_factor(jid, (i,), False, w)
                if f > best_f or (f == best_f and best >= 0
                                  and left < best_left):
                    best, best_f, best_left = i, f, left
            if best >= 0:
                st.release(jid)
                st.assign(Placement(jid, ((best, w),)))
                self.migrations += 1
                moved.append(pos)
                if self.rec.on:
                    self.rec.migrate(now, jid, best)
        return moved

    # -- placement-dependent speed -----------------------------------------

    def _job_factor(self, job_id: int) -> tuple[float, bool]:
        """(speed multiplier over the flat table, actual spanning flag)
        for the job's current placement."""
        pl = self.state.placements.get(job_id)
        if pl is None:
            return 1.0, False
        return (self._assignment_factor(job_id, pl.node_ids, pl.spans,
                                        pl.w), pl.spans)

    def _assignment_factor(self, job_id: int, node_ids: tuple[int, ...],
                           spans: bool, w: int) -> float:
        """Speed multiplier a ``w``-gang on ``node_ids`` would run at."""
        # synchronous training runs at the slowest straggler's pace;
        # kept outside _gang_hw/_hw_cache (which do not key on mult)
        mult = 1.0
        if self.state.degraded:
            mult = float(min(self.state.speed_mult[i] for i in node_ids))
        if not spans and self._uniform_hw:
            return mult
        hw_eff = self._gang_hw(node_ids, spans)
        if hw_eff == self.cluster.hw:
            return mult
        tab = self.spec_of[job_id].placement_factor(self.cluster, hw_eff)
        return mult * float(tab[w])

    def _gang_hw(self, node_ids: tuple[int, ...],
                 spans: bool) -> HardwareCoefficients:
        """Effective coefficients a gang on ``node_ids`` sees: the
        slowest involved node per constant (synchronous training runs at
        the straggler's pace), with the cross-node β when the ring spans."""
        key = (tuple(sorted(node_ids)), spans)   # order-independent set
        hw = self._hw_cache.get(key)
        if hw is None:
            cl = self.cluster
            hws = [self.nodes[i].hw or cl.hw for i in node_ids]
            if spans and all(h == cl.hw for h in hws):
                hw = cl.inter_hw()      # same object legacy tables use
            else:
                alpha = max(h.alpha for h in hws)
                gamma = max(h.gamma for h in hws)
                beta = (cl.inter_node_beta if spans
                        else max(h.beta for h in hws))
                hw = HardwareCoefficients(
                    alpha=alpha, beta=beta, gamma=gamma,
                    name=f"{cl.hw.name}+placed")
            self._hw_cache[key] = hw
        return hw
