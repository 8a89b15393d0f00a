"""Fault injection for the §7 simulator: deterministic per-seed churn.

The paper's premise is that ring jobs are cheap to stop and restart
(§5, Table 2) — but through PR 9 the simulator only ever exercised
*voluntary* restarts chosen by the scheduler.  Real clusters lose
machines: GADGET (arXiv 2202.01158) assumes jobs can be preempted and
resumed at any decision epoch, and the systems comparison in arXiv
1909.02061 identifies worker failure as the dominant availability risk
for ring topologies, where one dead peer stalls the whole ring.  This
module supplies the missing involuntary side:

  * :class:`FaultEvent` — one timed incident (``fail`` / ``drain`` /
    ``recover`` / ``degrade``) against one node.
  * :class:`FaultModel` registry (``register_fault_model`` /
    ``get_fault_model`` / ``registered_fault_models``), mirroring the
    policy/placement/admission registries: ``none``, scheduled kills
    (``kill_<t>``), stochastic churn (``churn_<n>``), timed drains
    (``drain_<t>``), permanent stragglers (``stragglers_<k>``), and
    correlated rack outages (``rack_<t>``).  ``schedule()`` is a pure
    function of ``(cluster, seed, horizon)`` — same seed, same schedule,
    bit-identical on both simulator engines.
  * :class:`CheckpointPolicy` — checkpoint-age-dependent lost work.  A
    killed gang loses the progress since its last checkpoint (interval
    in progress-seconds, modeled on ``CheckpointStore``/
    ``ElasticTrainer``: ``save`` every ``interval`` of progress, restore
    rolls back to the last saved step) and pays ``cluster.restart_cost``
    to rejoin the queue.

The engines deliver the schedule through the same calendar-ordered event
loop as arrivals: an empty schedule (``faults=None`` or ``"none"``) is a
structural no-op and existing goldens stay bit-identical.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.scheduler import _int_param, _no_param, _split_spec

__all__ = [
    "FaultEvent", "FaultModel", "CheckpointPolicy",
    "DEFAULT_CHECKPOINT_INTERVAL", "register_fault_model",
    "get_fault_model", "registered_fault_models",
]

# progress-seconds between checkpoints when the cluster does not say
# (ClusterModel.checkpoint_interval): 5 simulated minutes, the same
# order as the explore segments the schedulers already charge for
DEFAULT_CHECKPOINT_INTERVAL = 300.0

FAIL, DRAIN, RECOVER, DEGRADE = "fail", "drain", "recover", "degrade"
_KINDS = (FAIL, DRAIN, RECOVER, DEGRADE)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed incident against one node.

    ``fail``     — the node dies: every gang with a slot on it is
                   evicted, loses un-checkpointed progress, re-enters
                   the queue through admission.
    ``drain``    — graceful decommission: running gangs stay, no new
                   placements land on the node until it recovers.
    ``recover``  — the node returns to service (clears fail or drain).
    ``degrade``  — straggler: the node runs at ``factor`` of nominal
                   speed; the placement engine routes around it.
    """
    t: float
    kind: str
    node: int
    factor: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.kind == DEGRADE and not 0.0 < self.factor <= 1.0:
            raise ValueError(
                f"degrade factor must be in (0, 1], got {self.factor}")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Checkpoint-age-dependent lost work, modeled on ``CheckpointStore``
    + ``ElasticTrainer``: the trainer saves every ``interval`` of
    progress, so a crash rolls a job back to its last multiple of
    ``interval`` and the restart pays ``restart_cost`` (the same
    stop-restart pause voluntary reallocations charge, paper §6)."""
    interval: float = DEFAULT_CHECKPOINT_INTERVAL
    restart_cost: float = 10.0

    def __post_init__(self):
        if self.interval <= 0.0:
            raise ValueError(
                f"checkpoint interval must be > 0, got {self.interval}")

    def lost_progress(self, done: float) -> float:
        """Progress-seconds since the last checkpoint: ``done`` minus its
        last multiple of ``interval`` (0 when nothing was done)."""
        if done <= 0.0:
            return 0.0
        return done - self.interval * math.floor(done / self.interval)


class FaultModel:
    """Generates one deterministic fault schedule per (cluster, seed).

    ``schedule`` must be a pure function of its arguments — both
    simulator engines call it independently and require bit-identical
    output — and must return events sorted by time (ties in emit order).
    """

    spec: str = "?"

    def schedule(self, cluster, seed: int,
                 horizon: float) -> tuple[FaultEvent, ...]:
        raise NotImplementedError

    def validate(self, cluster) -> None:
        """Reject model/cluster combinations that cannot work."""

    @staticmethod
    def _sort(events) -> tuple[FaultEvent, ...]:
        return tuple(sorted(events, key=lambda e: e.t))


class NoFaults(FaultModel):
    """Explicit zero-fault model: the full fault machinery threaded
    through with an empty schedule — bit-identical to ``faults=None``
    (the parity gates check exactly that)."""

    spec = "none"

    def schedule(self, cluster, seed, horizon):
        return ()


class ScheduledKill(FaultModel):
    """One scheduled node failure at ``t`` (node picked by seed), the
    node recovers 900 s later.  The minimal reproducible incident."""

    OUTAGE = 900.0

    def __init__(self, t: int):
        if t < 0:
            raise ValueError(f"kill time must be >= 0, got {t}")
        self.t = float(t)
        self.spec = f"kill_{t}"

    def schedule(self, cluster, seed, horizon):
        n = len(cluster.node_specs())
        node = seed % n
        return (FaultEvent(self.t, FAIL, node),
                FaultEvent(self.t + self.OUTAGE, RECOVER, node))


class StochasticChurn(FaultModel):
    """``n`` independent node failures at PCG64-drawn times across the
    horizon, each followed by a ~600 s (exponentially jittered) outage.
    The workhorse churn model: same seed, same incident tape."""

    MEAN_OUTAGE = 600.0

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"churn count must be >= 1, got {n}")
        self.n = n
        self.spec = f"churn_{n}"

    def schedule(self, cluster, seed, horizon):
        rng = np.random.default_rng((seed, 0xFA17))
        n_nodes = len(cluster.node_specs())
        span = max(horizon, 1.0)
        events = []
        for _ in range(self.n):
            t = float(rng.uniform(0.0, span))
            node = int(rng.integers(0, n_nodes))
            outage = float(rng.exponential(self.MEAN_OUTAGE)) + 60.0
            events.append(FaultEvent(t, FAIL, node))
            events.append(FaultEvent(t + outage, RECOVER, node))
        return self._sort(events)

    def validate(self, cluster):
        if len(cluster.node_specs()) < 2:
            raise ValueError(
                f"{self.spec!r} on a single-node cluster stalls every "
                f"outage — use >= 2 nodes")


class TimedDrain(FaultModel):
    """Graceful decommission of one node (picked by seed) at ``t``,
    returned to service 900 s later: running gangs finish, the
    placement engine stops routing new gangs there."""

    OUTAGE = 900.0

    def __init__(self, t: int):
        if t < 0:
            raise ValueError(f"drain time must be >= 0, got {t}")
        self.t = float(t)
        self.spec = f"drain_{t}"

    def schedule(self, cluster, seed, horizon):
        n = len(cluster.node_specs())
        node = seed % n
        return (FaultEvent(self.t, DRAIN, node),
                FaultEvent(self.t + self.OUTAGE, RECOVER, node))


class Stragglers(FaultModel):
    """``k`` distinct seed-picked nodes degrade to half speed at t=0 and
    never recover: synchronous rings placed there run at the straggler's
    pace, so placement-aware policies should route around them."""

    FACTOR = 0.5

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"straggler count must be >= 1, got {k}")
        self.k = k
        self.spec = f"stragglers_{k}"

    def schedule(self, cluster, seed, horizon):
        rng = np.random.default_rng((seed, 0x57A6))
        n_nodes = len(cluster.node_specs())
        k = min(self.k, n_nodes)
        nodes = sorted(int(i) for i in
                       rng.choice(n_nodes, size=k, replace=False))
        return tuple(FaultEvent(0.0, DEGRADE, node, self.FACTOR)
                     for node in nodes)

    def validate(self, cluster):
        if self.k >= len(cluster.node_specs()):
            raise ValueError(
                f"{self.spec!r} would degrade every node of a "
                f"{len(cluster.node_specs())}-node cluster — leave at "
                f"least one at full speed")


class RackOutage(FaultModel):
    """Correlated failure: the first half of the fleet (one 'rack') dies
    at ``t`` and recovers 900 s later.  Stresses mass eviction + requeue
    and the capacity-shortfall path."""

    OUTAGE = 900.0

    def __init__(self, t: int):
        if t < 0:
            raise ValueError(f"rack outage time must be >= 0, got {t}")
        self.t = float(t)
        self.spec = f"rack_{t}"

    def schedule(self, cluster, seed, horizon):
        n = len(cluster.node_specs())
        rack = range(n // 2)
        events = [FaultEvent(self.t, FAIL, node) for node in rack]
        events += [FaultEvent(self.t + self.OUTAGE, RECOVER, node)
                   for node in rack]
        return tuple(events)

    def validate(self, cluster):
        if len(cluster.node_specs()) < 2:
            raise ValueError(
                f"{self.spec!r} needs >= 2 nodes (half the fleet must "
                f"leave survivors)")


_FAULT_REGISTRY: dict[str, object] = {}


def register_fault_model(name: str, factory) -> None:
    """Register a fault model; ``factory(param)`` receives the spec
    suffix (``"3"`` for ``"churn_3"``, None for a bare name)."""
    if name in _FAULT_REGISTRY:
        raise ValueError(f"fault model {name!r} already registered")
    _FAULT_REGISTRY[name] = factory


def registered_fault_models() -> tuple[str, ...]:
    return tuple(sorted(_FAULT_REGISTRY))


def get_fault_model(spec) -> FaultModel:
    """Resolve a spec string (or pass through a FaultModel instance)."""
    if isinstance(spec, FaultModel):
        return spec
    if not isinstance(spec, str) or not spec:
        raise ValueError(
            f"fault spec must be a non-empty string or FaultModel, "
            f"got {spec!r}")
    base, param = _split_spec(_FAULT_REGISTRY, spec)
    factory = _FAULT_REGISTRY.get(base)
    if factory is None:
        raise ValueError(
            f"unknown fault model {spec!r}; registered: "
            f"{', '.join(registered_fault_models())}")
    return factory(param)


def _none_factory(param):
    _no_param("none", param, noun="fault model")
    return NoFaults()


register_fault_model("none", _none_factory)
register_fault_model("kill",
                     lambda p: ScheduledKill(_int_param(
                         "kill", p, "kill_1800", noun="fault model")))
register_fault_model("churn",
                     lambda p: StochasticChurn(_int_param(
                         "churn", p, "churn_3", noun="fault model")))
register_fault_model("drain",
                     lambda p: TimedDrain(_int_param(
                         "drain", p, "drain_1800", noun="fault model")))
register_fault_model("stragglers",
                     lambda p: Stragglers(_int_param(
                         "stragglers", p, "stragglers_2",
                         noun="fault model")))
register_fault_model("rack",
                     lambda p: RackOutage(_int_param(
                         "rack", p, "rack_1800", noun="fault model")))
