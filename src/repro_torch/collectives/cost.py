"""Analytic per-minibatch time models — paper §3.2 eqs. (2)–(4) verbatim.

α: latency per message [s]; β: transfer time per byte [s/B];
γ: compute cost per vector byte [s/B]; n: model gradient size [bytes];
m: per-worker minibatch; w: workers.

The coefficients are those of the paper's cluster, 100 Gbit/s (4x EDR)
InfiniBand between K40m-era hosts (``INFINIBAND_100G``, the default of every
function here and of ``ClusterModel``). No coefficient of an H100's fabric
(NVLink, NCCL) has been measured: a step time from these functions is the
paper's cluster's, not the card's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.collectives.schedules import ALGORITHMS, best_algorithm


@dataclasses.dataclass(frozen=True)
class HardwareCoefficients:
    alpha: float   # latency per message [s]
    beta: float    # transfer time per byte [s/B]
    gamma: float   # reduction compute per byte [s/B]
    name: str


# The paper's cluster: 100 Gbit/s (4x EDR) InfiniBand, K40m-era hosts.
INFINIBAND_100G = HardwareCoefficients(
    alpha=2e-6, beta=1.0 / 12.5e9, gamma=1.0 / 50e9, name="ib_100g")


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One physical node of the cluster: a GPU count plus (optionally) its
    own :class:`HardwareCoefficients` for heterogeneous fleets.  ``hw=None``
    means the node runs at the cluster-wide coefficients."""
    gpus: int
    hw: HardwareCoefficients | None = None

    def __post_init__(self):
        if self.gpus < 1:
            raise ValueError(f"NodeSpec.gpus must be >= 1, got {self.gpus}")


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """The cluster the §7 simulation schedules over.

    The paper treats the cluster as a flat homogeneous GPU count; GADGET
    (arXiv 2202.01158) and the multi-tenant contention follow-up (arXiv
    2207.07817) show ring-all-reduce scheduling changes materially once
    placement, link bandwidth and communication contention enter the
    model.  This dataclass owns all of it:

      * ``capacity`` — total GPUs (the paper's C).
      * ``hw`` — intra-node :class:`HardwareCoefficients` (α/β/γ).
      * ``gpus_per_node`` / ``inter_node_beta`` — optional node topology.
        A job whose ring spans nodes (w > gpus_per_node) pays the slower
        cross-node per-byte time ``inter_node_beta`` instead of ``hw.beta``;
        its speed table is scaled by the analytic intra/inter step-time
        ratio (see ``JobSpec.speed_table``).  ``None`` (the default) is
        the paper's flat single-fabric cluster.
      * ``contention_penalty`` — GADGET-style multi-tenant link sharing:
        when k concurrent jobs run ring all-reduce (w >= 2), each of them
        progresses at ``contention_factor(k) = 1 / (1 + penalty*(k-1))``
        of its nominal speed.  0.0 (default) disables it.  With a
        placement engine active only *node-spanning* rings contend (they
        share the inter-node fabric; intra-node rings never touch it).
      * ``restart_cost`` — checkpoint-stop-restart pause per reallocation
        (~10 s measured, paper §6).
      * ``nodes`` — explicit per-node layout (tuple of :class:`NodeSpec`)
        for heterogeneous fleets; requires ``placement``.  Mutually
        exclusive with ``gpus_per_node``, and the GPU counts must sum to
        ``capacity``.
      * ``placement`` — name of a registered
        :class:`repro_torch.core.placement.PlacementStrategy` (``"packed"``,
        ``"spread"``, ``"best_fit"``).  When set, both simulator engines
        run the node-level placement engine: each gang gets a concrete
        per-node assignment, spanning/contention status derives from the
        *actual* assignment under fragmentation (not the
        ``w > gpus_per_node`` shortcut), and policies see the flat speed
        tables plus a placement view.  ``None`` (default) keeps the
        legacy behavior.
      * ``admission`` — name of a registered admission rule
        (``"admit_all"``, ``"queue_cap_<n>"``, ``"free_gpus_<k>"``);
        non-default rules require ``placement``.
      * ``defrag`` — run the migration/defragmentation pass: at each
        reallocation event, a node-spanning gang that now fits on a
        single node is consolidated there, charging ``restart_cost``
        (the gang moves).  Requires ``placement``.
      * ``faults`` — name of a registered
        :class:`repro_torch.core.faults.FaultModel` (``"none"``,
        ``"kill_<t>"``, ``"churn_<n>"``, ``"drain_<t>"``,
        ``"stragglers_<k>"``, ``"rack_<t>"``) or an instance; with
        ``fault_seed`` it yields one deterministic incident tape per
        run, delivered identically by both simulator engines.  Requires
        ``placement`` (failures act on concrete node assignments).
      * ``fault_seed`` — seed for the fault schedule (independent of the
        workload seed, so the same trace can face different churn).
      * ``checkpoint_interval`` — progress-seconds between checkpoints
        for the lost-work charge on eviction
        (:class:`repro_torch.core.faults.CheckpointPolicy`); ``None`` uses
        ``faults.DEFAULT_CHECKPOINT_INTERVAL``.  Requires ``faults``.

    A flat homogeneous ClusterModel (defaults) reproduces the paper setup
    bit-identically — the engines and speed tables take the exact same
    code paths as a bare integer capacity.  A placement engine over a
    single node (``placement`` set, no topology) is a structural no-op:
    nothing ever spans, every factor is exactly 1.0, and trajectories
    stay bit-identical to the flat cluster (golden-value-tested).
    """
    capacity: int = 64
    hw: HardwareCoefficients = INFINIBAND_100G
    gpus_per_node: int | None = None
    inter_node_beta: float | None = None
    contention_penalty: float = 0.0
    restart_cost: float = 10.0
    nodes: tuple[NodeSpec, ...] | None = None
    placement: str | None = None
    admission: str = "admit_all"
    defrag: bool = False
    faults: object | None = None        # str spec or faults.FaultModel
    fault_seed: int = 0
    checkpoint_interval: float | None = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.nodes is not None:
            if self.gpus_per_node is not None:
                raise ValueError(
                    "pass either nodes (explicit layout) or gpus_per_node "
                    "(uniform layout), not both")
            if self.placement is None:
                raise ValueError(
                    "nodes without placement does nothing — node-level "
                    "layouts are consumed by the placement engine")
            total = sum(n.gpus for n in self.nodes)
            if total != self.capacity:
                raise ValueError(
                    f"nodes sum to {total} GPUs but capacity is "
                    f"{self.capacity}; make them agree")
            if len(self.nodes) > 1 and self.inter_node_beta is None:
                raise ValueError(
                    "a multi-node ClusterModel needs inter_node_beta "
                    "(cross-node per-byte transfer time)")
        if self.gpus_per_node is not None:
            if self.gpus_per_node < 1:
                raise ValueError(
                    f"gpus_per_node must be >= 1, got {self.gpus_per_node}")
            if self.inter_node_beta is None:
                raise ValueError(
                    "a multi-node ClusterModel needs inter_node_beta "
                    "(cross-node per-byte transfer time)")
        elif self.inter_node_beta is not None and self.nodes is None:
            # the symmetric mistake: a cross-node β without a node size
            # would silently reproduce flat-cluster results
            raise ValueError(
                "inter_node_beta without gpus_per_node does nothing — "
                "set both (multi-node) or neither (flat)")
        if self.inter_node_beta is not None:
            betas = [self.hw.beta] + [n.hw.beta for n in (self.nodes or ())
                                      if n.hw is not None]
            if self.inter_node_beta < max(betas):
                raise ValueError(
                    "inter_node_beta is faster than the intra-node link "
                    f"({self.inter_node_beta} < {max(betas)})")
        if self.contention_penalty < 0.0:
            raise ValueError(
                f"contention_penalty must be >= 0, got "
                f"{self.contention_penalty}")
        if self.placement is not None:
            # deferred import: placement builds on this module
            from repro_torch.core.placement import get_admission, get_placement
            get_placement(self.placement)          # loud unknown-name error
            get_admission(self.admission).validate(self)
        elif self.admission != "admit_all":
            raise ValueError(
                "an admission rule without placement does nothing — set "
                "placement (a single-node placement engine is a no-op) "
                "or drop admission")
        elif self.defrag:
            raise ValueError(
                "defrag without placement does nothing — the migration "
                "pass moves gangs the placement engine placed")
        if self.faults is not None:
            if self.placement is None:
                raise ValueError(
                    "faults without placement does nothing — failures "
                    "act on concrete node assignments; set placement "
                    "(a single-node placement engine is otherwise a "
                    "no-op)")
            # deferred import: faults builds on the scheduler registry
            from repro_torch.core.faults import get_fault_model
            get_fault_model(self.faults).validate(self)
        if self.checkpoint_interval is not None:
            if self.faults is None:
                raise ValueError(
                    "checkpoint_interval without faults does nothing — "
                    "lost work is only charged on eviction")
            if self.checkpoint_interval <= 0.0:
                raise ValueError(
                    f"checkpoint_interval must be > 0, got "
                    f"{self.checkpoint_interval}")

    @property
    def is_flat(self) -> bool:
        """True when this is the paper's flat homogeneous cluster."""
        return (self.gpus_per_node is None and self.contention_penalty == 0.0
                and self.placement is None)

    def node_specs(self) -> tuple[NodeSpec, ...]:
        """The node-level layout the placement engine schedules over:
        ``nodes`` verbatim, or ``capacity`` split into uniform
        ``gpus_per_node`` chunks (last node partial), or one node holding
        the whole flat cluster."""
        if self.nodes is not None:
            return self.nodes
        if self.gpus_per_node is None:
            return (NodeSpec(gpus=self.capacity),)
        full, rest = divmod(self.capacity, self.gpus_per_node)
        out = [NodeSpec(gpus=self.gpus_per_node) for _ in range(full)]
        if rest:
            out.append(NodeSpec(gpus=rest))
        return tuple(out)

    def spans_nodes(self, w) -> bool | np.ndarray:
        """Whether a w-worker ring crosses node boundaries (scalar or
        ndarray w)."""
        if self.gpus_per_node is None:
            return np.zeros_like(np.asarray(w), bool) if np.ndim(w) else False
        return np.asarray(w) > self.gpus_per_node

    def inter_hw(self) -> HardwareCoefficients:
        """Coefficients a node-spanning ring sees: cross-node β."""
        return dataclasses.replace(self.hw, beta=self.inter_node_beta,
                                   name=f"{self.hw.name}+inter")

    def contention_factor(self, n_comm: int) -> float:
        """Speed multiplier for each of ``n_comm`` concurrent ring jobs."""
        if n_comm <= 1 or self.contention_penalty == 0.0:
            return 1.0
        return 1.0 / (1.0 + self.contention_penalty * (n_comm - 1))


def _log2(w):
    """Elementwise log2 with the scalar convention lw(w<=1) = 0.

    np.log2 and math.log2 agree bit-for-bit on every integer worker count
    we ever pass (checked up to 1024), so the vectorized forms reproduce
    the original scalar results exactly.
    """
    w = np.asarray(w, float)
    return np.where(w > 1.0, np.log2(np.maximum(w, 1.0)), 0.0)


def t_ring(m, T_fwd, T_back, w, n,
           hw: HardwareCoefficients = INFINIBAND_100G):
    """Eq. (2): ring algorithm.  ``w`` may be a scalar or an ndarray."""
    w = np.asarray(w, float)
    t = (m * (T_fwd + T_back)
         + (w - 1) * 4 * hw.alpha
         + (w - 1) * (n / w) * 4 * hw.beta
         + (w - 1) * (n / w) * 2 * hw.gamma)
    return float(t) if t.ndim == 0 else t


def t_dh(m, T_fwd, T_back, w, n,
         hw: HardwareCoefficients = INFINIBAND_100G):
    """Eq. (3): doubling-halving (power-of-two w).  Scalar or ndarray w."""
    t = (m * (T_fwd + T_back)
         + 4 * _log2(w) * hw.alpha
         + 4 * n * hw.beta
         + 2.5 * n * hw.gamma)
    return float(t) if t.ndim == 0 else t


def t_bb(m, T_fwd, T_back, w, n,
         hw: HardwareCoefficients = INFINIBAND_100G):
    """Eq. (4): binary blocks (any w).  Scalar or ndarray w."""
    t = (m * (T_fwd + T_back)
         + (5 + 4 * np.ceil(_log2(w))) * hw.alpha
         + 7 * n * hw.beta
         + 3 * n * hw.gamma)
    return float(t) if t.ndim == 0 else t


def step_time(m, T_fwd, T_back, w, n,
              hw: HardwareCoefficients = INFINIBAND_100G,
              algorithm: str | None = None) -> float:
    """Per-minibatch time with the algorithm Horovod would pick (§2.1)."""
    if algorithm is None:
        algorithm = best_algorithm(w, n)
    fn = {"ring": t_ring, "doubling_halving": t_dh, "binary_blocks": t_bb}
    return fn[algorithm](m, T_fwd, T_back, w, n, hw)


def step_time_table(m, T_fwd, T_back, ws, n,
                    hw: HardwareCoefficients = INFINIBAND_100G,
                    threshold: float = 1e7) -> np.ndarray:
    """Vectorized ``step_time`` over an array of worker counts.

    Evaluates all three analytic models once over the whole array and
    selects per element with the ``best_algorithm`` rule (§2.1), so a
    full speed table costs three vectorized expressions instead of one
    Python-level dispatch per w.
    """
    ws = np.asarray(ws, float)
    wi = ws.astype(int)
    pow2 = (wi & (wi - 1)) == 0
    out = np.where(
        pow2,
        np.where(n <= threshold,
                 t_dh(m, T_fwd, T_back, ws, n, hw),
                 t_ring(m, T_fwd, T_back, ws, n, hw)),
        t_bb(m, T_fwd, T_back, ws, n, hw))
    return out


def simulated_step_time(m, T_fwd, T_back, w, n,
                        hw: HardwareCoefficients = INFINIBAND_100G,
                        algorithm: str | None = None) -> float:
    """First-principles variant: α/β/γ counters from executing the actual
    schedule (repro_torch.collectives.schedules) instead of the closed forms.
    Used to cross-validate eqs. (2)-(4)."""
    algorithm = algorithm or best_algorithm(w, n)
    # execute on a tiny vector; counters scale linearly in n
    probe = 64
    v = np.zeros((w, probe))
    _, st = ALGORITHMS[algorithm](v, itemsize=1)
    scale = n / probe
    comm = (st.steps * hw.alpha + st.bytes_sent * scale * hw.beta
            + st.bytes_reduced * scale * hw.gamma)
    return m * (T_fwd + T_back) + comm
