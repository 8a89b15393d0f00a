"""The port's simulator gives the reference's ``SimResult`` bit for bit, on
the CPU.

Each package draws its own traces from its own ``make_workload`` (the same
seeds) and simulates them on its own ``ClusterModel``; completion and
arrival times are compared as ``float.hex``, with peak concurrency,
rejections, migrations and evictions:

* every registered policy x every workload pattern at 120 jobs on the
  paper's flat 64-GPU cluster (table engine);
* the cluster variants of the reference's own tests
  (``tests/test_placement.py``, ``test_faults.py``, ``test_simulator.py``):
  multi-node with ``inter_node_beta`` and a contention penalty; packed,
  spread and best_fit placement; heterogeneous nodes; admission; defrag;
  fault models; every registered policy on each;
* one telemetered run, whose rollup matches (wall-clock timers aside);
* the reference engine on a small subset, which also matches the port's
  table engine;
* ``run_table3()`` with its defaults.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses

from repro.collectives import cost as jcost
from repro.core import jobs as jjobs
from repro.core import scheduler as jS
from repro.core import simulator as jsim
from repro.core import telemetry as jtele
from repro_torch.collectives import cost as tcost
from repro_torch.core import jobs as tjobs
from repro_torch.core import simulator as tsim
from repro_torch.core import telemetry as ttele

POLICIES = sorted(jS.registered_policies().values())
PATTERNS = sorted(jjobs.WORKLOAD_PATTERNS)
PACKAGES = {"j": (jcost, jjobs, jsim), "t": (tcost, tjobs, tsim)}


def frag(c, **kw):
    """tests/test_placement.py's FRAG on the cost module ``c``."""
    return c.ClusterModel(capacity=32, gpus_per_node=8, inter_node_beta=1.0 / 1.25e8,
                          contention_penalty=0.05, **{"placement": "best_fit",
                                                      "defrag": True, **kw})


def hetero(c):
    slow = dataclasses.replace(c.INFINIBAND_100G, beta=4.0 / 12.5e9, gamma=4.0 / 50e9,
                               name="ib_25g_class")
    return c.ClusterModel(capacity=16, nodes=(c.NodeSpec(8, hw=slow), c.NodeSpec(8)),
                          inter_node_beta=1.0 / 1.25e8, placement="packed")


def ancient(c):
    old = dataclasses.replace(c.INFINIBAND_100G, gamma=1000.0 / 50e9, name="ancient")
    return c.ClusterModel(capacity=16, nodes=(c.NodeSpec(4), c.NodeSpec(4),
                                              c.NodeSpec(8, hw=old)),
                          inter_node_beta=1.0 / 1.25e9, placement="packed", defrag=True)


# name -> (cluster from the cost module, workload pattern, jobs, gap s, seed)
CLUSTERS = {
    "multinode_contention": (lambda c: c.ClusterModel(
        capacity=32, gpus_per_node=8, inter_node_beta=1.0 / 1.25e8,
        contention_penalty=0.05), "mixed_maxw", 30, 500.0, 7),
    "packed": (lambda c: frag(c, placement="packed", defrag=False), "mixed_maxw", 30, 500.0, 7),
    "spread": (lambda c: frag(c, placement="spread", defrag=False), "mixed_maxw", 30, 500.0, 7),
    "best_fit_defrag": (frag, "mixed_maxw", 30, 400.0, 5),
    "flat_placed": (lambda c: c.ClusterModel(capacity=64, placement="packed"),
                    "poisson", 60, 500.0, 0),
    "heterogeneous": (hetero, "poisson", 20, 400.0, 2),
    "heterogeneous_defrag": (ancient, "mixed_maxw", 20, 400.0, 3),
    "queue_cap": (lambda c: c.ClusterModel(capacity=16, placement="packed",
                                           admission="queue_cap_4"), "bursty", 30, 100.0, 1),
    "free_gpus": (lambda c: c.ClusterModel(capacity=16, placement="packed",
                                           admission="free_gpus_8"), "bursty", 30, 100.0, 1),
    "churn": (lambda c: frag(c, faults="churn_3", fault_seed=5, checkpoint_interval=200.0),
              "mixed_maxw", 20, 500.0, 7),
    "kill": (lambda c: frag(c, faults="kill_2000", fault_seed=3), "mixed_maxw", 16, 400.0, 2),
    "drain": (lambda c: frag(c, faults="drain_2000", fault_seed=3), "mixed_maxw", 16, 400.0, 2),
    "rack": (lambda c: frag(c, faults="rack_7000", fault_seed=3), "mixed_maxw", 16, 400.0, 2),
    "stragglers": (lambda c: frag(c, faults="stragglers_1", fault_seed=3),
                   "mixed_maxw", 16, 400.0, 2),
}


def outcome(res) -> dict:
    return {"strategy": res.strategy,
            "completion_times": {j: t.hex() for j, t in res.completion_times.items()},
            "arrival_times": {j: t.hex() for j, t in res.arrival_times.items()},
            "peak_concurrency": res.peak_concurrency, "rejected": res.rejected,
            "migrations": res.migrations, "evictions": res.evictions}


def both(run) -> tuple[dict, dict]:
    """``run(cost, jobs, simulator)`` in each package."""
    return tuple(run(*PACKAGES[k]) for k in ("j", "t"))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("policy", POLICIES)
def test_flat_cluster_equals_reference(policy, pattern):
    want, got = both(lambda c, jobs, sim: outcome(sim.simulate(
        jobs.make_workload(pattern, 120, 300.0, 11), 64, policy)))
    assert got == want
    assert len(got["completion_times"]) == 120


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_cluster_variants_equal_reference(name):
    make, pattern, n, gap, seed = CLUSTERS[name]
    want, got = both(lambda c, jobs, sim: [
        outcome(sim.simulate(jobs.make_workload(pattern, n, gap, seed), strategy=p,
                             cluster=make(c))) for p in POLICIES])
    assert got == want


def test_telemetered_run_equals_reference():
    def run(c, jobs, sim):
        tele = jtele if sim is jsim else ttele
        res = sim.simulate(jobs.make_workload("mixed_maxw", 30, 400.0, 5),
                           strategy="precompute", cluster=frag(c),
                           telemetry=tele.Telemetry(sink=tele.MemorySink()))
        rollup = res.telemetry.rollup()
        timers = rollup.pop("timers")
        return outcome(res), rollup, sorted(timers), res.telemetry.events
    want, got = both(run)
    assert got == want
    assert got[2] and got[1]["n_completed"] == 30 and len(got[3]) > 100


@pytest.mark.parametrize("cluster", ["flat", "best_fit_defrag", "churn"])
def test_reference_engine_equals_reference(cluster):
    """The port's reference engine against the reference's, and against
    the port's table engine."""
    def run(c, jobs, sim):
        cl = c.ClusterModel(capacity=64) if cluster == "flat" else CLUSTERS[cluster][0](c)
        trace = jobs.make_workload("mixed_maxw", 15, 400.0, 4)
        return [(outcome(sim.simulate(trace, strategy=p, cluster=cl, engine="reference")),
                 outcome(sim.simulate(trace, strategy=p, cluster=cl)))
                for p in ("precompute", "exploratory", "fixed_4", "srtf")]
    want, got = both(run)
    assert got == want
    assert all(ref == table for ref, table in got)


def test_run_table3_equals_reference():
    want, got = both(lambda c, jobs, sim: {
        level: {s: v.hex() for s, v in row.items()} for level, row in sim.run_table3().items()})
    assert got == want
    assert tsim.TABLE3_STRATEGIES == jsim.TABLE3_STRATEGIES
