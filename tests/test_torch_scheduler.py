"""The port's solvers give the reference's allocations, on the CPU.

Over 50 seeded random job sets (each package builds its own ``JobSpec``s
from the same numpy draws: table2 and analytic speed modes, gradient
sizes from ResNet-110's to an LLM's, per-job caps), the callable solvers
``doubling_heuristic``, ``optimus_greedy``, ``exact_dp`` (all w and
powers of two) and ``fixed``, their ``_table`` and ``_soa`` forms, and
the reference engine's seed solvers give identical allocations; the
registries list the same policies, placements, admission rules and fault
models, and every registered policy allocates the same on the same view.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np

from repro.collectives import cost as jcost
from repro.core import _reference as jref
from repro.core import faults as jfaults
from repro.core import jobs as jjobs
from repro.core import placement as jplace
from repro.core import scheduler as jS
from repro_torch.collectives import cost as tcost
from repro_torch.core import _reference as tref
from repro_torch.core import faults as tfaults
from repro_torch.core import jobs as tjobs
from repro_torch.core import placement as tplace
from repro_torch.core import scheduler as tS

SEEDS = range(50)


def job_set(seed: int, jobs_module):
    """(specs, remaining work Q, capacity) drawn from ``seed``; the specs
    are ``jobs_module.JobSpec`` instances."""
    rng = np.random.default_rng([seed, 24])
    n = int(rng.integers(1, 13))
    capacity = int(rng.choice([4, 8, 12, 16, 32, 64]))
    specs, Q = [], []
    for j in range(n):
        mode = "table2" if rng.uniform() < 0.5 else "analytic"
        specs.append(jobs_module.JobSpec(
            job_id=j, arrival=0.0, epochs=float(rng.uniform(10, 200)),
            speed_mode=mode, n_bytes=float(rng.choice([6.9e6, 1e8, 3.1e9])),
            max_w=int(rng.choice([1, 2, 4, 8, 16, 64]))))
        Q.append(float(rng.uniform(1.0, 200.0)))
    return specs, np.array(Q), capacity


@pytest.mark.parametrize("seed", SEEDS)
def test_solvers_allocate_as_the_reference(seed):
    out = {}
    for key, jobs_module, S, ref in (("j", jjobs, jS, jref), ("t", tjobs, tS, tref)):
        specs, Q, C = job_set(seed, jobs_module)
        calls = [(s.job_id, q, s.speed) for s, q in zip(specs, Q)]
        cap_w = max(s.max_w for s in specs)
        tables = [(s.job_id, q, list(s.speed_table(C))) for s, q in zip(specs, Q)]
        arr = np.stack([s.speed_table(C) for s in specs])
        caps = np.array([s.max_w for s in specs], np.int64)
        r = {"doubling": S.doubling_heuristic(calls, C),
             "doubling_capped": S.doubling_heuristic(calls, C, max_w=cap_w),
             "optimus": S.optimus_greedy(calls, C),
             "optimus_capped": S.optimus_greedy(calls, C, max_w=cap_w),
             "fixed": [S.fixed(calls, C, w) for w in (1, 2, 4, 8)],
             "doubling_table": S.doubling_heuristic_table(tables, C),
             "doubling_table_caps": S.doubling_heuristic_table(tables, C, list(caps)),
             "optimus_table": S.optimus_greedy_table(tables, C),
             "doubling_soa": S.doubling_heuristic_soa(Q, arr, C).tolist(),
             "doubling_soa_caps": S.doubling_heuristic_soa(Q, arr, C, caps).tolist(),
             "optimus_soa": S.optimus_greedy_soa(Q, arr, C).tolist(),
             "optimus_soa_caps": S.optimus_greedy_soa(Q, arr, C, caps).tolist(),
             "fixed_soa": [S.fixed_soa(len(Q), C, w).tolist() for w in (1, 2, 4, 8)],
             "doubling_ref": ref.doubling_heuristic_ref(calls, C),
             "optimus_ref": ref.optimus_greedy_ref(calls, C)}
        if len(specs) <= C and C <= 16:
            r["exact"] = S.exact_dp(calls, C)
            r["exact_pow2"] = S.exact_dp(calls, C, powers_of_two=True)
            r["exact_table"] = S.exact_dp_table(tables, C)
            r["exact_ref"] = ref.exact_dp_ref(calls, C)
        r["total"] = [S.total_time(calls, r[k]) for k in ("doubling", "optimus")]
        out[key] = r
    assert out["t"].keys() == out["j"].keys()
    for k in out["j"]:
        assert out["t"][k] == out["j"][k], k


def test_registries_equal_reference():
    assert tS.registered_policies() == jS.registered_policies()
    assert tplace.registered_placements() == jplace.registered_placements()
    assert tplace.registered_admissions() == jplace.registered_admissions()
    assert tfaults.registered_fault_models() == jfaults.registered_fault_models()
    for spec in list(jS.registered_policies().values()) + [
            "fixed_1", "fixed_4", "pack_precompute", "pack_fixed_8", "pack_utility_greedy"]:
        assert tS.get_policy(spec).spec == jS.get_policy(spec).spec
    for bad in ("bogus", "pack", "fixed", "fixed_x"):
        with pytest.raises(ValueError) as want:
            jS.get_policy(bad)
        with pytest.raises(ValueError) as got:
            tS.get_policy(bad)
        assert str(got.value) == str(want.value), bad


@pytest.mark.parametrize("seed", range(5))
def test_every_policy_allocates_as_the_reference(seed):
    """Each registered policy's target on the same SoA view, flat and on a
    multi-node cluster."""
    out = {}
    for key, jobs_module, S, cost in (("j", jjobs, jS, jcost), ("t", tjobs, tS, tcost)):
        specs, Q, _ = job_set(seed, jobs_module)
        targets = {}
        for kw in (dict(capacity=32),
                   dict(capacity=32, gpus_per_node=8, inter_node_beta=1 / 1.25e8,
                        contention_penalty=0.05)):
            cluster = cost.ClusterModel(**kw)
            view = S.AllocView(remaining=Q.copy(),
                               tables=np.stack([s.speed_table(cluster) for s in specs]),
                               max_w=np.array([s.max_w for s in specs], np.int64),
                               explore_started=np.full(len(specs), -np.inf))
            for spec in S.registered_policies().values():
                targets[(spec, kw.get("gpus_per_node"))] = np.asarray(
                    S.get_policy(spec).allocate(view, cluster, 0.0)).tolist()
        out[key] = targets
    assert out["t"] == out["j"]
