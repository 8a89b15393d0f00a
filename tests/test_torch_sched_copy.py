"""The port's scheduler stack is the reference's, on the CPU.

* ``repro_torch.core.{convergence, resource_model, jobs, telemetry,
  scheduler, faults, placement, _reference, simulator}`` are the
  reference's modules with ``repro.`` rewritten to ``repro_torch.`` and
  nothing else changed (their whole source).
* ``repro_torch.collectives.cost`` differs on purpose: it states no TPU
  coefficient, its ``HardwareCoefficients`` has no field defaults, and the
  paper's ``INFINIBAND_100G`` is the default of its free functions. Every
  function gives the reference's outputs bit for bit (``==`` on floats,
  ``np.array_equal`` on arrays) for w = 1..64, n in {6.9e6, 3.1e9}, every
  algorithm, under ``INFINIBAND_100G`` and under a coefficient set built
  here; ``ClusterModel`` validates with the reference's messages.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np

from repro.collectives import cost as jcost
from repro_torch.collectives import cost as tcost

MODULES = ("convergence", "resource_model", "jobs", "telemetry", "scheduler",
           "faults", "placement", "_reference", "simulator")
WS = range(1, 65)
NS = (6.9e6, 3.1e9)
ALGOS = (None, "ring", "doubling_halving", "binary_blocks")
BUILT = dict(alpha=5e-6, beta=1.0 / 2.5e10, gamma=1.0 / 1.0e11, name="built")


def pow2(w: int) -> bool:
    return w & (w - 1) == 0


def coefficients(which: str):
    """The same coefficients in each package: (reference's, port's)."""
    if which == "ib_100g":
        return jcost.INFINIBAND_100G, tcost.INFINIBAND_100G
    return jcost.HardwareCoefficients(**BUILT), tcost.HardwareCoefficients(**BUILT)


# ------------------------------------------------------- source copies ----
@pytest.mark.parametrize("name", MODULES)
def test_module_is_the_reference_text(name):
    mine = importlib.import_module(f"repro_torch.core.{name}")
    theirs = importlib.import_module(f"repro.core.{name}")
    assert inspect.getsource(mine) == inspect.getsource(theirs).replace(
        "repro.", "repro_torch.")


def test_cost_states_no_tpu_coefficient():
    text = Path(tcost.__file__).read_text()
    for word in ("TPU", "v5e", "ICI", "VPU"):
        assert word not in text, word
    assert not hasattr(tcost, "TPU_V5E")
    with pytest.raises(TypeError):
        tcost.HardwareCoefficients()
    assert dataclasses.astuple(tcost.INFINIBAND_100G) == dataclasses.astuple(
        jcost.INFINIBAND_100G)
    for fn in ("t_ring", "t_dh", "t_bb", "step_time", "step_time_table",
               "simulated_step_time"):
        assert inspect.signature(getattr(tcost, fn)).parameters["hw"].default is \
            tcost.INFINIBAND_100G, fn
    assert tcost.ClusterModel().hw is tcost.INFINIBAND_100G


def test_cost_keeps_the_rest_of_the_reference():
    """Outside the coefficients, each function's source is the reference's."""
    for name in ("NodeSpec", "ClusterModel", "_log2"):
        assert inspect.getsource(getattr(tcost, name)) == inspect.getsource(
            getattr(jcost, name)).replace("repro.", "repro_torch."), name
    for name in ("t_ring", "t_dh", "t_bb", "step_time", "step_time_table",
                 "simulated_step_time"):
        mine = inspect.getsource(getattr(tcost, name)).replace(" ", "").replace("\n", "")
        theirs = inspect.getsource(getattr(jcost, name)).replace(
            "repro.", "repro_torch.").replace("TPU_V5E", "INFINIBAND_100G")
        assert mine == theirs.replace(" ", "").replace("\n", ""), name


# ---------------------------------------------------- cost, bit for bit ----
@pytest.mark.parametrize("which", ["ib_100g", "built"])
@pytest.mark.parametrize("n", NS)
def test_closed_forms_equal_reference(which, n):
    jhw, thw = coefficients(which)
    m, T_fwd, T_back = 128, 108e-3 / 128, 236.5e-3 / 128
    for w in WS:
        for fn in ("t_ring", "t_dh", "t_bb"):
            got = getattr(tcost, fn)(m, T_fwd, T_back, w, n, thw)
            assert got == getattr(jcost, fn)(m, T_fwd, T_back, w, n, jhw), (fn, w)
        for algo in ALGOS:
            got = tcost.step_time(m, T_fwd, T_back, w, n, thw, algo)
            assert got == jcost.step_time(m, T_fwd, T_back, w, n, jhw, algo), (algo, w)
    ws = np.arange(1, 65, dtype=float)
    for threshold in (1e7, 1e10):
        assert np.array_equal(
            tcost.step_time_table(m, T_fwd, T_back, ws, n, thw, threshold),
            jcost.step_time_table(m, T_fwd, T_back, ws, n, jhw, threshold))
    for fn in ("t_ring", "t_dh", "t_bb"):
        assert np.array_equal(getattr(tcost, fn)(m, T_fwd, T_back, ws, n, thw),
                              getattr(jcost, fn)(m, T_fwd, T_back, ws, n, jhw))


@pytest.mark.parametrize("which", ["ib_100g", "built"])
def test_simulated_step_time_equals_reference(which):
    jhw, thw = coefficients(which)
    for n in NS:
        for w in WS:
            algos = [None, "ring", "binary_blocks"] + (["doubling_halving"] if pow2(w) else [])
            for algo in algos:
                got = tcost.simulated_step_time(16, 1e-3, 2e-3, w, n, thw, algo)
                assert got == jcost.simulated_step_time(16, 1e-3, 2e-3, w, n, jhw, algo), (w, algo)


def test_defaults_are_the_papers_infiniband():
    """No hw given: the port uses INFINIBAND_100G, as the reference's
    scheduler always passes it."""
    ib = jcost.INFINIBAND_100G
    for n in NS:
        for w in (1, 3, 8, 64):
            for fn in ("t_ring", "t_dh", "t_bb", "step_time", "simulated_step_time"):
                assert getattr(tcost, fn)(128, 1e-3, 2e-3, w, n) == getattr(jcost, fn)(
                    128, 1e-3, 2e-3, w, n, ib), (fn, w)
        ws = np.arange(1, 65)
        assert np.array_equal(tcost.step_time_table(128, 1e-3, 2e-3, ws, n),
                              jcost.step_time_table(128, 1e-3, 2e-3, ws, n, ib))


def _bad_clusters(c):
    """ClusterModel arguments that the reference refuses, built from the
    cost module ``c``."""
    N = c.NodeSpec
    return [
        dict(capacity=0),
        dict(placement="bogus"),
        dict(placement="packed", admission="bogus"),
        dict(admission="queue_cap_4"),
        dict(defrag=True),
        dict(capacity=16, nodes=(N(16),)),
        dict(capacity=16, nodes=(N(16),), gpus_per_node=8, placement="packed"),
        dict(capacity=64, nodes=(N(8),), placement="packed"),
        dict(capacity=16, nodes=(N(8), N(8)), placement="packed"),
        dict(capacity=16, gpus_per_node=8),
        dict(capacity=16, gpus_per_node=0, inter_node_beta=1e-9),
        dict(capacity=16, inter_node_beta=1e-9),
        dict(capacity=16, gpus_per_node=8, inter_node_beta=1e-12),
        dict(contention_penalty=-0.1),
        dict(capacity=64, faults="churn_3"),
        dict(capacity=64, checkpoint_interval=100.0),
        dict(capacity=8, placement="packed", faults="rack_100"),
        dict(capacity=16, gpus_per_node=8, inter_node_beta=1e-9, placement="packed",
             faults="churn_3", checkpoint_interval=0.0),
    ]


@pytest.mark.parametrize("case", range(len(_bad_clusters(jcost))))
def test_cluster_model_refuses_as_the_reference(case):
    with pytest.raises((ValueError, KeyError)) as want:
        jcost.ClusterModel(**_bad_clusters(jcost)[case])
    with pytest.raises(type(want.value)) as got:
        tcost.ClusterModel(**_bad_clusters(tcost)[case])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="NodeSpec.gpus must be >= 1"):
        tcost.NodeSpec(0)


def test_cluster_model_methods_equal_reference():
    for kw in (dict(capacity=8), dict(capacity=20, gpus_per_node=8, inter_node_beta=1e-9),
               dict(capacity=32, gpus_per_node=8, inter_node_beta=1 / 1.25e8,
                    contention_penalty=0.05, placement="best_fit", defrag=True)):
        j, t = jcost.ClusterModel(**kw), tcost.ClusterModel(**kw)
        assert j.is_flat == t.is_flat
        assert [n.gpus for n in j.node_specs()] == [n.gpus for n in t.node_specs()]
        ws = np.arange(0, 40)
        assert np.array_equal(j.spans_nodes(ws), t.spans_nodes(ws))
        assert j.spans_nodes(9) == t.spans_nodes(9)
        for k in range(0, 6):
            assert j.contention_factor(k) == t.contention_factor(k)
        if j.inter_node_beta is not None:
            assert dataclasses.astuple(j.inter_hw()) == dataclasses.astuple(t.inter_hw())
