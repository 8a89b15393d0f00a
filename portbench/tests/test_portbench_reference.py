"""The reference against the port at a smoke size, and the comparison that
decides ``correct`` against faults planted under the timed path: a run
that skips the look for a card and drives the rest on the CPU."""
import pytest
import torch

from portbench import harness
from portbench.tests import portbench_smoke as S

CELLS = ("qwen2.5-3b.train", "mamba2-780m.train")


def readings(cell, seed, fault=None):
    dev = torch.device("cpu")
    prog = harness.Program(cell, dev, 1, fault=fault)
    feed = harness.Feed(cell, seed, 0, dev)
    state = prog.init_state(seed)
    _, got, _ = harness.checked_steps(prog, state, feed, seed, cell.traffic["adamw"],
                                      cell.traffic["checked_steps"])
    return got, harness.reference_readings(cell, seed, feed, dev)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_in_f32(name):
    """Same weights, same batches, f32 activations: the port's three steps
    and the plain reference's agree to f32 rounding."""
    with harness.f32_activations():
        got, ref = readings(S.cell(name), 2**40 + 3)
    g = harness.compare.gaps(got, ref)
    assert g["loss_gap"] < 1e-6 and g["grad_gap"] < 1e-4 and g["change_gap"] < 1e-3, g


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = S.run(S.cell(name))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_tokens_per_s", "train_mfu", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    r = S.run(S.cell(name), fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bf16_masters_fails(name):
    """The reference with bf16 parameters and moments, in the program's
    place, fails the change's limit."""
    cell = S.cell(name)
    dev = torch.device("cpu")
    seed = 2**35 + 11
    feed = harness.Feed(cell, seed, 0, dev)
    ref = harness.reference_readings(cell, seed, feed, dev)
    low = harness.reference_readings(cell, seed, feed, dev, master=torch.bfloat16)
    g = harness.compare.gaps(low, ref)
    assert g["change_gap"] > cell.limits["limits"]["change_gap"], g


@pytest.mark.parametrize("fault", [None, "no_exchange", "unchanged", "half_batch"])
def test_four_ranks_over_gloo(fault):
    """A four-card cell's path on four CPU ranks: sound it is correct; with
    the ranks' exchange left out, the state unchanged or half of each
    rank's rows left out it is not."""
    r = S.run(S.four_ranks(S.cell("qwen2.5-3b.train")), fault=fault)
    assert r["correct"] is (fault is None), r["checks"]
    assert r["device"]["count"] == 4


def test_traced_run_reports_per_layer_metrics():
    r = S.run(S.cell("qwen2.5-3b.train"), trace=True)
    assert r["correct"]
    # on the CPU no kernel reaches a CUDA timeline: the device readers are silent
    assert "step_ms_p90" in r["metrics"] and "rmsnorm_roofline" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
