"""The port's sharded path on the CPU: 4 gloo ranks on a 2 x 2
("data", "model") mesh (spawned, a fresh ``file://`` rendezvous, a join
timeout), each running the prefill, the loss and its gradient, and one
SGD step through DTensors sharded by the rules, held to the one-process
port from the same weights in the same rank, with f32 activations (the
ranks are ``_torch_sharded_rank.sharded_rank``):

* the smoke qwen2.5-3b, qwen3-moe-30b-a3b and whisper-base prefill logits,
  and a 5-head qwen2.5-3b whose heads the model axis does not divide (the
  rules' head_dim fallback shards head_dim instead): relative max error
  below 1e-5;
* qwen2.5-3b's loss (1e-5 relative) and flat gradient (relative max error
  1e-5), gathered from the ranks' shards, also with 5 heads;
* one sharded SGD step at LR 0.1 makes exactly one ``fused_sgd_update``
  call a rank, over the rank's flat buffer of local shards, and lands
  within 1e-6 of the one-process step."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np
import torch

from repro_torch.launch.explicit_allreduce import spawn
from repro_torch.sharding.rules import default_rules
from _torch_sharded_rank import CASES, TOL, config, sharded_rank

WORLD = 4
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks():
    out = spawn(sharded_rank, WORLD, (WORLD, CASES, "gloo"), TIMEOUT_S)
    for r in out:
        for case in CASES:
            assert "error" not in r[case], r[case]["error"]
    return out


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def test_five_heads_take_the_head_dim_fallback():
    from repro_torch.launch.mesh import AbstractMesh

    cfg = config("qwen2.5-3b", 5)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    assert default_rules().spec_for(("layers", "embed", "heads", "head_dim"),
                                    (cfg.n_layers, cfg.d_model, 5, cfg.d_head),
                                    mesh) == (None, None, None, "model")


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "prefill"],
                         ids=lambda c: f"{c[1]}-{c[2] or 'default'}heads")
def test_sharded_prefill_equals_one_process(ranks, case):
    for r in ranks:
        got, want = r[case]["sharded"], r[case]["one"]
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert _rel_err(got, want) < TOL, (case, _rel_err(got, want))
    # the logits stay sharded: batch over "data", vocab over "model"
    assert ranks[0][case]["placements"] == ["S(0)", "S(2)"]


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "grad"],
                         ids=lambda c: f"{c[1]}-{c[2] or 'default'}heads")
def test_sharded_loss_and_gradient_equal_one_process(ranks, case):
    for r in ranks:
        (loss, grads), (sloss, sgrads) = r[case]["one"], r[case]["sharded"]
        assert abs(float(sloss) - float(loss)) <= TOL * abs(float(loss))
        assert sgrads.shape == grads.shape
        assert _rel_err(sgrads, grads) < TOL, (case, _rel_err(sgrads, grads))
        assert float(sgrads.abs().max()) > 0


def test_sharded_sgd_step_is_one_fused_update_per_rank(ranks):
    case = ("sgd", "qwen2.5-3b", None)
    for r in ranks:
        (loss, update), (sloss, supdate) = r[case]["one"], r[case]["sharded"]
        assert r[case]["sgd_calls"] == 1
        assert abs(float(sloss) - float(loss)) <= TOL * abs(float(loss))
        assert float((supdate - update).abs().max()) <= 1e-6
        assert float(update.abs().max()) > 1e-3  # the step moved the weights
