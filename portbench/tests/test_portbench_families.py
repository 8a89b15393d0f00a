"""A family of two kinds of layer and an auxiliary loss, compared through the
reference's hooks (``loss_and_grad``, ``stacks``) with no edit to the
harness: the port's Jamba-style hybrid at a smoke size, against the
test-local reference ``hybrid_family``. And the one-stack families'
segments, which the hooks must leave as they were."""
import pytest
import torch

from portbench import harness, weights
from portbench.reference import _common
from portbench.tests import hybrid_family
from portbench.tests import portbench_smoke as S


@pytest.fixture
def hybrid(monkeypatch):
    monkeypatch.setattr(harness, "family_module", lambda cell: hybrid_family)
    # no flops/hybrid.py: the family has no cell, and a CPU run's train_mfu
    # is no device number
    monkeypatch.setattr(harness, "flops_per_token", lambda cell: 1.0)
    return S.family_cell("hybrid")


def test_hybrid_family_matches_the_port_in_f32(hybrid):
    dev, seed = torch.device("cpu"), 2**40 + 3
    with harness.f32_activations():
        prog = harness.Program(hybrid, dev, 1)
        feed = harness.Feed(hybrid, seed, 0, dev)
        _, got, _ = harness.checked_steps(prog, prog.init_state(seed), feed, seed,
                                          hybrid.traffic["adamw"],
                                          hybrid.traffic["checked_steps"])
    ref = harness.reference_readings(hybrid, seed, feed, dev)
    g = harness.compare.gaps(got, ref)
    assert g["loss_gap"] < 1e-6 and g["grad_gap"] < 1e-4 and g["change_gap"] < 1e-3, g
    # one segment a block of each leaf under blocks/, both kinds of layer
    names = ref["segments"]
    assert {"blocks/pos0/mamba/wz[1]", "blocks/pos1/attn/wq[1]", "blocks/pos1/moe/router[0]",
            "blocks/pos0/mlp/wo[0]", "embed", "unembed"} <= set(names)


def test_hybrid_program_drops_no_token(hybrid):
    """Each batch row is a dispatch group; a token takes top_k different
    experts, so an expert gets at most seq assignments a row: a capacity of
    seq slots keeps every one, as the reference routes them."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe

    seq = hybrid.traffic["seq"]
    assert moe.group_capacity(seq, ModelConfig(**hybrid.model)) >= seq


def test_hybrid_sound_run_is_correct(hybrid):
    r = S.run(hybrid)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_hybrid_planted_fault_is_not_correct(hybrid, fault):
    r = S.run(hybrid, fault=fault)
    assert not r["correct"], r["checks"]


def _one_stack_segments(layout, n_layers):
    """The segments as the comparison split them before families could
    declare their stacks: a leaf under ``layers/`` whose first dim is
    ``n_layers`` a segment a layer, any other leaf one."""
    out = []
    for path, a, b in weights.offsets(layout):
        shape = layout[path].shape
        if path.startswith("layers/") and shape and shape[0] == n_layers:
            per = (b - a) // n_layers
            out += [(f"{path}[{i}]", a + i * per, a + (i + 1) * per)
                    for i in range(n_layers)]
        else:
            out.append((path, a, b))
    return out


@pytest.mark.parametrize("name", ["qwen2.5-3b.train", "mamba2-780m.train"])
def test_one_stack_families_keep_their_segments(name):
    cell = harness.load_cell(S.bench(), name, S.ROOT)
    fam = harness.family_module(cell)
    layout = fam.layout(cell.model)
    assert not hasattr(fam, "stacks") and not hasattr(fam, "loss_and_grad")
    assert _common.segments(fam, cell.model, layout) == _one_stack_segments(
        layout, cell.model["n_layers"])


def test_the_ring_cell_is_the_four_rank_job():
    """The four-card cell's traffic is the one-card cell's job on four
    ranks under the ring with the learning rate times four: the job that
    the four-rank gloo test runs."""
    ring = harness.load_cell(S.bench(), "qwen2.5-3b.dp4-ring", S.ROOT)
    one = S.four_ranks(harness.load_cell(S.bench(), "qwen2.5-3b.train", S.ROOT))
    assert ring.chips == one.chips == 4 and ring.config == one.config
    skip = {"why", "pool_steps", "trace_steps"}
    assert ({k: v for k, v in ring.traffic.items() if k not in skip}
            == {k: v for k, v in one.traffic.items() if k not in skip})
    assert [m["name"] for m in ring.per_layer if m["name"] == "exchange_ms"]
