"""The data-parallel train step against the reference, on the CPU in f32:
ResNet smoke (depth 8, width 8), the reference's bf16 cast patched to f32
(``_torch_parity.patch_resnet_f32``), the port built in f32, from one JAX
init carried across by ``repro_torch.bridge``.

* JAX: ``make_train_step(grad_exchange=...)`` under ``shard_map`` on 4
  host devices (a subprocess) for "ring", "doubling_halving" and "psum",
  and "ring" with ``microbatches=2``; 2 steps on ``CifarLike`` batches of
  4 rows per rank.
* Port: 4 gloo ranks (``launch.explicit_allreduce``) on the same batches.
  The update p2 - p0 agrees with the reference's to 1e-5 of its largest
  element (reached: below 7e-7; the reference's own ring-against-psum
  bound, ``tests/test_collectives_shardmap.py``, is ``atol=2e-3``), and
  so does rank 0's loss, relatively.
* Gradient accumulation: the port's one-process ``microbatches=4`` step
  against the reference's ``make_train_step(microbatches=4)`` and against
  the port's unsplit step, to the same 1e-5 (reached: below 7e-7; mirrors
  ``tests/test_system.py::test_microbatch_equivalence``).
* Against a reference file (the route of a full-width run, where no rank
  ships its parameters): ``one_process_updates`` saves the one-process
  update, which agrees with the reference's ring update to the same 1e-5;
  2 ranks under psum and ring, with no first-step check, measure their
  own updates against it (relative L2) and psum's spread across them,
  each within 1e-5.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.checkpoint.store import _flatten
from repro.configs.resnet110 import smoke_config as jax_smoke_config
from repro.models.resnet import ResNetModel as JResNetModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.resnet110 import smoke_config
from repro_torch.engine.steps import make_train_step
from repro_torch.launch import explicit_allreduce as ea
from repro_torch.models.resnet import ResNetModel
from repro_torch.models.spec import views
from repro_torch.optim import sgd

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
RUN = ea.DPRun(cfg=smoke_config(), world=4, algorithms=("psum", "ring", "doubling_halving"),
               steps=2, m_per_worker=4, base_lr_1w=0.05, dtype=torch.float32,
               device="cpu", timeout_s=60)

JAX_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np, pytest
from jax.sharding import Mesh, PartitionSpec as P
from repro.checkpoint.store import _flatten
from repro.configs.resnet110 import smoke_config
from repro.data.synthetic import CifarLike
from repro.engine.steps import make_train_step
from repro.models.resnet import ResNetModel
from repro.optim.optimizers import sgd
from _torch_parity import patch_resnet_f32

W, STEPS, M, LR = 4, 2, 4, 0.05 * 4
patch_resnet_f32(pytest.MonkeyPatch())
model, opt = ResNetModel(smoke_config()), sgd()
params = model.init(jax.random.PRNGKey(0))
flat0 = {k: np.asarray(v) for k, v in _flatten(params).items()}
data = CifarLike()
batches = [{k: jnp.asarray(v) for k, v in data.batch(s, M * W).items()} for s in range(STEPS)]
mesh = Mesh(np.array(jax.devices()[:W]), ("data",))

def train(step):
    state = {"params": params, "opt": opt.init(params)}
    losses = []
    for b in batches:
        state, loss = step(state, b, jnp.float32(LR))
        losses.append(float(loss))
    flat = _flatten(state["params"])
    return np.concatenate([(np.asarray(flat[k]) - flat0[k]).ravel() for k in sorted(flat)]), losses

out = {f"init/{k}": v for k, v in flat0.items()}
for name, alg, k in (("psum", "psum", 1), ("ring", "ring", 1),
                     ("doubling_halving", "doubling_halving", 1), ("ring_mb2", "ring", 2)):
    step = jax.jit(jax.shard_map(
        make_train_step(model, opt, grad_exchange=alg, microbatches=k), mesh=mesh,
        in_specs=(P(), {"images": P("data"), "labels": P("data")}, P()),
        out_specs=(P(), P()), check_vma=False))
    out[f"update/{name}"], out[f"losses/{name}"] = train(step)
out["update/mb4"], out["losses/mb4"] = train(jax.jit(make_train_step(model, opt, microbatches=4)))
np.savez(sys.argv[1], **out)
"""


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's updates and losses (a subprocess), and the port's
    4-rank runs from the reference's init, which runs meanwhile."""
    path = tmp_path_factory.mktemp("jax_dp") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        jparams = JResNetModel(jax_smoke_config()).init(jax.random.PRNGKey(0))
        init = params_from_numpy({k: np.asarray(v) for k, v in _flatten(jparams).items()},
                                 RUN.cfg, "cpu").flat
        run = dataclasses.replace(RUN, init=init)
        mb2 = dataclasses.replace(run, algorithms=("ring",), microbatches=2)
        port, port_mb2 = ea.run(run), ea.run(mb2)
        ref_dir = tmp_path_factory.mktemp("dp_reference")
        digest0, paths, scale = ea.one_process_updates(run, ref_dir)
        against = dataclasses.replace(run, world=2, m_per_worker=2 * run.m_per_worker,
                                      base_lr_1w=2 * run.base_lr_1w,  # the same LR
                                      algorithms=("psum", "ring"), check_exchange=False,
                                      reference=str(paths[-1]))
        reference = {"run": against, "ranks": ea.run(against), "digest": digest0,
                     "paths": paths, "scale": scale}
        _, stderr = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr
    with np.load(path) as z:
        jax_out = {k: z[k] for k in z.files}
    assert all(np.array_equal(jax_out[f"init/{k}"], np.asarray(v))
               for k, v in _flatten(jparams).items())
    return {"jax": jax_out, "init": init, "run": run, "port": port, "port_mb2": port_mb2,
            "reference": reference}


def updates(ranks, alg, init):
    return [(r["algorithms"][alg]["params"] - init).numpy() for r in ranks]


@pytest.mark.parametrize("alg", ["psum", "ring", "doubling_halving"])
def test_dp_update_matches_reference(runs, alg):
    want = runs["jax"][f"update/{alg}"]
    for r, got in enumerate(updates(runs["port"], alg, runs["init"])):
        assert rel(got, want) <= TOL, f"rank {r}"
    np.testing.assert_allclose(runs["port"][0]["algorithms"][alg]["losses"],
                               runs["jax"][f"losses/{alg}"], rtol=TOL)


@pytest.mark.parametrize("alg", ["psum", "ring", "doubling_halving"])
def test_dp_ranks_hold_one_set_of_parameters(runs, alg):
    """ring and halving-doubling hand every rank one sum, so the ranks'
    parameters are bit-identical; psum's order is gloo's."""
    flats = [r["algorithms"][alg]["params"] for r in runs["port"]]
    summary = ea.summary(runs["run"], runs["port"])
    assert summary["same_init"]
    if alg != "psum":
        assert summary["algorithms"][alg]["ranks_bit_identical"]
        assert all(torch.equal(f, flats[0]) for f in flats)
    upd = updates(runs["port"], alg, runs["init"])
    assert all(rel(u, upd[0]) <= TOL for u in upd)


@pytest.mark.parametrize("alg", ["psum", "ring", "doubling_halving"])
def test_dp_first_step_exchange_and_no_launches_on_the_cpu(runs, alg):
    for r in runs["port"]:
        assert r["transport"] == "gloo"
        assert r["exchange"][alg]["max_rel_err_vs_psum"] <= TOL
        assert r["algorithms"][alg]["launches"] == {
            "rmsnorm": 0, "swa_attention": 0, "fused_sgd_update": 0, "ssd": 0,
            "ssd_backward": 0}
        assert len(r["algorithms"][alg]["losses"]) == RUN.steps
        assert len(r["algorithms"][alg]["exchange_ms"]) == RUN.steps


def test_dp_microbatches_compose_with_ring(runs):
    want = runs["jax"]["update/ring_mb2"]
    for got in updates(runs["port_mb2"], "ring", runs["init"]):
        assert rel(got, want) <= TOL
    np.testing.assert_allclose(runs["port_mb2"][0]["algorithms"]["ring"]["losses"],
                               runs["jax"]["losses/ring_mb2"], rtol=TOL)


def test_microbatches_match_reference_and_unsplit_step(runs):
    """One process, the global batch of 16 in 4 microbatches of 4."""
    model = ResNetModel(RUN.cfg, torch.float32)
    shapes = model.init(torch.Generator().manual_seed(0), "cpu").shapes()
    got = {}
    for k in (1, 4):
        params = views(runs["init"].clone(), shapes)
        state = {"params": params, "opt": sgd().init(params)}
        step = make_train_step(model, sgd(), microbatches=k, device="cpu")
        losses = []
        for b in dataclasses.replace(RUN, world=1, m_per_worker=16).batches():
            state, loss = step(state, b, RUN.lr)
            losses.append(float(loss))
        got[k] = ((state["params"].flat - runs["init"]).numpy(), losses)
    assert rel(got[4][0], runs["jax"]["update/mb4"]) <= TOL
    np.testing.assert_allclose(got[4][1], runs["jax"]["losses/mb4"], rtol=TOL)
    assert rel(got[4][0], got[1][0]) <= TOL
    np.testing.assert_allclose(got[4][1], got[1][1], rtol=TOL)


def test_dp_ranks_measure_their_update_against_a_reference_file(runs):
    ref = runs["reference"]
    assert ref["run"].lr == RUN.lr
    want = torch.load(ref["paths"][-1]).numpy()
    assert len(ref["paths"]) == RUN.steps
    assert rel(want, runs["jax"]["update/ring"]) <= TOL
    assert ref["scale"] == float(np.abs(want).max())
    summary = ea.summary(ref["run"], ref["ranks"])
    assert summary["same_init"] and ref["ranks"][0]["init_digest"] == ref["digest"]
    for alg, a in summary["algorithms"].items():
        assert max(a["update_rel_err_vs_reference"]) <= TOL, alg
        assert a["max_rel_err_vs_psum"] is None and a["exchange_ms_median"] >= 0
    assert summary["algorithms"]["psum"]["rank_spread"] / ref["scale"] <= TOL
    assert summary["algorithms"]["ring"]["ranks_bit_identical"]
    for r in ref["ranks"]:
        assert r["exchange"] == {}
        assert all("params" not in a for a in r["algorithms"].values())
