"""The LM job under the paper's exchange, against the reference, on the CPU
at smoke size (qwen2.5-3b smoke), with f32 activations in both packages
(``_torch_parity.patch_f32_embeddings``; the port's spawned ranks are
``_torch_parity.f32_train_rank`` and ``f32_dp_rank``).

* ``launch.train --grad-exchange ring`` and then ``doubling_halving``:
  ``repro.launch.train.main`` under ``shard_map`` on 4 host devices (a
  subprocess with ``XLA_FLAGS``) against ``repro_torch.launch.train.main``
  on 4 gloo ranks, with the same argv: 3 AdamW steps of 4 workers x 2
  sequences of 16 tokens, saved with ``--ckpt-dir``. Both start from the
  reference's init and AdamW state, written as a step-0 checkpoint that
  both restore with ``--resume`` (the port draws its own init from a
  torch generator). Tolerances, those of test_torch_train_lm.py's
  five-step AdamW test, set before the first run: rank 0's first and last
  losses within 1e-5 relative, the saved update p3 - p0 within 5e-3 and
  AdamW's moments within 1e-3 (relative L2), its step count equal. AdamW's
  step m / (sqrt(v) + eps) does not scale with the gradient, so rounding
  noise in gradients near 0 becomes update noise of order lr.
* The resize: 2 ranks (2 host devices) for 3 steps at ``--workers 2``,
  saved; then 4 ranks (4 host devices) restarted from it with
  ``--resume --workers 4``: the restart continues from step 3 at eq. 7's
  LR (twice the 2-worker LR), held to the reference's two runs at the
  same tolerances.
* One process: ``--grad-exchange ring`` without a process group runs the
  plain step, with the same losses and checkpoint bits as no flag.
* ``launch.explicit_allreduce.DPRun`` (momentum SGD at a constant LR of
  0.05, 2 steps of 4 ranks x 2 sequences of 16 tokens) against the
  reference's ``shard_map`` step of examples/explicit_allreduce.py under
  psum, ring and doubling_halving: the update within 1e-5 of its largest
  element and rank 0's losses within 1e-5 relative, as test_torch_dp.py
  holds the ResNet; ring and halving-doubling leave the ranks
  bit-identical, psum's ranks within 1e-5.

Every run of ranks has a fresh ``file://`` rendezvous and a join timeout.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore, _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.engine.steps import init_train_state as jax_init_train_state
from repro.models.registry import build_model as jax_build_model
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import explicit_allreduce as ea
from repro_torch.launch import train
from _torch_parity import f32_dp_rank, f32_train_rank

ARCH = "qwen2.5-3b"
ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, UPDATE_REL_L2, MOMENT_REL_L2 = 1e-5, 5e-3, 1e-3
DP_TOL = 1e-5
STEPS = 3
TIMEOUT_S = 60.0
EXCHANGES = ("ring", "doubling_halving")


def _argv(workers: int, ckpt: Path, exchange: str | None = "ring", steps: int = STEPS):
    argv = ["--arch", ARCH, "--smoke", "--steps", str(steps), "--workers", str(workers),
            "--m-per-worker", "2", "--seq", "16", "--lr", "1e-3", "--log-every", "1",
            "--ckpt-dir", str(ckpt), "--resume"]
    return argv + (["--grad-exchange", exchange] if exchange else [])


def _cpu(argv):
    """The port's argv: the reference's, on the CPU."""
    return argv + ["--device", "cpu"]


RUN = ea.DPRun(cfg=get_smoke_config(ARCH), world=4, steps=2, m_per_worker=2, seq=16,
               base_lr_1w=0.05 / 4, device="cpu", timeout_s=TIMEOUT_S)

JAX_SCRIPT = r"""
import json, shutil, sys, time
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np, pytest
from jax.sharding import Mesh, PartitionSpec as P
from repro.checkpoint.store import _flatten
from repro.configs import get_smoke_config
from repro.data.synthetic import TokenStream
from repro.engine.steps import make_train_step, init_train_state
from repro.launch import train
from repro.models.registry import build_model
from repro.optim.optimizers import sgd
from _torch_parity import patch_f32_embeddings

patch_f32_embeddings(pytest.MonkeyPatch())
out, jobs = Path(sys.argv[1]), json.loads(sys.argv[2])
result = {}
for job in jobs:
    if job["kind"] == "train":
        if "wait_for" in job:
            deadline = time.monotonic() + 300
            while not Path(job["wait_for"]).exists():
                assert time.monotonic() < deadline, job["wait_for"]
                time.sleep(0.2)
        if "copy_from" in job:
            shutil.copytree(job["copy_from"], job["argv"][job["argv"].index("--ckpt-dir") + 1])
        first, last = train.main(job["argv"])
        result[job["name"] + "/losses"] = np.array([first, last])
        if "done" in job:
            Path(job["done"]).touch()
    else:  # the example's shard_map step, SGD at a constant LR
        W, M, SEQ, STEPS, LR = job["world"], job["m"], job["seq"], job["steps"], job["lr"]
        cfg = get_smoke_config("qwen2.5-3b")
        model, opt = build_model(cfg), sgd()
        state0 = init_train_state(model, opt)
        flat0 = {k: np.asarray(v) for k, v in _flatten(state0["params"]).items()}
        data = TokenStream(cfg.vocab_size, SEQ, seed=0)
        batches = [{k: jnp.asarray(v) for k, v in data.batch(i, M * W).items()}
                   for i in range(STEPS)]
        mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
        for alg in ("psum", "ring", "doubling_halving"):
            step = jax.jit(jax.shard_map(
                make_train_step(model, opt, grad_exchange=alg), mesh=mesh,
                in_specs=(P(), {"tokens": P("data"), "labels": P("data")}, P()),
                out_specs=(P(), P()), check_vma=False))
            state, losses = state0, []
            for b in batches:
                state, loss = step(state, b, jnp.float32(LR))
                losses.append(float(loss))
            flat = _flatten(state["params"])
            result[f"example/{alg}/update"] = np.concatenate(
                [(np.asarray(flat[k]) - flat0[k]).ravel() for k in sorted(flat)])
            result[f"example/{alg}/losses"] = np.array(losses)
np.savez(out, **result)
"""


def _reference(tmp: Path, name: str, devices: int, jobs: list) -> subprocess.Popen:
    import json
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    return subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / f"{name}.npz"),
                             json.dumps(jobs)], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _ckpt(directory: Path, step: int) -> dict:
    with np.load(directory / f"ckpt_{step:010d}.npz") as z:
        return {k: z[k] for k in z.files}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (two subprocesses, at 2 and 4 host devices) and
    the port's, which run meanwhile; every run starts from one step-0
    checkpoint of the reference's init."""
    tmp = tmp_path_factory.mktemp("dp_lm")
    seed = tmp / "seed"
    jm = jax_build_model(jax_smoke_config(ARCH))
    JaxStore(str(seed)).save(0, jax_init_train_state(jm, jax_adamw()))
    init_flat = _flatten(jax_init_train_state(jm, jax_adamw())["params"])

    def seeded(name: str) -> Path:
        shutil.copytree(seed, tmp / name)
        return tmp / name

    jax2 = _reference(tmp, "jax2", 2, [
        {"kind": "train", "name": "w2", "argv": _argv(2, seeded("jax_w2")),
         "done": str(tmp / "jax_w2.done")}])
    jax4 = _reference(tmp, "jax4", 4, [
        *({"kind": "train", "name": alg, "argv": _argv(4, seeded(f"jax_{alg}"), alg)}
          for alg in EXCHANGES),
        {"kind": "example", "world": RUN.world, "m": RUN.m_per_worker, "seq": RUN.seq,
         "steps": RUN.steps, "lr": RUN.lr},
        {"kind": "train", "name": "w4", "argv": _argv(4, tmp / "jax_w4"),
         "wait_for": str(tmp / "jax_w2.done"), "copy_from": str(tmp / "jax_w2")}])
    try:
        port = {"exchanges": ea.spawn(f32_train_rank, 4, (4, [
            _cpu(_argv(4, seeded(f"port_{alg}"), alg)) for alg in EXCHANGES]),
            4 * TIMEOUT_S)}
        port["w2"] = ea.spawn(f32_train_rank, 2, (2, [_cpu(_argv(2, seeded("port_w2")))]),
                              2 * TIMEOUT_S)
        port["w4"] = ea.spawn(f32_train_rank, 4, (4, [_cpu(_argv(4, tmp / "port_w2"))]),
                              2 * TIMEOUT_S)
        init = params_from_numpy({k: np.asarray(v) for k, v in init_flat.items()},
                                 RUN.cfg, "cpu", torch.float32).flat
        run = dataclasses.replace(RUN, init=init)
        port["dp"] = ea.spawn(f32_dp_rank, RUN.world, (run,),
                              RUN.timeout_s * (len(RUN.algorithms) + 2))
        reference = {}
        for name, proc in (("jax2", jax2), ("jax4", jax4)):
            _, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr
            with np.load(tmp / f"{name}.npz") as z:
                reference.update({k: z[k] for k in z.files})
    finally:
        for proc in (jax2, jax4):
            proc.kill()
    return {"tmp": tmp, "port": port, "jax": reference, "run": run, "init": init}


def _hold_checkpoints(got: dict, want: dict, p0: dict):
    assert got.keys() == want.keys() and int(got["opt/t"]) == int(want["opt/t"])
    params = sorted(k for k in want if k.startswith("params/"))
    upd = lambda ck: np.concatenate([(ck[k] - p0[k]).ravel() for k in params])  # noqa: E731
    assert _rel_l2(upd(got), upd(want)) < UPDATE_REL_L2
    for moment in ("m", "v"):
        keys = sorted(k for k in want if k.startswith(f"opt/{moment}/"))
        cat = lambda ck: np.concatenate([ck[k].ravel() for k in keys])  # noqa: E731
        assert _rel_l2(cat(got), cat(want)) < MOMENT_REL_L2, moment


@pytest.mark.parametrize("alg", EXCHANGES)
def test_train_cli_exchange_matches_reference(runs, alg):
    i = EXCHANGES.index(alg)
    losses = [r[i] for r in runs["port"]["exchanges"]]
    np.testing.assert_allclose(losses[0], runs["jax"][f"{alg}/losses"], rtol=LOSS_REL)
    assert all(np.isfinite(x).all() for x in losses)
    tmp, p0 = runs["tmp"], _ckpt(runs["tmp"] / "seed", 0)
    _hold_checkpoints(_ckpt(tmp / f"port_{alg}", STEPS), _ckpt(tmp / f"jax_{alg}", STEPS), p0)


def test_train_cli_resize_two_to_four_ranks_matches_reference(runs):
    """3 steps at w = 2, then a restart at w = 4 from the saved step 3; the
    restart's losses (at eq. 7's LR) and final state match the reference's
    two runs."""
    tmp, port, jax_ = runs["tmp"], runs["port"], runs["jax"]
    np.testing.assert_allclose(port["w2"][0][0], jax_["w2/losses"], rtol=LOSS_REL)
    np.testing.assert_allclose(port["w4"][0][0], jax_["w4/losses"], rtol=LOSS_REL)
    p0 = _ckpt(tmp / "seed", 0)
    _hold_checkpoints(_ckpt(tmp / "port_w2", STEPS), _ckpt(tmp / "jax_w2", STEPS), p0)
    _hold_checkpoints(_ckpt(tmp / "port_w2", 2 * STEPS), _ckpt(tmp / "jax_w4", 2 * STEPS), p0)
    assert int(_ckpt(tmp / "port_w2", 2 * STEPS)["opt/t"]) == 2 * STEPS


def test_train_cli_one_process_exchange_is_the_plain_step(tmp_path, capsys):
    """With no process group, --grad-exchange ring trains as no flag does."""
    out = {}
    for flag in (None, "ring"):
        ckpt = tmp_path / str(flag)
        out[flag] = train.main(_cpu([a for a in _argv(2, ckpt, flag) if a != "--resume"]))
        out[flag] += (_ckpt(ckpt, STEPS),)
    assert out[None][:2] == out["ring"][:2]
    assert out[None][2].keys() == out["ring"][2].keys()
    for key, value in out[None][2].items():
        np.testing.assert_array_equal(out["ring"][2][key], value, err_msg=key)
    assert "checkpointed step 3" in capsys.readouterr().out


def _updates(runs, alg):
    return [(r["algorithms"][alg]["params"] - runs["init"]).numpy() for r in runs["port"]["dp"]]


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("alg", ["psum", "ring", "doubling_halving"])
def test_dprun_lm_matches_the_example_step(runs, alg):
    want = runs["jax"][f"example/{alg}/update"]
    for r, got in enumerate(_updates(runs, alg)):
        assert _rel_max(got, want) <= DP_TOL, f"rank {r}"
    np.testing.assert_allclose(runs["port"]["dp"][0]["algorithms"][alg]["losses"],
                               runs["jax"][f"example/{alg}/losses"], rtol=DP_TOL)


@pytest.mark.parametrize("alg", ["psum", "ring", "doubling_halving"])
def test_dprun_lm_ranks_hold_one_set_of_parameters(runs, alg):
    ranks = runs["port"]["dp"]
    summary = ea.summary(runs["run"], ranks)
    assert summary["same_init"] and summary["config"] == "qwen2.5-3b-smoke"
    a = summary["algorithms"][alg]
    assert a["max_rel_err_vs_psum"] <= DP_TOL
    assert a["launches_per_rank_step"] == [
        {"rmsnorm": 0, "swa_attention": 0, "fused_sgd_update": 0, "ssd": 0,
         "ssd_backward": 0}] * RUN.world
    if alg != "psum":
        assert a["ranks_bit_identical"]
    upd = _updates(runs, alg)
    assert all(_rel_max(u, upd[0]) <= DP_TOL for u in upd)
