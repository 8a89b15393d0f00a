"""The port's trainer slice against the JAX package, on the CPU at smoke
size: the flat-buffer ``sgd`` against ``repro.optim.sgd``, the
ElasticTrainer's loss trajectory against the reference's (f32 on both
sides: the reference's bf16 cast patched, the port built in f32),
checkpoints that cross between the packages both ways, and mirrors of the
reference's own trainer, store, schedule and data tests.

Tolerances: one SGD step 1e-5 relative / 1e-6 absolute; loss
trajectories 1e-4 relative (reached: below 1e-6); an exact resume within
the port 1e-5 relative, as the reference's own test.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs.resnet110 import smoke_config as jax_smoke_config
from repro.core.elastic import ElasticTrainer as JTrainer
from repro.data.synthetic import CifarLike as JCifarLike
from repro.models.resnet import ResNetModel as JResNetModel
from repro.optim import schedule as jschedule
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.resnet110 import smoke_config
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.data.synthetic import CifarLike
from repro_torch.models.resnet import ResNetModel
from repro_torch.models.spec import FlatTree, flat_tree, flatten
from repro_torch.optim import rescale_lr, schedule, sgd, step_decay
from _torch_parity import patch_resnet_f32

TRAJ_RTOL = 1e-4
# the reference's tests/test_elastic_checkpoint.py::test_elastic_restart_is_exact_resume
TRAINER = dict(base_lr_1w=0.05, m_per_worker=8, dataset_size=256)


def losses(record) -> list[float]:
    return [loss for _, _, loss in record.losses]


def port_trainer(directory) -> ElasticTrainer:
    return ElasticTrainer(ResNetModel(smoke_config(), torch.float32), sgd(),
                          CifarLike(size=256, seed=1), CheckpointStore(str(directory)),
                          **TRAINER, device="cpu")


# ---------------------------------------------------------------- sgd ----
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_steps_equal_reference(nesterov):
    """Two steps (momentum carried) of the flat-buffer sgd against the
    reference's per-leaf sgd, on the same params and gradients; weight
    decay reaches every leaf, gains and biases included."""
    rng = np.random.default_rng(3)
    tree = {"conv": rng.standard_normal((3, 3, 2, 4), dtype=np.float32),
            "norm": {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)},
            "fc_b": rng.standard_normal(5, dtype=np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree) for _ in range(2)]
    jopt, opt = jax_sgd(nesterov=nesterov), sgd(nesterov=nesterov)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = flat_tree({k: torch.as_tensor(v) if not isinstance(v, dict) else
                        {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                        for k, v in tree.items()})
    state = opt.init(params)
    for g, lr in zip(grads, (0.05, 0.1)):
        jparams, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams, lr)
        flat_g = torch.cat([torch.as_tensor(v).reshape(-1) for v in flatten(g).values()])
        new_params, state = opt.update(flat_g, state, params, lr)
        assert new_params is params  # in place
    for path, want in flatten(jparams).items():
        np.testing.assert_allclose(flatten(params)[path].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for path, want in flatten(jstate["mu"]).items():
        np.testing.assert_allclose(flatten(state["mu"])[path].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_sgd_needs_flat_buffers():
    with pytest.raises(TypeError, match="FlatTree"):
        sgd().init({"w": torch.zeros(3)})
    params = flat_tree({"w": torch.zeros(3), "b": torch.ones(2)})
    mu = sgd().init(params)["mu"]
    assert isinstance(mu, FlatTree) and mu.flat.shape == (5,)
    assert mu.flat.data_ptr() != params.flat.data_ptr() and not mu.flat.any()


# ------------------------------------------------- trainer vs reference ----
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (f32) and the port's, shared by the tests below.

    One JAX trainer serves every reference run (its ``ckpt`` is swapped),
    so its train step compiles once. The port starts from the reference's
    init, saved by the reference as a step-0 checkpoint.
    """
    root = tmp_path_factory.mktemp("elastic")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_resnet_f32(mp)
        jt = JTrainer(JResNetModel(jax_smoke_config()), jax_sgd(),
                      JCifarLike(size=256, seed=1), JStore(str(root / "j_straight")),
                      **TRAINER)
        JStore(str(root / "init")).save(0, jt.fresh_state())
        out["jax_straight"] = losses(jt.train_segment(1, 10, resume=False, log_every=1))
        shutil.copytree(root / "init", root / "p_straight")
        out["port_10"] = losses(port_trainer(root / "p_straight").train_segment(
            1, 10, resume=True, log_every=1))

        # the reference stops at step 5; the port resumes its checkpoint
        jt.ckpt = JStore(str(root / "j_stop"))
        jt.train_segment(1, 5, resume=False, log_every=1)
        shutil.copytree(root / "j_stop", root / "j_to_port")
        out["jax_cont"] = losses(jt.train_segment(1, 5, resume=True, log_every=1))
        out["port_from_jax"] = port_trainer(root / "j_to_port").train_segment(
            1, 5, resume=True, log_every=1)

        # the port trains from the reference's init, stops at step 5 and
        # goes on; the reference resumes the port's step-5 checkpoint
        shutil.copytree(root / "init", root / "p_run")
        pt = port_trainer(root / "p_run")
        first = pt.train_segment(1, 5, resume=True, log_every=1)
        shutil.copytree(root / "p_run", root / "p_to_jax")
        second = pt.train_segment(1, 5, resume=True, log_every=1)
        out["port_straight"] = losses(first) + losses(second)
        jt.ckpt = JStore(str(root / "p_to_jax"))
        out["jax_from_port"] = jt.train_segment(1, 5, resume=True, log_every=1)
        out["ckpt"] = {"jax": root / "j_stop" / "ckpt_0000000005.npz",
                       "port": root / "p_to_jax" / "ckpt_0000000005.npz"}
    return out


def test_trainer_matches_reference_trajectory(runs):
    """The port's ElasticTrainer from the reference's init follows the
    reference's 10-step loss trajectory, straight through and with a stop
    at step 5."""
    np.testing.assert_allclose(runs["port_10"], runs["jax_straight"], rtol=TRAJ_RTOL)
    np.testing.assert_allclose(runs["port_straight"], runs["jax_straight"],
                               rtol=TRAJ_RTOL)
    assert runs["jax_cont"] == pytest.approx(runs["jax_straight"][5:], rel=1e-5)


def test_port_resumes_a_reference_checkpoint(runs):
    r = runs["port_from_jax"]
    assert r.losses[0][0] == 5 and r.restore_seconds > 0
    np.testing.assert_allclose(losses(r), runs["jax_cont"], rtol=TRAJ_RTOL)


def test_reference_resumes_a_port_checkpoint(runs):
    r = runs["jax_from_port"]
    assert r.losses[0][0] == 5
    np.testing.assert_allclose(losses(r), runs["port_straight"][5:], rtol=TRAJ_RTOL)
    assert r.epochs == pytest.approx(runs["port_from_jax"].epochs, rel=1e-6)


def test_checkpoint_files_match_the_reference(runs):
    with np.load(runs["ckpt"]["jax"]) as j, np.load(runs["ckpt"]["port"]) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
        assert p["step"].dtype == np.int32 and p["step"].shape == () and p["step"] == 5
        assert p["epoch"].dtype == np.float32 and p["epoch"].shape == ()
    assert any(k.startswith("opt/mu/stage0_first/") for k in p.files)


# ------------------------------------------------ mirrors of the reference ----
def test_elastic_restart_is_exact_resume(tmp_path):
    """Restarting at the same w must continue the exact same trajectory as
    not stopping at all (checkpoint carries params+momentum+step)."""
    a = port_trainer(tmp_path / "a")
    uninterrupted = losses(a.train_segment(w=1, n_steps=10, resume=False, log_every=1))
    b = port_trainer(tmp_path / "b")
    b.train_segment(w=1, n_steps=5, resume=False, log_every=1)
    resumed = losses(b.train_segment(w=1, n_steps=5, resume=True, log_every=1))
    np.testing.assert_allclose(resumed, uninterrupted[5:], rtol=1e-5)


def test_elastic_resize_preserves_state_and_learns(tmp_path):
    tr = ElasticTrainer(ResNetModel(smoke_config()), sgd(), CifarLike(size=512, seed=0),
                        CheckpointStore(str(tmp_path)), base_lr_1w=0.05,
                        m_per_worker=16, dataset_size=512, device="cpu")
    r1 = tr.train_segment(w=1, n_steps=12, resume=False, log_every=4)
    r2 = tr.train_segment(w=2, n_steps=10, resume=True, log_every=4)
    # epochs accumulate across the resize (m stays per-worker)
    assert r2.epochs > r1.epochs
    assert r2.epochs == pytest.approx(12 * 16 / 512 + 10 * 32 / 512, rel=1e-6)
    # the post-resize segment's average loss beats the cold-start loss
    assert np.mean(losses(r2)) < r1.losses[0][2]
    assert 0 < r1.save_seconds < 5
    assert 0 < r2.restore_seconds < 5


def test_trainer_lr_follows_reference(tmp_path):
    """eq. 7 scaling from the 1-worker base and epoch-pinned decay."""
    jt = JTrainer(JResNetModel(jax_smoke_config()), jax_sgd(), JCifarLike(size=64),
                  JStore(str(tmp_path / "j")), base_lr_1w=0.1)
    pt = ElasticTrainer(ResNetModel(smoke_config()), sgd(), CifarLike(size=64),
                        CheckpointStore(str(tmp_path / "p")), base_lr_1w=0.1,
                        device="cpu")
    for w in (1, 4, 8):
        for epoch in (0.0, 99.9, 100.0, 149.0, 150.0, 200.0):
            assert pt._lr(w, epoch) == jt._lr(w, epoch)


# -------------------------------------------------------------- store ----
def test_checkpoint_roundtrip_exact(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    store.save(7, state, meta={"w": 4})
    template = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
                "step": torch.tensor(0, dtype=torch.int32)}
    restored, meta, seconds = store.restore(template)
    assert meta == {"w": 4} and seconds >= 0
    assert restored is template  # filled in place
    for path, v in flatten(state).items():
        assert torch.equal(flatten(restored)[path], v)


def test_restore_writes_through_flat_views(tmp_path):
    """Restoring into a FlatTree fills its flat buffer: the views and the
    buffer the optimizer updates stay one."""
    store = CheckpointStore(str(tmp_path))
    src = flat_tree({"a": torch.arange(4.0), "b": {"c": torch.full((2, 2), 3.0)}})
    store.save(1, {"params": src})
    dst = flat_tree({"a": torch.zeros(4), "b": {"c": torch.zeros(2, 2)}})
    ptr = dst.flat.data_ptr()
    store.restore({"params": dst})
    assert dst.flat.data_ptr() == ptr and torch.equal(dst.flat, src.flat)


def test_checkpoint_missing_key_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"a": torch.ones(3)})
    with pytest.raises(KeyError):
        store.restore({"a": torch.ones(3), "b": torch.ones(2)})


def test_checkpoint_wrong_shape_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        store.restore({"a": torch.ones(4)})


def test_latest_step(tmp_path):
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() is None
    store.save(3, {"x": torch.ones(1)})
    store.save(12, {"x": torch.ones(1)})
    assert store.latest_step() == 12
    assert store.steps() == [3, 12]
    assert sorted(os.listdir(tmp_path)) == [  # no tmp file left behind
        "ckpt_0000000003.json", "ckpt_0000000003.npz",
        "ckpt_0000000012.json", "ckpt_0000000012.npz"]


def test_restore_falls_back_past_a_torn_snapshot(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(5, {"x": torch.full((4,), 5.0)})
    store.save(9, {"x": torch.full((4,), 9.0)})
    torn = tmp_path / "ckpt_0000000009.npz"
    torn.write_bytes(torn.read_bytes()[:40])
    assert store.latest_step() == 5  # a torn snapshot is not a target
    state, _, _ = store.restore({"x": torch.zeros(4)})
    assert torch.equal(state["x"], torch.full((4,), 5.0))
    with pytest.raises(Exception):  # an explicit step is trusted
        store.restore({"x": torch.zeros(4)}, step=9)


# ------------------------------------------------------ data, schedules ----
@pytest.mark.parametrize("size,seed", [(100, 0), (256, 1), (50_000, 0)])
def test_cifar_like_is_a_copy(size, seed):
    mine, theirs = CifarLike(size=size, seed=seed), JCifarLike(size=size, seed=seed)
    for step, batch in ((0, 64), (3, 32), (7, 128)):
        a, b = mine.batch(step, batch), theirs.batch(step, batch)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.steps_per_epoch(50) == theirs.steps_per_epoch(50)


def test_schedules_are_copies():
    assert rescale_lr(0.4, 8, 4) == pytest.approx(0.8)  # the paper's 4 -> 8 case
    assert rescale_lr(0.8, 4, 8) == jschedule.rescale_lr(0.8, 4, 8)
    spe = 50000 / (128 * 4)
    mine, theirs = step_decay(0.4, spe), jschedule.step_decay(0.4, spe)
    wc, jwc = schedule.warmup_cosine(0.1, 10, 100), jschedule.warmup_cosine(0.1, 10, 100)
    for s in (0, 5, 9, 10, 50, 99, 100, 20_000, 40_000):
        assert mine(s) == theirs(s) and wc(s) == jwc(s)


def test_segment_record_fields_match_reference():
    from repro.core.elastic import SegmentRecord as JRecord
    from repro_torch.core.elastic import SegmentRecord
    assert ([f.name for f in dataclasses.fields(SegmentRecord)]
            == [f.name for f in dataclasses.fields(JRecord)])
