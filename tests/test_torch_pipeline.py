"""The paper's pipeline in the port, against the reference's, on the CPU.

``tests/test_system.py::test_paper_pipeline_end_to_end`` run through both
packages at smoke size (ResNet-8, 512 images, 16 a worker): train 30 steps
at w = 1, fit eq. 1 to the losses, fit eq. 5 from Table 1-style speeds
of the analytic job model, let the doubling heuristic size the job on 8
GPUs, restart at that w for 10 steps. The port starts from the
reference's init (``bridge.params_from_numpy``), both in f32 (the
reference's bf16 cast patched, the port's model built in f32).

* The 30 steps at w = 1 agree to ``test_torch_elastic.py``'s trajectory
  tolerance (the two packages round their convolutions' sums in different
  orders: 1e-7 at the first steps, up to 3e-5 relative at step 30).
* The restart at w = 8 runs at 8x the LR (eq. 7), where that rounding
  grows to 4e-4 in 10 steps of each package's own run; so the port's
  restart is held to the reference's from the same state, the reference's
  step-30 checkpoint, at the same tolerance. The port's own run must
  continue: steps and epochs go on and the last loss is below the first.
* The eq. 5 fit, whose inputs are the same numbers in both, agrees
  exactly; the allocation is 8 in both.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import shutil

import numpy as np
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.checkpoint.store import _flatten
from repro.configs.resnet110 import smoke_config as jax_smoke_config
from repro.core import convergence as jconv
from repro.core import jobs as jjobs
from repro.core import resource_model as jrm
from repro.core import scheduler as jS
from repro.core.elastic import ElasticTrainer as JTrainer
from repro.data.synthetic import CifarLike as JCifarLike
from repro.models.resnet import ResNetModel as JResNetModel
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.resnet110 import smoke_config
from repro_torch.core import convergence as tconv
from repro_torch.core import jobs as tjobs
from repro_torch.core import resource_model as trm
from repro_torch.core import scheduler as tS
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.data.synthetic import CifarLike
from repro_torch.models.resnet import ResNetModel
from repro_torch.optim import sgd
from _torch_parity import patch_resnet_f32
from test_torch_elastic import TRAJ_RTOL

# tests/test_system.py's trainer
TRAINER = dict(base_lr_1w=0.05, m_per_worker=16, dataset_size=512)


def pipeline(tr, conv, rm_module, jobs_module, S, on_stop=lambda: None) -> dict:
    """tests/test_system.py:26-62 through the modules given; ``on_stop``
    is called between the two segments."""
    rec = tr.train_segment(w=1, n_steps=30, resume=False, log_every=1)
    on_stop()
    steps = np.array([s for s, _, _ in rec.losses], float)
    losses = np.array([l for _, _, l in rec.losses], float)
    fit1 = conv.fit_convergence(steps, losses)
    ws = np.array([1, 2, 4, 8])
    spec = jobs_module.JobSpec(0, 0.0, 160.0, speed_mode="analytic")
    speeds = np.array([spec.speed(int(w)) for w in ws])
    rm = rm_module.fit_resource_model(ws, speeds, m=128, n=6.9e6)
    jobs = [(0, 100.0, lambda w: float(rm.f(np.array([w]))[0]))]
    alloc = S.doubling_heuristic(jobs, capacity=8, max_w=8)
    rec2 = tr.train_segment(w=alloc[0], n_steps=10, resume=True, log_every=2)
    return {"rec": rec, "rec2": rec2, "fit1": fit1, "f_ws": rm.f(ws),
            "theta": rm.theta, "alloc": alloc}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    with pytest.MonkeyPatch.context() as mp:
        patch_resnet_f32(mp)
        jt = JTrainer(JResNetModel(jax_smoke_config()), jax_sgd(),
                      JCifarLike(size=512, seed=0), JStore(str(root / "jax")), **TRAINER)
        init = {k: np.asarray(v) for k, v in _flatten(jt.fresh_state()["params"]).items()}
        jax_run = pipeline(jt, jconv, jrm, jjobs, jS, on_stop=lambda: shutil.copytree(
            root / "jax", root / "jax_at_30"))

    def port_trainer(directory) -> ElasticTrainer:
        return ElasticTrainer(ResNetModel(smoke_config(), torch.float32), sgd(),
                              CifarLike(size=512, seed=0), CheckpointStore(str(directory)),
                              **TRAINER, device="cpu")

    tr = port_trainer(root / "port")

    def fresh_state(generator=None):
        params = params_from_numpy(init, smoke_config(), "cpu")
        return {"params": params, "opt": tr.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32),
                "epoch": torch.zeros((), dtype=torch.float32)}

    tr.fresh_state = fresh_state  # the reference's init
    port_run = pipeline(tr, tconv, trm, tjobs, tS)
    port_run["rec2_from_jax"] = port_trainer(root / "jax_at_30").train_segment(
        w=port_run["alloc"][0], n_steps=10, resume=True, log_every=2)
    return jax_run, port_run


def losses(rec) -> list[float]:
    return [l for _, _, l in rec.losses]


@pytest.mark.parametrize("seg, ref_seg", [("rec", "rec"), ("rec2_from_jax", "rec2"),
                                           ("rec2", "rec2")])
def test_losses_match_the_reference(runs, seg, ref_seg):
    """Each segment's steps and epochs; the losses of the first segment,
    and of the restart from the reference's checkpoint."""
    want, got = runs
    assert [s for s, _, _ in got[seg].losses] == [s for s, _, _ in want[ref_seg].losses]
    np.testing.assert_allclose([e for _, e, _ in got[seg].losses],
                               [e for _, e, _ in want[ref_seg].losses], rtol=1e-6)
    if seg != "rec2":
        np.testing.assert_allclose(losses(got[seg]), losses(want[ref_seg]), rtol=TRAJ_RTOL)


def test_fits_are_finite_and_increasing(runs):
    want, got = runs
    for run in runs:
        assert np.isfinite(run["fit1"].loss_at(100.0))
        assert np.all(np.diff(run["f_ws"]) > 0)
    # eq. 5's inputs are the same numbers in both packages
    assert [x.hex() for x in got["theta"]] == [x.hex() for x in want["theta"]]


def test_allocation_and_restart(runs):
    want, got = runs
    assert got["alloc"] == want["alloc"] == {0: 8}
    rec, rec2 = got["rec"], got["rec2"]
    assert rec2.w == 8 and rec2.losses[0][0] == 30
    assert rec2.epochs > rec.epochs
    assert rec2.losses[-1][2] < rec.losses[0][2]
