#!/usr/bin/env python3
"""ResNet-110 at a high LR on the CPU: the JAX package against the port.

  JAX_PLATFORMS=cpu PYTHONPATH=src python3 cpu_resnet110_parity.py \
      [--lrs 0.02,3e-4] [--steps 8] [--batch 32]

Both ElasticTrainers run ResNet-110 at its full depth in f32 (the
reference's bf16 cast patched as in tests/test_torch_elastic.py, the port
built in f32) from the same weights: the reference draws its init and
saves it as a step-0 checkpoint, which the port resumes. One worker, the
same CifarLike batches, each given base LR. As controls of how far f32
rounding alone moves a trajectory, each package also runs
  * from that init with every weight moved by one f32 ulp (a random sign
    each): one perturbation, at the start;
  * with every gradient element moved by one f32 ulp at every step (up if
    its lowest mantissa bit is 0, else down; the same rule in both
    packages): rounding-sized noise entering at each step;
and the port once more with oneDNN off (torch.backends.mkldnn), so that
its convolutions, forward and backward, sum in another order at every
step. Prints, per LR, one JSON line: the loss trajectories, and the
relative difference per step and its largest value of the port from the
reference and of each control from its own package's run.

Then, per LR, a step check that a trajectory cannot give: along the
reference's own trajectory, at each step's state and batch, the loss and
flat gradient of the reference, of the port and of the port with oneDNN
off. The port against the reference is then one step's difference, not
eight steps' amplification of it, and the port against itself with
oneDNN off is the size of a rounding-level difference of that step. One
more JSON line per LR. The script checks nothing: the tier-1 parity test of the same trainers is at depth 14
(tests/test_torch_elastic.py, TRAJ_RTOL).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.models.resnet as JR  # noqa: E402
from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.checkpoint.store import _flatten  # noqa: E402
from repro.configs.resnet110 import CONFIG as JCONFIG  # noqa: E402
from repro.core.elastic import ElasticTrainer as JTrainer  # noqa: E402
from repro.data.synthetic import CifarLike as JCifarLike  # noqa: E402
from repro.models.resnet import ResNetModel as JResNetModel  # noqa: E402
from repro.optim.optimizers import Optimizer as JOptimizer  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs.resnet110 import CONFIG  # noqa: E402
from repro_torch.core.elastic import ElasticTrainer  # noqa: E402
from repro_torch.data.synthetic import CifarLike  # noqa: E402
from repro_torch.engine.steps import value_and_flat_grad  # noqa: E402
from repro_torch.models.resnet import ResNetModel  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.optim.optimizers import Optimizer  # noqa: E402


class _JnpF32:
    """``jax.numpy`` with ``bfloat16`` standing for ``float32``."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def one_ulp(tree, seed: int = 0):
    """Every f32 leaf moved by one ulp up or down (random signs)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        up = rng.integers(0, 2, x.shape).astype(bool)
        return np.where(up, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf)))
    return jax.tree_util.tree_map(move, tree)


def jax_sgd_grad_ulp() -> JOptimizer:
    """The reference's sgd, each gradient element first moved by one ulp."""
    base = jax_sgd()

    def nudge(g):
        up = (jax.lax.bitcast_convert_type(g, jnp.int32) & 1) == 0
        return jnp.nextafter(g, jnp.where(up, jnp.inf, -jnp.inf).astype(g.dtype))

    def update(grads, state, params, lr):
        return base.update(jax.tree_util.tree_map(nudge, grads), state, params, lr)
    return JOptimizer(base.init, update, base.name)


def sgd_grad_ulp() -> Optimizer:
    """The port's sgd, each gradient element first moved by one ulp."""
    base = sgd()

    def update(grads, state, params, lr):
        up = (grads.view(torch.int32) & 1) == 0
        inf = torch.full_like(grads, float("inf"))
        grads = torch.nextafter(grads, torch.where(up, inf, -inf))
        return base.update(grads, state, params, lr)
    return Optimizer(base.init, update, base.name)


def losses(record) -> list[float]:
    return [loss for _, _, loss in record.losses]


def rel(got, want) -> list[float]:
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def compare(lr: float, args) -> dict:
    kw = dict(base_lr_1w=lr, m_per_worker=args.batch, dataset_size=args.dataset)
    out = {"depth": CONFIG.depth, "base_lr_1w": lr, "steps": args.steps,
           "batch": args.batch}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        jt = JTrainer(JResNetModel(JCONFIG), jax_sgd(), JCifarLike(size=args.dataset, seed=0),
                      JStore(str(root / "jax")), **kw)
        init = jt.fresh_state()
        moved = {**init, "params": one_ulp(init["params"])}
        for name, state in (("port", init), ("port_grad_ulp", init),
                            ("port_no_onednn", init), ("jax_grad_ulp", init),
                            ("port_ulp", moved), ("jax_ulp", moved)):
            JStore(str(root / name)).save(0, state)
        t0 = time.perf_counter()
        out["jax_losses"] = losses(jt.train_segment(1, args.steps, resume=False,
                                                    log_every=1))
        out["jax_seconds"] = time.perf_counter() - t0
        jt.ckpt = JStore(str(root / "jax_ulp"))  # the compiled step is reused
        out["jax_ulp_losses"] = losses(jt.train_segment(1, args.steps, resume=True,
                                                        log_every=1))
        jg = JTrainer(JResNetModel(JCONFIG), jax_sgd_grad_ulp(),
                      JCifarLike(size=args.dataset, seed=0),
                      JStore(str(root / "jax_grad_ulp")), **kw)
        out["jax_grad_ulp_losses"] = losses(jg.train_segment(1, args.steps, resume=True,
                                                             log_every=1))
        for name, opt, onednn in (("port", sgd(), True), ("port_ulp", sgd(), True),
                                  ("port_grad_ulp", sgd_grad_ulp(), True),
                                  ("port_no_onednn", sgd(), False)):
            pt = ElasticTrainer(ResNetModel(CONFIG, torch.float32), opt,
                                CifarLike(size=args.dataset, seed=0),
                                CheckpointStore(str(root / name)), **kw, device="cpu")
            with torch.backends.mkldnn.flags(enabled=onednn):
                out[f"{name}_losses"] = losses(pt.train_segment(1, args.steps,
                                                                resume=True, log_every=1))
    # each trajectory against the run it is a control of
    pairs = {"port": "jax", "jax_ulp": "jax", "jax_grad_ulp": "jax",
             "port_ulp": "port", "port_grad_ulp": "port", "port_no_onednn": "port"}
    for name, base in pairs.items():
        diff = rel(out[f"{name}_losses"], out[f"{base}_losses"])
        out[f"{name}_rel_diff"] = diff
        out[f"{name}_max_rel_diff"] = max(diff)
    return out


def grad_diff(got: np.ndarray, want: np.ndarray) -> dict:
    return {"max": float(np.abs(got - want).max() / np.abs(want).max()),
            "norm": float(np.linalg.norm(got - want) / np.linalg.norm(want))}


def step_check(lr: float, args) -> dict:
    kw = dict(base_lr_1w=lr, m_per_worker=args.batch, dataset_size=args.dataset)
    jm = JResNetModel(JCONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        jt = JTrainer(jm, jax_sgd(), JCifarLike(size=args.dataset, seed=0),
                      JStore(tmp), **kw)
        state = jt.fresh_state()
    params, opt = state["params"], state["opt"]
    value_and_grad = jax.jit(jax.value_and_grad(jm.loss))
    tm = ResNetModel(CONFIG, torch.float32)
    epoch, rows = 0.0, []
    for t in range(args.steps):  # the reference's train_segment, one worker
        batch = jt.data.batch(t, args.batch)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = value_and_grad(params, jbatch)
        want = np.concatenate([np.asarray(g).reshape(-1)
                               for g in _flatten(jgrads).values()])
        tp = params_from_numpy({k: np.asarray(v) for k, v in _flatten(params).items()},
                               CONFIG, "cpu")
        tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        port = {}
        for onednn in (True, False):
            with torch.backends.mkldnn.flags(enabled=onednn):
                loss, grads = value_and_flat_grad(tm, tp, tbatch)
            port[onednn] = (float(loss), grads.numpy().copy())
        (loss, got), (loss_off, got_off) = port[True], port[False]
        rows.append({"step": t, "loss": float(jloss),
                     "port_loss_rel_diff": abs(loss - float(jloss)) / abs(float(jloss)),
                     "port_grad_diff": grad_diff(got, want),
                     "port_no_onednn_loss_rel_diff": abs(loss_off - loss) / abs(loss),
                     "port_no_onednn_grad_diff": grad_diff(got_off, got)})
        _, params, opt = jt._step(params, opt, jbatch, jt._lr(1, epoch))
        epoch += args.batch / jt.dataset
    return {"step_check": True, "depth": CONFIG.depth, "base_lr_1w": lr, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="0.02,3e-4", help="base LRs per worker")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32, help="images per step")
    ap.add_argument("--dataset", type=int, default=50_000)
    args = ap.parse_args()
    JR.jnp = _JnpF32()  # the reference's activations in f32
    for lr in map(float, args.lrs.split(",")):
        print(json.dumps(compare(lr, args)), flush=True)
        print(json.dumps(step_check(lr, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
