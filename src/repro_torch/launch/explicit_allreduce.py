"""Data-parallel training with the paper's gradient exchange: w processes,
each with its rows of the global batch, all-reduce their gradients with
ring, halving-doubling or ``dist.all_reduce`` (torch twin of
``examples/explicit_allreduce.py``, which trains a transformer; the port's
trainer slice is the ResNet, so this trains the ResNet).

  PYTHONPATH=src python -m repro_torch.launch.explicit_allreduce
  PYTHONPATH=src python -m repro_torch.launch.explicit_allreduce --device cpu

By default ResNet-110 at full size on the card, 4 ranks sharing it over
gloo (each rank's gradients staged through pinned host memory); with
``--device cpu``, the smoke ResNet on the CPU. Each rank is a process
started with the ``spawn`` method, joined by a ``file://`` rendezvous in
a fresh temporary directory. All ranks start from one seeded init (or the
flat parameters the caller gives) and train the same steps under each
algorithm in turn; each returns its losses, final parameters, launch
counts, step times, and the exchange of its first-step gradients under
every algorithm against ``dist.all_reduce``'s, with their times. Every
time is taken on the host clock, staging included.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.collectives import schedules
from repro_torch.collectives.dist import ALGORITHMS, transport
from repro_torch.configs import resnet110
from repro_torch.data.synthetic import CifarLike
from repro_torch.engine.steps import (make_train_step, resolve_device,
                                      value_and_flat_grad)
from repro_torch.kernels import build, ops
from repro_torch.launch.mesh import init_data_group, local_rows
from repro_torch.models.resnet import ResNetModel
from repro_torch.models.spec import flatten, views
from repro_torch.optim import rescale_lr, sgd


@dataclasses.dataclass(frozen=True)
class DPRun:
    """One data-parallel run: ``world`` ranks, ``steps`` steps under each of
    ``algorithms``, ``m_per_worker`` rows of a ``CifarLike`` batch per rank
    and per step, LR ``base_lr_1w * world`` (eq. 7).

    ``init``: flat f32 initial parameters (a CPU tensor, for example the
    reference's bridged in), or None for ``model.init`` from a generator
    seeded with 0 on each rank's device.
    ``device``: every rank's device ("cuda": the current card, which the
    ranks share; they exchange over gloo).
    """

    cfg: resnet110.ResNetConfig = resnet110.CONFIG
    world: int = 4
    algorithms: tuple[str, ...] = ("psum", "ring", "doubling_halving")
    steps: int = 5
    m_per_worker: int = 128
    base_lr_1w: float = 3e-4
    microbatches: int = 1
    dtype: torch.dtype = torch.bfloat16
    init: torch.Tensor | None = None
    device: str = "cuda"
    timeout_s: float = 300.0

    @property
    def lr(self) -> float:
        return rescale_lr(self.base_lr_1w, self.world, 1)

    def model(self) -> ResNetModel:
        return ResNetModel(self.cfg, self.dtype)

    def batches(self) -> list[dict]:
        """The global batches of the run's steps, drawn on the host from
        CIFAR-10's 50,000 images (``CifarLike``'s default)."""
        data = CifarLike()
        return [data.batch(s, self.m_per_worker * self.world)
                for s in range(self.steps)]

    def initial_state(self, device: torch.device) -> dict:
        """{params, opt} at the run's init on ``device``."""
        model = self.model()
        if self.init is None:
            params = model.init(torch.Generator(device=device).manual_seed(0),
                                device)
        else:
            shapes = {p: s.shape for p, s in flatten(model.param_specs()).items()}
            params = views(self.init.to(device, torch.float32).clone(), shapes)
        return {"params": params, "opt": sgd().init(params)}


def digest(x: torch.Tensor) -> str:
    """A short hex digest of a tensor's bytes, for comparing ranks' bits."""
    data = x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
    return hashlib.sha256(data.tobytes()).hexdigest()[:16]


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def exchange_check(grads: torch.Tensor, algorithms, reps: int = 5) -> dict:
    """All-reduce ``grads`` (not modified) under each algorithm ``reps``
    times; per algorithm, the times (ms, host clock, staging included),
    the largest difference from ``dist.all_reduce``'s sum over the largest
    element of that sum, and the digest of the result."""
    dev = grads.device
    want = ALGORITHMS["psum"](grads)
    scale = float(want.abs().max())
    out = {}
    for alg in dict.fromkeys(("psum", *algorithms)):
        times = []
        for _ in range(reps):
            t0 = _sync(dev)
            got = ALGORITHMS[alg](grads)
            times.append(1e3 * (_sync(dev) - t0))
        out[alg] = {"times_ms": times,
                    "max_rel_err_vs_psum": float((got - want).abs().max()) / scale,
                    "digest": digest(got)}
    return out


def train(rank: int, run: DPRun, dev: torch.device) -> dict:
    """Rank ``rank``'s part of ``run`` in an initialised process group."""
    model, w = run.model(), run.world
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                local_rows(b, rank, w).items()} for b in run.batches()]
    init = run.initial_state(dev)["params"]
    _, first = value_and_flat_grad(model, init, batches[0])
    out = {"rank": rank, "world": w, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu"),
           "transport": transport(None, first), "n_params": first.numel(),
           "init_digest": digest(init.flat),
           "exchange": exchange_check(first, run.algorithms),
           "algorithms": {}}
    for alg in run.algorithms:
        state = run.initial_state(dev)
        step = make_train_step(model, sgd(), grad_exchange=alg,
                               microbatches=run.microbatches, device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, step_ms = [], []
        for batch in batches:
            t0 = _sync(dev)
            state, loss = step(state, batch, run.lr)
            losses.append(float(loss))
            step_ms.append(1e3 * (_sync(dev) - t0))
        out["algorithms"][alg] = {
            "losses": losses, "step_ms": step_ms,
            "launches": ops.launch_counts(),
            "params": state["params"].flat.cpu(),
            "digest": digest(state["params"].flat),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}
    return out


def join(rank: int, run: DPRun, init_method: str) -> torch.device:
    """Set up a spawned rank: its share of the host's cores (one
    intra-op thread on a card, where the host only stages and adds the
    exchanged buffer; an equal share of the cores on the CPU: more
    threads than cores slowed a 4-rank ring exchange by several times),
    then its place in the gloo group. Returns its device."""
    device = torch.device(run.device)
    torch.set_num_threads(1 if device.type == "cuda"
                          else max(1, (os.cpu_count() or 1) // run.world))
    return init_data_group(rank, run.world, init_method, "gloo", device,
                           run.timeout_s)


def train_rank(rank: int, run: DPRun, init_method: str, out_dir: str) -> None:
    """A spawned rank: join the group, train, write ``rank<r>.pt``."""
    dev = join(rank, run, init_method)
    try:
        torch.save(train(rank, run, dev), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple, timeout_s: float) -> list:
    """Run ``fn(rank, *args, init_method, out_dir)`` in ``world`` spawned
    processes and return what each saved as ``out_dir/rank<r>.pt``, in
    rank order. A rank that fails raises here (the others are stopped);
    ranks still running after ``timeout_s`` are killed and TimeoutError
    is raised."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_dp_") as tmp:
        ctx = mp.start_processes(fn, args=(*args, f"file://{tmp}/rdzv", tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]


def run(spec: DPRun) -> list[dict]:
    """Train ``spec`` on ``spec.world`` ranks; one result dict per rank.

    The kernels are built here, before any rank starts, so that the ranks
    only load them."""
    if resolve_device(spec.device).type == "cuda":
        build.build_all()
    # every rank's collectives have waited at most timeout_s; the whole run
    # gets one timeout per algorithm and one for start-up and the checks
    return spawn(train_rank, spec.world, (spec,),
                 spec.timeout_s * (len(spec.algorithms) + 2))


def bytes_sent_per_rank(algorithm: str, n: int, w: int) -> float | None:
    """Bytes each rank sends in one all-reduce of n f32 values, from the
    schedule simulators' counters (None for ``dist.all_reduce``, whose
    schedule is the backend's)."""
    sim = schedules.ALGORITHMS.get(algorithm)
    if sim is None:
        return None
    return sim(np.zeros((w, n), np.float32), itemsize=4)[1].bytes_sent


def summary(spec: DPRun, ranks: list[dict]) -> dict:
    """Per algorithm: rank 0's losses, the median step and exchange times
    over all ranks' steps, bytes sent per rank and step, whether every
    rank's final parameters carry rank 0's bits, launches per rank and
    step, and the largest difference from ``dist.all_reduce``."""
    r0 = ranks[0]
    out = {"world": spec.world, "config": spec.cfg.name,
           "global_batch": spec.m_per_worker * spec.world, "lr": spec.lr,
           "transport": r0["transport"], "device": r0["device_name"],
           "same_init": len({r["init_digest"] for r in ranks}) == 1,
           "algorithms": {}}
    for alg in spec.algorithms:
        runs = [r["algorithms"][alg] for r in ranks]
        out["algorithms"][alg] = {
            "losses_rank0": runs[0]["losses"],
            "step_ms_median": statistics.median(
                t for x in runs for t in x["step_ms"]),
            "exchange_ms_median": statistics.median(
                t for r in ranks for t in r["exchange"][alg]["times_ms"]),
            "bytes_sent_per_rank": bytes_sent_per_rank(alg, r0["n_params"], spec.world),
            "ranks_bit_identical": len({x["digest"] for x in runs}) == 1,
            "launches_per_rank_step": [
                {k: v / spec.steps for k, v in x["launches"].items()} for x in runs],
            "max_rel_err_vs_psum": max(r["exchange"][alg]["max_rel_err_vs_psum"]
                                       for r in ranks),
            "peak_memory_bytes": [x["peak_memory_bytes"] for x in runs]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cpu = resolve_device(args.device).type == "cpu"
    spec = DPRun(cfg=resnet110.smoke_config() if cpu else resnet110.CONFIG,
                 m_per_worker=16 if cpu else 128, device=args.device)
    t0 = time.perf_counter()
    out = summary(spec, run(spec))
    print(f"{spec.world} ranks, {spec.cfg.name}, transport {out['transport']} "
          f"(times: host clock)")
    for alg, a in out["algorithms"].items():
        losses = a["losses_rank0"]
        print(f"{alg:18s} losses {losses[0]:.4f} -> {losses[-1]:.4f}  step "
              f"{a['step_ms_median']:.1f} ms  exchange {a['exchange_ms_median']:.1f} ms  "
              f"ranks bit-identical {a['ranks_bit_identical']}")
    print(json.dumps(out))
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
