"""Data-parallel training with the paper's gradient exchange: w processes,
each with its rows of the global batch, all-reduce their gradients with
ring, halving-doubling or ``dist.all_reduce`` (torch twin of
``examples/explicit_allreduce.py``).

  PYTHONPATH=src python -m repro_torch.launch.explicit_allreduce --device cpu
  PYTHONPATH=src python -m repro_torch.launch.explicit_allreduce --arch resnet-110

By default the example's run: qwen2.5-3b at smoke size on 8 ranks, 8
sequences of 64 tokens each, SGD at a constant LR of 0.05, 10 steps under
psum, ring and doubling_halving in turn. ``--arch resnet-110`` trains
ResNet-110 instead: at full size on 4 ranks on the card, the smoke ResNet
with ``--device cpu``. The transport is the run's ``backend``. Under
"gloo" (the default) the ranks share the current card and each rank's
gradients are staged through pinned host memory ("gloo-host"). Under
"nccl" rank r runs on card r (``cuda:r``), one card a rank, and the
exchange moves device memory over NCCL: on four H100s of one host that is
NVLink, P2P between the cards (``chip_nccl.py`` prints what NCCL chose).
Each rank is a process started with the ``spawn`` method, joined by a
``file://`` rendezvous in a fresh temporary directory. All ranks start from one
seeded init (or the flat parameters the caller gives) and train the same
steps under each algorithm in turn; each returns its losses, final
parameters (or, against a reference update, its distance from it), launch
counts, step times and the times of the steps' exchanges, and the
exchange of its first-step gradients under every algorithm against
``dist.all_reduce``'s. Every time is taken on the host clock once the
rank's card has finished its queued work (staging included under gloo;
NCCL returns before the device is done).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
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
from repro_torch.configs import get_smoke_config, resnet110
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import CifarLike, TokenStream
from repro_torch.engine.steps import (make_train_step, resolve_device,
                                      value_and_flat_grad)
from repro_torch.kernels import build, ops
from repro_torch.launch.mesh import check_cards, init_data_group, local_rows
from repro_torch.models.registry import build_model
from repro_torch.models.spec import flatten, views
from repro_torch.optim import rescale_lr, sgd


@dataclasses.dataclass(frozen=True)
class DPRun:
    """One data-parallel run of momentum SGD: ``world`` ranks, ``steps``
    steps under each of ``algorithms``, ``m_per_worker`` rows of the global
    batch per rank and per step, LR ``base_lr_1w * world`` (eq. 7).

    ``cfg``: a ResNet config (a row is an image of a ``CifarLike`` batch)
    or any LM config the registry builds (a row is a sequence of ``seq``
    tokens from ``TokenStream(seed=0)``; the model keeps f32 masters and
    computes in bf16, as ``launch.train``'s).
    ``dtype``: the ResNet's activation dtype (unused for an LM).
    ``init``: flat f32 initial parameters (a CPU tensor, for example the
    reference's bridged in), or None for ``model.init`` from a generator
    seeded with 0 on each rank's device.
    ``reference``: None, or the path of a file holding the update
    p_steps - p0 of the same run in one process (a flat f32 CPU tensor
    written by ``torch.save``, as ``one_process_updates`` writes it). With
    it each rank measures its own update
    against that one under each algorithm (``update_rel_err_vs_reference``)
    and, under psum, the largest spread of a parameter across the ranks
    (``rank_spread``; 0 when their digests agree), and keeps no copy of
    its parameters: a full-width LM's would not fit the host once per rank
    and algorithm.
    ``check_exchange``: whether the first-step gradient is all-reduced
    once under each algorithm and held against ``dist.all_reduce``'s
    (``exchange_check``; it costs a forward and backward and one
    all-reduce of each algorithm).
    ``device``: every rank's device: under gloo the ranks share it ("cuda":
    the current card); under nccl it must be "cuda", and rank r runs on
    card r (``rank_device``).
    ``backend``: "gloo" (host memory; on the card each exchange is staged
    through pinned host memory) or "nccl" (each rank's own card; as many
    visible cards as ranks, or ``run`` raises before any rank starts).
    """

    cfg: ModelConfig | resnet110.ResNetConfig = resnet110.CONFIG
    world: int = 4
    algorithms: tuple[str, ...] = ("psum", "ring", "doubling_halving")
    steps: int = 5
    m_per_worker: int = 128
    seq: int = 128
    base_lr_1w: float = 3e-4
    microbatches: int = 1
    dtype: torch.dtype = torch.bfloat16
    init: torch.Tensor | None = None
    reference: str | None = None
    check_exchange: bool = True
    device: str = "cuda"
    timeout_s: float = 300.0
    backend: str = "gloo"

    @property
    def lr(self) -> float:
        return rescale_lr(self.base_lr_1w, self.world, 1)

    @property
    def is_lm(self) -> bool:
        return not isinstance(self.cfg, resnet110.ResNetConfig)

    def model(self):
        return build_model(self.cfg, torch.float32 if self.is_lm else self.dtype)

    def batches(self) -> list[dict]:
        """The global batches of the run's steps, drawn on the host: token
        sequences for an LM, CIFAR-10's 50,000 images (``CifarLike``'s
        default) for the ResNet."""
        data = (TokenStream(self.cfg.vocab_size, self.seq, seed=0) if self.is_lm
                else CifarLike())
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


def rank_device(run: DPRun, rank: int) -> torch.device:
    """The device rank ``rank`` of ``run`` trains on: its own card
    ``cuda:<rank>`` under nccl, ``run.device`` (shared) under gloo."""
    if run.backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device(run.device)


def digest(x: torch.Tensor) -> str:
    """A short hex digest of a tensor's bytes, for comparing ranks' bits."""
    data = x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
    return hashlib.sha256(data).hexdigest()[:16]


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def exchange_check(grads: torch.Tensor, algorithms) -> dict:
    """All-reduce ``grads`` (not modified) once under each algorithm; per
    algorithm, the largest difference of its result from
    ``dist.all_reduce``'s (psum runs first) over the largest element of
    that sum. Untimed: a first call sets up the transport (pinned host
    buffers, gloo's pairs), so the steps' exchanges are the ones timed."""
    want = scale = None
    out = {}
    for alg in dict.fromkeys(("psum", *algorithms)):
        got = ALGORITHMS[alg](grads)
        if want is None:
            want, scale = got, float(got.abs().max())
        # in place (at full width each buffer is 3.1 GB of the rank's share
        # of the card), unless it is the sum compared against
        diff = got.sub(want) if got is want else got.sub_(want)
        out[alg] = {"max_rel_err_vs_psum": float(diff.abs_().max()) / scale}
        del got, diff
    return out


# elements a chunk when a full-width buffer is compared or reduced piecewise
_CHUNK = 1 << 26


def update_rel_err(params: torch.Tensor, p0: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 distance of the update ``params - p0`` from ``want`` (p0
    and want on the host, want possibly memory-mapped), in f64, a chunk at
    a time on ``params``' device."""
    num = den = 0.0
    dev = params.device
    for a in range(0, want.numel(), _CHUNK):
        w = want[a:a + _CHUNK].to(dev, torch.float64)
        d = params[a:a + _CHUNK].double() - p0[a:a + _CHUNK].to(dev, torch.float64) - w
        num += float(d.square().sum())
        den += float(w.square().sum())
    return math.sqrt(num / den)


def rank_spread(flat: torch.Tensor) -> float:
    """The largest difference between the ranks' values of one parameter:
    max over elements of (max over ranks - min over ranks), by a MAX and a
    MIN all-reduce of each chunk's copy (on the host under gloo, on the
    card under nccl)."""
    spread = 0.0
    on_card = dist.get_backend() == "nccl"
    for a in range(0, flat.numel(), _CHUNK):
        hi = flat[a:a + _CHUNK].clone() if on_card else flat[a:a + _CHUNK].cpu()
        lo = hi.clone()
        dist.all_reduce(hi, dist.ReduceOp.MAX)
        dist.all_reduce(lo, dist.ReduceOp.MIN)
        spread = max(spread, float((hi - lo).max()))
    return spread


def train(rank: int, run: DPRun, dev: torch.device) -> dict:
    """Rank ``rank``'s part of ``run`` in an initialised process group."""
    model, w = run.model(), run.world
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                local_rows(b, rank, w).items()} for b in run.batches()]
    init = run.initial_state(dev)["params"]
    out = {"rank": rank, "world": w, "device": str(dev), "card": dev.index,
           "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu"),
           "transport": transport(None, init.flat), "n_params": init.flat.numel(),
           "init_digest": digest(init.flat), "algorithms": {}, "exchange": {}}
    want = p0 = None
    if run.reference is not None:  # the init on the host, off the rank's card share
        want = torch.load(run.reference, mmap=True, weights_only=True)
        p0 = init.flat.cpu()
    if run.check_exchange:
        first = value_and_flat_grad(model, init, batches[0])[1]
        del init
        out["exchange"] = exchange_check(first, run.algorithms)
        del first
    else:
        del init
    for alg in run.algorithms:
        state = run.initial_state(dev)
        exchange_ms = []
        step = make_train_step(model, sgd(), grad_exchange=alg,
                               microbatches=run.microbatches, device=dev,
                               exchange_ms=exchange_ms)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, step_ms = [], []
        for batch in batches:
            t0 = _sync(dev)
            state, loss = step(state, batch, run.lr)
            losses.append(float(loss))
            step_ms.append(1e3 * (_sync(dev) - t0))
        flat = state["params"].flat
        result = out["algorithms"][alg] = {
            "losses": losses, "step_ms": step_ms, "exchange_ms": exchange_ms,
            "launches": ops.launch_counts(),
            "digest": digest(flat),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}
        if want is None:
            result["params"] = flat.cpu()
        else:
            result["update_rel_err_vs_reference"] = update_rel_err(flat, p0, want)
            if alg == "psum":  # the spread, when the ranks' bits differ
                digests = [None] * w
                dist.all_gather_object(digests, result["digest"])
                result["rank_spread"] = (0.0 if len(set(digests)) == 1
                                         else rank_spread(flat))
        del state, step, flat
    return out


def join(rank: int, run: DPRun, init_method: str) -> torch.device:
    """Set up a spawned rank: its share of the host's cores (one
    intra-op thread on a card, where the host only stages and adds the
    exchanged buffer; an equal share of the cores on the CPU: more
    threads than cores slowed a 4-rank ring exchange by several times),
    then its place in the run's group, on ``rank_device``. Returns its
    device."""
    device = rank_device(run, rank)
    torch.set_num_threads(1 if device.type == "cuda"
                          else max(1, (os.cpu_count() or 1) // run.world))
    return init_data_group(rank, run.world, init_method, run.backend, device,
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
    only load them; an nccl run with fewer cards than ranks raises first."""
    check_cards(spec.backend, spec.world, spec.device)
    if resolve_device(spec.device).type == "cuda":
        build.build_all()
    # every rank's collectives have waited at most timeout_s; the whole run
    # gets one timeout per algorithm and one for start-up and the checks
    return spawn(train_rank, spec.world, (spec,),
                 spec.timeout_s * (len(spec.algorithms) + 2))


def one_process_updates(spec: DPRun, into: Path) -> tuple[str, list[Path], float]:
    """The one-process train step at the global batch of ``spec`` (same
    init, batches and LR) on ``spec.device``: the digest of the init, the
    update p_t - p0 after each step t, saved as ``into/update<t>.pt`` (flat
    f32 CPU tensors, each a ``reference`` for a run of t steps; at full
    width each is 3.1 GB, so none stays in memory), and the largest
    element of the last update."""
    dev = resolve_device(spec.device)
    state = spec.initial_state(dev)
    p0 = state["params"].flat.clone()
    step = make_train_step(spec.model(), sgd(), device=dev)
    paths = []
    for t, batch in enumerate(spec.batches(), 1):
        state, _ = step(state, batch, spec.lr)
        update = state["params"].flat - p0
        paths.append(into / f"update{t}.pt")
        torch.save(update.cpu(), paths[-1])
    scale = float(update.abs().max())
    init_digest = digest(p0)
    del state, step, p0, update
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return init_digest, paths, scale


def bytes_sent_per_rank(algorithm: str, n: int, w: int) -> float | None:
    """Bytes each rank sends in one all-reduce of n f32 values, from the
    schedule simulators' counters (None for ``dist.all_reduce``, whose
    schedule is the backend's). Where w divides n the counters scale with
    the segment's bytes, so the vector is simulated as w elements of n / w
    values each: a full-width LM's gradient would need w x n f64 values in
    the simulator."""
    sim = schedules.ALGORITHMS.get(algorithm)
    if sim is None:
        return None
    if n % w == 0:
        return sim(np.zeros((w, w), np.float32), itemsize=4 * n // w)[1].bytes_sent
    return sim(np.zeros((w, n), np.float32), itemsize=4)[1].bytes_sent


def summary(spec: DPRun, ranks: list[dict]) -> dict:
    """Per algorithm: rank 0's losses, the median step and exchange times
    over all ranks' steps, bytes sent per rank and step, whether every
    rank's final parameters carry rank 0's bits, launches per rank and
    step, and the largest first-step difference from ``dist.all_reduce``
    (None when the exchange was not checked); and each rank's card index
    (None on the CPU)."""
    r0 = ranks[0]
    out = {"world": spec.world, "config": spec.cfg.name,
           "n_params": r0["n_params"],
           "global_batch": spec.m_per_worker * spec.world, "lr": spec.lr,
           "transport": r0["transport"], "device": r0["device_name"],
           "cards": [r["card"] for r in ranks],
           "same_init": len({r["init_digest"] for r in ranks}) == 1,
           "algorithms": {}}
    for alg in spec.algorithms:
        runs = [r["algorithms"][alg] for r in ranks]
        exchanged = [r["exchange"][alg] for r in ranks if alg in r["exchange"]]
        out["algorithms"][alg] = {
            "losses_rank0": runs[0]["losses"],
            "step_ms_median": statistics.median(
                t for x in runs for t in x["step_ms"]),
            "exchange_ms_median": statistics.median(
                t for x in runs for t in x["exchange_ms"]),
            "bytes_sent_per_rank": bytes_sent_per_rank(alg, r0["n_params"], spec.world),
            "ranks_bit_identical": len({x["digest"] for x in runs}) == 1,
            "launches_per_rank_step": [
                {k: v / spec.steps for k, v in x["launches"].items()} for x in runs],
            "max_rel_err_vs_psum": max((e["max_rel_err_vs_psum"] for e in exchanged),
                                       default=None),
            "peak_memory_bytes": [x["peak_memory_bytes"] for x in runs]}
        if spec.reference is not None:
            out["algorithms"][alg]["update_rel_err_vs_reference"] = [
                x["update_rel_err_vs_reference"] for x in runs]
            if alg == "psum":
                out["algorithms"][alg]["rank_spread"] = runs[0]["rank_spread"]
    return out


# examples/explicit_allreduce.py's run: 8 host devices, 8 sequences of 64
# tokens each, SGD at a constant LR of 0.05, 10 steps
EXAMPLE = dict(world=8, m_per_worker=8, seq=64, lr=0.05, steps=10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="an LM of the registry (at smoke size) or resnet-110")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cpu = resolve_device(args.device).type == "cpu"
    if args.arch == "resnet-110":
        spec = DPRun(cfg=resnet110.smoke_config() if cpu else resnet110.CONFIG,
                     m_per_worker=16 if cpu else 128, device=args.device)
    else:
        e = EXAMPLE
        spec = DPRun(cfg=get_smoke_config(args.arch), world=e["world"],
                     steps=e["steps"], m_per_worker=e["m_per_worker"], seq=e["seq"],
                     base_lr_1w=e["lr"] / e["world"], device=args.device)
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
