"""End-to-end LM training launcher (torch twin of ``repro.launch.train``).

Trains any ported LM ``--arch`` (full or ``--smoke`` reduced config:
dense, MoE, VLM backbone, mamba2-780m, jamba) on the synthetic token
pipeline with AdamW + warmup-cosine, checkpointing through the elastic
store. The parameters are f32 masters in one flat buffer; the forward
runs in bf16, through the ``rmsnorm`` kernel (and ``swa_attention``
where the model has attention) on the GPU. ``--workers`` sets the data-parallel
worker count the scheduler allocated: per-worker batch m stays fixed,
global batch = m * workers, LR linearly rescaled (paper eq. 7).

With ``--grad-exchange ring|doubling_halving`` and a process group of more
than one rank, each rank trains on its rows of the global batch and the
gradients are all-reduced by the paper's algorithm before the update (the
reference's ``shard_map`` path); otherwise every step is the plain one
over the whole global batch (the reference's path on one device).
``--workers`` stays the scheduler's allocation, independent of the number
of ranks. The ranks join the group before ``main`` is called (as
``launch.explicit_allreduce.spawn`` starts them) or, when ``WORLD_SIZE``
is set (torchrun), here through ``env://`` over ``--backend``: gloo (the
default; ranks may share a card) or nccl (one card a rank, the card
torchrun's ``LOCAL_RANK`` names; more ranks than visible cards, or
``--device cpu``, raise before the group starts). Rank 0 alone logs and
saves the checkpoint; every rank restores. Rank 0 logs when every rank
has joined a group this call started, and the checksum of the
parameters beside each save and restore.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 100 --workers 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2.5-3b --smoke --workers 4 --grad-exchange ring --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen2.5-3b --workers 4 \\
      --m-per-worker 2 --grad-exchange ring --backend nccl

Runs on the GPU; ``--device cpu`` runs the plain versions on the CPU.
The ``tok/s`` of a log line counts the steps after the first over the
time since the first step's loss was read. ``--trace PATH`` runs those
steps under a ``core.telemetry.StepTracer`` and writes its spans and
counters to PATH (Chrome trace-event JSON, for Perfetto) at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import telemetry
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import (init_train_state, make_train_step,
                                      resolve_device)
from repro_torch.launch.mesh import check_cards, init_data_group, local_rows
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, rescale_lr, warmup_cosine


def _join(device, backend: str = "gloo") -> tuple[torch.device, bool]:
    """The step's device, and whether this call started the process group:
    it does when none is initialised and ``WORLD_SIZE`` (torchrun's
    environment) names more than one rank, on the card ``LOCAL_RANK``
    picks, over ``backend``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"--backend nccl needs the card, got --device {device}")
    dev = resolve_device(device)
    if dist.is_initialized() or world <= 1:
        return dev, False
    check_cards(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)), dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return init_data_group(int(os.environ["RANK"]), world, "env://", backend, dev), True


def checksum(flat: torch.Tensor) -> str:
    """A checksum of a flat f32 buffer's bits, computed where it lies: the
    sums of its words and of each word times its index plus one, both
    modulo 2**64 (exact in any order), a chunk at a time."""
    words = flat.detach().view(torch.int32)
    s1 = s2 = 0
    for a in range(0, words.numel(), 1 << 26):
        w = words[a:a + (1 << 26)].long()
        idx = torch.arange(a + 1, a + 1 + w.numel(), device=w.device)
        s1 = (s1 + int(w.sum())) % 2**64
        s2 = (s2 + int((w * idx).sum())) % 2**64
    return f"{s1:016x}{s2:016x}"


def main(argv=None):
    """-> (first_loss, last_loss) of the run: this rank's local losses when
    the gradients are exchanged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (a run whose "
                         "checkpoints the disk holds only cut in depth)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--m-per-worker", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="base LR at 1 worker (eq. 7 scales it)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-exchange", default=None,
                    choices=[None, "ring", "doubling_halving"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the process group's backend when torchrun starts the ranks")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the steps after the first (core.telemetry spans and "
                         "counters) and write them to PATH as Chrome trace-event JSON "
                         "(PATH.rank<r> suffixed per rank when there are several)")
    args = ap.parse_args(argv)
    dev, own_group = _join(args.device, args.backend)
    try:
        if own_group:
            dist.barrier()
            if dist.get_rank() == 0:
                print(f"process group ready: {args.backend}, "
                      f"{dist.get_world_size()} ranks", flush=True)
        return _train(args, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, dev: torch.device):
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    exchange = args.grad_exchange if world > 1 else None

    def log(*a, **k):
        if rank == 0:
            print(*a, **k)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, torch.float32)  # f32 masters, bf16 compute
    opt = adamw()
    data = TokenStream(cfg.vocab_size, args.seq, seed=0)
    global_batch = args.m_per_worker * args.workers
    base_lr = rescale_lr(args.lr, args.workers, 1)
    sched = warmup_cosine(base_lr, warmup=min(20, args.steps // 5 + 1),
                          total=args.steps)
    step_fn = make_train_step(model, opt, grad_exchange=exchange, device=dev)

    state = init_train_state(model, opt, device=dev)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    step0 = 0
    if store and args.resume and store.latest_step() is not None:
        state, meta, secs = store.restore(state)
        step0 = store.latest_step()
        log(f"restored step {step0} in {secs:.2f}s (meta={meta}, params "
            f"checksum {checksum(state['params'].flat)})", flush=True)

    tracer = telemetry.StepTracer() if args.trace else None
    first_loss, t0 = None, None
    with contextlib.ExitStack() as traced:
        for i in range(step0, step0 + args.steps):
            batch = data.batch(i, global_batch)
            if exchange:
                batch = local_rows(batch, rank, world)
            state, loss = step_fn(state, batch, sched(i))
            if first_loss is None:
                # float() waits for the step: the rate's clock starts after
                # the first step's build and warm-up
                first_loss = float(loss)
                t0 = time.perf_counter()
                if tracer is not None:
                    traced.enter_context(telemetry.tracing(tracer))
            if i % args.log_every == 0 or i == step0 + args.steps - 1:
                line = f"step {i:5d} loss {float(loss):.4f} lr {sched(i):.2e}"
                if i > step0:  # float(loss) has waited for step i
                    dt = time.perf_counter() - t0
                    line += f" tok/s {(i - step0) * global_batch * args.seq / dt:,.0f}"
                log(line, flush=True)
    if tracer is not None:
        path = args.trace if world == 1 else f"{args.trace}.rank{rank}"
        tracer.write_chrome_trace(path)
        log(f"spans and counters of steps {step0 + 1}-{step0 + args.steps - 1} in {path}",
            flush=True)
    if store:
        if world > 1:
            dist.barrier()
        if rank == 0:
            secs = store.save(step0 + args.steps, state,
                              meta={"workers": args.workers})
            log(f"checkpointed step {step0 + args.steps} in {secs:.2f}s (params "
                f"checksum {checksum(state['params'].flat)})", flush=True)
        if world > 1:  # no rank returns before the checkpoint is written
            dist.barrier()
    return first_loss, float(loss)


if __name__ == "__main__":
    main()
