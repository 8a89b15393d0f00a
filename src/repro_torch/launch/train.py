"""End-to-end LM training launcher (torch twin of ``repro.launch.train``).

Trains any ported LM ``--arch`` (full or ``--smoke`` reduced config:
dense, MoE, VLM backbone, mamba2-780m, jamba) on the synthetic token
pipeline with AdamW + warmup-cosine, checkpointing through the elastic
store. The parameters are f32 masters in one flat buffer; the forward
runs in bf16, through the ``rmsnorm`` kernel (and ``swa_attention``
where the model has attention) on the GPU. ``--workers`` sets the data-parallel
worker count the scheduler allocated: per-worker batch m stays fixed,
global batch = m * workers on one device, LR linearly rescaled (paper
eq. 7).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 100 --workers 4

Runs on the GPU; ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import (init_train_state, make_train_step,
                                      resolve_device)
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, rescale_lr, warmup_cosine


def main(argv=None):
    """-> (first_loss, last_loss) of the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
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
    args = ap.parse_args(argv)
    if args.grad_exchange is not None:
        ap.error(f"--grad-exchange {args.grad_exchange}: this launcher trains "
                 "in one process; the paper's exchange between processes runs "
                 "in repro_torch.launch.explicit_allreduce")
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, torch.float32)  # f32 masters, bf16 compute
    opt = adamw()
    data = TokenStream(cfg.vocab_size, args.seq, seed=0)
    global_batch = args.m_per_worker * args.workers
    base_lr = rescale_lr(args.lr, args.workers, 1)
    sched = warmup_cosine(base_lr, warmup=min(20, args.steps // 5 + 1),
                          total=args.steps)
    step_fn = make_train_step(model, opt, device=dev)

    state = init_train_state(model, opt, device=dev)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    step0 = 0
    if store and args.resume and store.latest_step() is not None:
        state, meta, secs = store.restore(state)
        step0 = store.latest_step()
        print(f"restored step {step0} in {secs:.2f}s (meta={meta})")

    t0 = time.perf_counter()
    first_loss = None
    for i in range(step0, step0 + args.steps):
        state, loss = step_fn(state, data.batch(i, global_batch), sched(i))
        if first_loss is None:
            first_loss = float(loss)
        if i % args.log_every == 0 or i == step0 + args.steps - 1:
            dt = time.perf_counter() - t0
            tok_s = (i - step0 + 1) * global_batch * args.seq / max(dt, 1e-9)
            print(f"step {i:5d} loss {float(loss):.4f} lr {sched(i):.2e} "
                  f"tok/s {tok_s:,.0f}", flush=True)
    if store:
        secs = store.save(step0 + args.steps, state,
                          meta={"workers": args.workers})
        print(f"checkpointed step {step0 + args.steps} in {secs:.2f}s")
    return first_loss, float(loss)


if __name__ == "__main__":
    main()
