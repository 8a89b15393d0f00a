#!/usr/bin/env python3
"""Sweep the base LR of chip_smoke.py's ResNet-110 train cell on one GPU.

  python3 chip_train_lr.py [--lrs 1e-5,3e-4,0.02]

For each base LR per worker, runs chip_smoke.py's segments (20 steps at
w = 4, a restart at w = 8 for 10, another at w = 8 for 40) at full size
and prints, as one JSON line per LR: every step's loss, the held-out loss
and accuracy after 30 and 70 steps, and one train step's loss and flat
gradient on the card against the same step in f32 on the CPU at the
checkpoints of steps 0, 20, 30 and 70 (chip_smoke.step_vs_f32). These are
the readings that chip_smoke.py's base LR, learning gate and step limits
were set from. It checks nothing and exits 0 when every LR ran.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs

LRS = (1e-5, 1e-4, 3e-4, 1e-3, 0.0025, 0.01, 0.02)


def sweep_one(model, data, base: float) -> dict:
    cs.TRAIN["base_lr_1w"] = base
    out = {"base_lr_1w": base, "losses": [], "held_out": [], "step_vs_f32": {}}
    with tempfile.TemporaryDirectory() as tmp:
        store = cs.CheckpointStore(tmp)
        tr = cs.trainer(model, store, data)
        store.save(0, tr.fresh_state())
        for w, n in cs.TRAIN_SEGMENTS:
            r = tr.train_segment(w, n, log_every=1)
            out["losses"].append([loss for _, _, loss in r.losses])
            if r.losses[-1][0] + 1 in (30, 70):
                out["held_out"].append(cs.held_out(model, store, data))
        for step in (0, 20, 30, 70):
            out["step_vs_f32"][step] = cs.step_vs_f32(model, store, data, step)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default=",".join(map(str, LRS)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_train_lr: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model = cs.build_model(cs.resnet110.CONFIG)
    data = cs.CifarLike(size=cs.TRAIN_DATASET, seed=0)
    for base in (float(x) for x in args.lrs.split(",")):
        print(json.dumps(sweep_one(model, data, base)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
