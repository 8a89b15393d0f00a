#!/usr/bin/env python3
"""Drive the port's data-parallel and sharded paths on four NVIDIA GPUs of
one host over NCCL, one card a rank.

  python3 chip_nccl.py                    # every phase
  python3 chip_nccl.py --phase calibrate  # only the phases named (repeatable)

It refuses to start with fewer than four cards: there is no one-card or
gloo fallback. It prints each card's name and power limit and
``nvidia-smi topo -m``, the free host memory and disk, and sets
``NCCL_DEBUG=INFO`` for every rank it starts (the logs go to
``<out>/nccl/``; the transports NCCL chose are printed from them; ``--out``
names the directory, ``build/chip_nccl`` by default).
It builds the kernels once (``build.build_all``) before any rank starts.
The phases, each with gates that raise:

a. exchange: ring and halving-doubling all-reduce (``collectives.dist``)
   of seeded inputs of EXCHANGE_SIZES elements at w = 2, 3, 4 (sub-groups
   of the first w ranks) over NCCL on the cards, and the same calls on 4
   gloo ranks on the host: bit for bit equal on every rank;
   ``dist.all_reduce`` within 1e-5 of the largest element.
b. calibrate: alpha and beta from one ring-neighbour round of
   ``collectives.dist._exchange`` on all four cards at ROUND_BYTES (host
   clock with the device synced, and CUDA events), gamma from the round's
   in-place ``torch.add`` alone (CUDA events); each a median of REPS
   calls after WARM untimed ones, fitted by ``fit_coefficients``. Then
   the explicit ring and halving-doubling at w = 2 and 4 at
   PREDICT_ELEMENTS, each measured beside its prediction by the schedule
   counters (``cost.simulated_step_time``) and eq. 2 / 3, and
   ``dist.all_reduce`` with its bus bandwidth.
c. resnet_dp: ``chip_smoke.py``'s dp phase (ResNet-110, 4 ranks of 128
   images, 5 steps under psum, ring and halving-doubling, the two faulty
   exchanges, then 3 ranks under ring) with ``backend="nccl"``, under
   ``chip_smoke.dp_gates`` with the nccl transport, every rank on its own
   card.
d. lm_dp: ``fused_sgd_update`` and ``explicit_allreduce.update_rel_err``
   held at n = 3,397,103,616 (past 2**31 elements) on card 0; then
   qwen2.5-3b at full width and depth (36 layers) on 4 ranks over NCCL,
   ``chip_smoke.py``'s lm_dp recipe: 2 x 128 tokens a rank, SGD at 0.05,
   one timed step under each exchange, the two faulty exchanges; 73
   rmsnorm, 36 swa_attention and 1 fused_sgd_update launches a rank and
   step, the update within 0.1 of the one-process update.
e. sharded: ``engine.steps.make_sharded_train_step`` and the sharded
   prefill and gradient on a 2 x 2 ("data", "model") mesh of NCCL
   DeviceMeshes: ``tests/_torch_sharded_rank.py``'s cases, configs,
   batch and f32 activations, each rank held to the one-process step in
   the same rank at the test's tolerance, with the kernels' launches on
   the local shards equal to the one-process run's.
f. restart: ``launch.train`` (qwen2.5-3b, AdamW, ring over NCCL) under
   ``torchrun --standalone`` on 2 ranks, checkpointed, then relaunched on
   4 ranks with ``--resume``: the resize cost in parts (save, the old
   ranks' exit, the relaunch until NCCL is ready on every rank, restore,
   the first step, the total beside the paper's ~10 s), the restored step
   and parameter checksum equal to the saved ones, eq. 7's LR at 4
   workers, finite losses. At full depth when the disk holds two
   checkpoints and the host memory four restores, else at the deepest
   cut that does (printed).
g. dbrx_tp: dbrx-132b at full published width and depth (131.6 B
   parameters) served on a (1, 4) ("data", "model") mesh of NCCL
   DeviceMeshes, a card a rank: each rank draws only its local shards
   (``models.spec.init_local``, 66.42 GB), then runs the [2, 1024]
   prefill through ``engine.steps.make_prefill`` with a mesh ``Sharder``
   in bf16 and with f32 activations, each held to the plain versions on
   the same shards with the routing flips counted (81 rmsnorm and 40
   swa_attention launches a pass), decode against prefill at capacity
   factor 8 over DBRX_POSITIONS positions with both faulty-cache controls
   in the gated run (81 rmsnorm a step), ``launch.serve.serve`` on the
   mesh (the same tokens on every rank) and a profile of a decode step
   and a prefill, each held to the bound of the dry-run of the same step
   on the (1, 4) AbstractMesh, whose collective bytes are printed.

Every phase asked for runs, whatever an earlier one found; the script
exits non-zero if any failed. Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs

from repro_torch.collectives import cost  # noqa: E402
from repro_torch.collectives import dist as cdist  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_update as sgd_kernel  # noqa: E402
from repro_torch.launch import explicit_allreduce as dp  # noqa: E402
from repro_torch.launch import mesh as mesh_module  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.engine.steps import make_decode_step, make_prefill  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import spec as pspec  # noqa: E402
from repro_torch.models.layers import Sharder  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import rescale_lr, warmup_cosine  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402

check = cs.check
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_nccl"  # logs; main's --out
CARDS = 4
PHASES = ("exchange", "calibrate", "resnet_dp", "lm_dp", "sharded", "dbrx_tp", "restart")
# set by a CPU rehearsal only: gloo ranks on the host, launch.train at
# the smoke config
BACKEND = "nccl"
DEVICE = "cuda"
TRAIN_FLAGS: tuple[str, ...] = ()
# a collective that waits this long raises (NCCL's watchdog); a phase's
# ranks still running after SPAWN_TIMEOUT_S are killed
TIMEOUT_S = 120
SPAWN_TIMEOUT_S = 300
SHARDED_TIMEOUT_S = 180
# (a) lengths in f32 elements: tiny, odd, a multiple of no world size,
# past 2**16, and ResNet-110's gradient
EXCHANGE_SIZES = (1, 45, 1000, 65539, cs.RESNET_PARAMS)
EXCHANGE_WORLDS = (2, 3, 4)
# (b) one round's message from 4 KB to 1 GB in powers of 4; the medians
REPS, WARM = 20, 3
ROUND_BYTES = tuple(4096 * 4**k for k in range(10))
PREDICT_WORLDS = (2, 4)
PREDICT_ELEMENTS = (cs.RESNET_PARAMS, 1 << 24, 1 << 28)
# (d) qwen2.5-3b at full depth: its flat f32 parameter count
LM_PARAMS = 3_397_103_616
LM_DP_TIMEOUT_S = 180
# (f) the resize: steps before and after, tokens a worker
RESTART = dict(workers=(2, 4), steps=(2, 2), m_per_worker=2, seq=128, lr=3e-4)
RESTART_TIMEOUT_S = 900
# (g) dbrx-132b at full published width and depth (40 layers, d_model
# 6,144, 48/8 heads of 128, 16 experts top-4 of d_ff 10,752, vocab
# 100,352) served on a (1, 4) ("data", "model") mesh, a card a rank: the
# rules shard its experts, heads, MLP and vocab over "model" only, so each
# rank holds a quarter, 66.42 GB (263 GB of bf16 experts in all: no card
# holds the model). Its weights are drawn on each rank as local shards
# (models.spec.init_local, seed DBRX_SEED). The gates read the runs
# DBRX_GATED names, as the one-card dense phase's DENSE_GATED does. At 40
# layers with random weights its bf16 readings are rounding: on four
# NVIDIA H100 80GB HBM3 at 700 W, with both runs gated, the bf16 prefill
# read rel err 0.0107 and argmax 0.989 against the plain versions (1,295
# of 81,920 routing choices flipped), but bf16 decode against prefill read
# argmax 0.891 over 64 positions (rel err 0.020), below decode_gate's
# 0.90, while the f32 run read 1.3e-6 and 1.0 there and both faulty
# controls 0.016 in each. So the gated run has f32 activations, the bf16
# weights cast at use (no rank holds 132 GB of f32 weights), and the bf16
# prefill's launches are gated and its agreement reported. Decode against
# prefill over DBRX_POSITIONS positions at capacity factor 8, both faulty
# caches decoded in the same steps (a step takes about 1 s of host time:
# DTensor's Python dispatch of 5,938 kernels), and the serve of
# chip_smoke.py's SERVE (159 steps) through launch.serve.serve on the mesh.
DBRX_ARCH = cs.TP_ARCH
DBRX_PARAMS = 131_596_523_520  # param_count()
DBRX_MESH = mesh_module.AbstractMesh((1, CARDS), ("data", "model"))
DBRX_LOCAL_BYTES = 66.42e9  # a rank's shards, from local_specs
DBRX_SEED = 0
DBRX_GATED = ("f32",)
DBRX_POSITIONS = cs.CONTROL_POSITIONS
DBRX_SERVE = dict(cs.SERVE)
DBRX_TIMEOUT_S = 1500
# the one-card gloo-host readings of PERF.md section 5 (NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's
GLOO_HOST = {"resnet_exchange_ms_w4": "16.1-19.9", "lm_2layer_exchange_s_w4": "4.85-7.01"}


# -------------------------------------------------------------- helpers --
def rank_device(rank: int) -> torch.device:
    return torch.device("cuda", rank) if BACKEND == "nccl" else torch.device(DEVICE)


def inputs(w: int, n: int, rank: int) -> np.ndarray:
    return np.random.default_rng([7, w, n, rank]).standard_normal(n).astype(np.float32)


def fit_line(x, t) -> tuple[float, float]:
    """(a, b) minimising the sum of ((a + b x - t) / t)^2: every size's
    relative error weighs the same, so the small messages fix a and the
    large ones b."""
    x, t = np.asarray(x, float), np.asarray(t, float)
    cols = np.stack([1 / t, x / t], 1)
    scale = np.linalg.norm(cols, axis=0)
    (a, b), *_ = np.linalg.lstsq(cols / scale, np.ones_like(t), rcond=None)
    return float(a / scale[0]), float(b / scale[1])


def fit_coefficients(round_s: dict, add_s: dict) -> dict:
    """alpha, beta from one neighbour round's seconds by its bytes sent
    (t = alpha + s beta), gamma from the in-place add's seconds by the
    bytes reduced (t = c + s gamma; c, the add's launch, is reported and
    belongs to no term of eqs. 2-4)."""
    alpha, beta = fit_line(list(round_s), list(round_s.values()))
    c, gamma = fit_line(list(add_s), list(add_s.values()))
    return {"alpha": alpha, "beta": beta, "gamma": gamma, "add_intercept": c}


def predict(hw: cost.HardwareCoefficients, w: int, n_bytes: int, algorithm: str) -> dict:
    """One all-reduce of n_bytes at w ranks: the schedule counters' time
    (``simulated_step_time`` without compute) and eq. 2 (ring) or 3
    (halving-doubling) as ``cost.py`` writes it."""
    eq = {"ring": cost.t_ring, "doubling_halving": cost.t_dh}[algorithm]
    return {"counters": cost.simulated_step_time(0, 0.0, 0.0, w, n_bytes, hw, algorithm),
            "eq": eq(0, 0.0, 0.0, w, n_bytes, hw)}


def timed(fn, dev: torch.device, reps: int = REPS, warm: int = WARM) -> dict:
    """Median seconds of ``reps`` calls of fn after ``warm`` untimed ones,
    on the host clock (device synced before and after, every rank released
    together by a barrier of the world) and between CUDA events recorded
    around the call on the current stream."""
    for _ in range(warm):
        fn()
    host, events = [], []
    for _ in range(reps):
        dp._sync(dev)
        dist.barrier()
        dp._sync(dev)
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            t1 = dp._sync(dev)
            events.append(a.elapsed_time(b) / 1e3)
        else:  # a CPU rehearsal has no events
            t0 = time.perf_counter()
            fn()
            t1 = dp._sync(dev)
            events.append(t1 - t0)
        host.append(t1 - t0)
    return {"host_s": statistics.median(host), "event_s": statistics.median(events),
            "n": len(host)}


def run_phase(name: str, fn, results: dict, failed: list) -> None:
    t0 = time.perf_counter()
    print(f"--- {name} ---", flush=True)
    try:
        results[name] = fn()
        print(f"{name} phase passed in {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception:  # every phase runs; the exit code reports the failure
        traceback.print_exc()
        failed.append(name)
        print(f"{name} phase FAILED after {time.perf_counter() - t0:.1f} s", flush=True)


def nccl_transports() -> dict:
    """NCCL's choices from the INFO logs of every rank so far: each
    distinct ``via ...`` of its channel lines and how many lines name it,
    and the lines that mention NVLS."""
    via, nvls = {}, []
    for path in sorted((OUT / "nccl").glob("*.log")):
        for line in path.read_text(errors="replace").splitlines():
            m = re.search(r" via (\S+)", line)
            if m:
                via[m.group(1)] = via.get(m.group(1), 0) + 1
            if "NVLS" in line and len(nvls) < 8:
                nvls.append(line.split("NCCL INFO", 1)[-1].strip())
    return {"via": via, "nvls_lines": nvls}


def host_room(path: Path) -> dict:
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            mem[k] = int(v.split()[0]) * 1024
    return {"mem_available": mem["MemAvailable"], "mem_total": mem["MemTotal"],
            "disk_free": shutil.disk_usage(path).free, "disk_path": str(path)}


# ------------------------------------------------ (a, b) the collectives --
# An NCCL default group bound to a card splits its communicator for every
# new group, and its non-members take part in the split; so the card ranks
# make their NCCL sub-groups alone, every rank in the same order, and the
# host's gloo ranks (the bits the cards must match) are a spawn of their own.
def collective_rank(rank, world, backend, tasks, init_method, out_dir):
    """One of four ranks on ``backend`` (nccl: card ``rank``; gloo: the
    host): the sub-groups of the first w ranks, then the parity inputs'
    all-reduces and the calibration asked for; saves the readings."""
    dev = (rank_device(rank) if backend == BACKEND else torch.device("cpu"))
    torch.set_num_threads(1)
    mesh_module.init_data_group(rank, world, init_method, backend, dev, TIMEOUT_S)
    try:
        groups = {w: dist.new_group(list(range(w)))
                  for w in sorted({*EXCHANGE_WORLDS, *PREDICT_WORLDS})}
        out = {"card": dev.index, "device_name": (torch.cuda.get_device_name(dev)
                                                  if dev.type == "cuda" else "cpu")}
        if "exchange" in tasks:
            out["exchange"] = reduced(rank, dev, groups)
        if "calibrate" in tasks:
            out["calibrate"] = calibrate(rank, world, dev, groups)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def reduced(rank: int, dev: torch.device, groups: dict) -> dict:
    """Each seeded input all-reduced by every schedule over the first w
    ranks (this rank among them), as host tensors, with the transport and
    whether the input was kept."""
    out = {}
    for w in EXCHANGE_WORLDS:
        if rank >= w:
            continue
        for n in EXCHANGE_SIZES:
            x = torch.from_numpy(inputs(w, n, rank))
            on_dev = x.to(dev)
            row = {"transport": cdist.transport(groups[w], on_dev)}
            algs = (("ring", "doubling_halving", "psum") if w & (w - 1) == 0
                    else ("ring", "psum"))
            for alg in algs:
                row[alg] = cdist.ALGORITHMS[alg](on_dev, groups[w]).cpu()
            row["input_kept"] = bool(torch.equal(on_dev.cpu(), x))
            out[f"w{w}/n{n}"] = row
    return out


def calibrate(rank: int, world: int, dev: torch.device, groups: dict) -> dict:
    """The round and add timings at every size on all ranks, then the
    all-reduces at w ranks; every rank takes part in every timed call's
    barrier (a rank outside the w times nothing), so no rank waits on a
    sub-group it is not in."""
    out = {"round": {}, "add": {}, "allreduce": {}}
    to, frm = (rank + 1) % world, (rank - 1) % world
    for s in ROUND_BYTES:
        send = torch.ones(s // 4, device=dev)
        recv = torch.empty_like(send)
        out["round"][s] = timed(lambda: cdist._exchange(send, recv, to, frm, None), dev)
        out["add"][s] = timed(lambda: torch.add(send, recv, out=send), dev)
        del send, recv
    for w in PREDICT_WORLDS:
        for n in PREDICT_ELEMENTS:
            buf = torch.zeros(n, device=dev) if rank < w else None
            for alg in ("ring", "doubling_halving", "psum"):
                got = timed((lambda: cdist.allreduce_(buf, groups[w], alg)) if rank < w
                            else (lambda: None), dev)
                if rank < w:
                    out["allreduce"][f"w{w}/n{n}/{alg}"] = got
            del buf
    return out


def collectives_phase(tasks: tuple[str, ...], smi: list[str]) -> dict:
    t0 = time.perf_counter()
    ranks = dp.spawn(collective_rank, CARDS, (CARDS, BACKEND, tasks), SPAWN_TIMEOUT_S)
    out = {"cards": [r["card"] for r in ranks], "seconds": None}
    check(out["cards"] == list(range(CARDS)) or BACKEND != "nccl",
          f"collectives: ranks on cards {out['cards']}")
    if "exchange" in tasks:
        host = dp.spawn(collective_rank, CARDS, (CARDS, "gloo", ("exchange",)),
                        SPAWN_TIMEOUT_S)
        out["exchange"] = exchange_report(ranks, host)
    if "calibrate" in tasks:
        out["calibrate"] = calibration_report(ranks, smi)
    out["seconds"] = time.perf_counter() - t0
    return out


def exchange_report(ranks: list[dict], host: list[dict]) -> dict:
    """Per rank, world and length: each schedule's result on the cards
    against the host's, bit for bit; psum against the host's ring."""
    rows = {}
    for r, (res, want) in enumerate(zip(ranks, host)):
        for k, got in res["exchange"].items():
            ref_ = want["exchange"][k]
            ring = ref_["ring"]
            rows[f"rank{r}/{k}"] = {
                "transport": got["transport"], "input_kept": got["input_kept"],
                **{alg: bool(torch.equal(got[alg].view(torch.int32),
                                         ref_[alg].view(torch.int32)))
                   for alg in ("ring", "doubling_halving") if alg in got},
                "psum_rel_err": float((got["psum"] - ring).abs().max() / ring.abs().max())}
    worst = max(v["psum_rel_err"] for v in rows.values())
    identical = sum(all(v[a] for a in ("ring", "doubling_halving") if a in v)
                    for v in rows.values())
    print(f"exchange: {len(rows)} (rank, world, length) cells; ring and "
          f"halving-doubling over {BACKEND} on the cards against 4 gloo ranks on "
          f"the host: bit-identical in {identical}; dist.all_reduce vs the host's "
          f"ring, worst {worst}", flush=True)
    print("exchange: " + json.dumps(rows), flush=True)
    for k, v in rows.items():
        check(v["transport"] == BACKEND and v["input_kept"], f"exchange {k}: {v}")
        for alg in ("ring", "doubling_halving"):
            check(v.get(alg, True), f"exchange {k}: {alg} on the cards differs from "
                                    "the host's bits")
        check(v["psum_rel_err"] <= cs.DP_F32_LIMIT, f"exchange {k}: psum {v['psum_rel_err']}")
    check(len(rows) == len(EXCHANGE_SIZES) * sum(EXCHANGE_WORLDS), "exchange: cells run")
    return {"cells": len(rows), "bit_identical": identical, "psum_worst_rel_err": worst,
            "transports": nccl_transports()}


def calibration_report(ranks: list[dict], smi: list[str]) -> dict:
    """Medians over the ranks of each size's median; the fits; the
    predictions beside the measured all-reduce times."""
    cal = [r["calibrate"] for r in ranks]

    def over_ranks(key, cell, clock):
        return statistics.median(c[key][cell][clock] for c in cal if cell in c[key])

    for c in cal:
        for part in ("round", "add", "allreduce"):
            check(all(v["n"] >= REPS for v in c[part].values()), f"calibrate: {part} reps")
    round_host = {s: over_ranks("round", s, "host_s") for s in ROUND_BYTES}
    round_event = {s: over_ranks("round", s, "event_s") for s in ROUND_BYTES}
    add_event = {s: over_ranks("add", s, "event_s") for s in ROUND_BYTES}
    python = fit_coefficients(round_host, add_event)
    nccl = fit_coefficients(round_event, add_event)
    out = {"card": smi, "round_host_s": round_host, "round_event_s": round_event,
           "add_event_s": add_event, "fit_python_round": python, "fit_nccl_events": nccl,
           "allreduce": {}}
    # the coefficient set: the Python round's alpha (the port's
    # per-message software latency, as Horovod's is the paper's), beta
    # from the same host-clock fit, gamma from the add alone
    hw = cost.HardwareCoefficients(alpha=python["alpha"], beta=python["beta"],
                                   gamma=python["gamma"], name="h100_nvlink")
    out["coefficients"] = dataclasses.asdict(hw)
    print(f"calibrate [{'; '.join(smi)}]: one ring-neighbour round over {BACKEND}, "
          f"4 ranks, medians of {REPS} after {WARM}:", flush=True)
    for s in ROUND_BYTES:
        print(f"  {s:>11d} B: round {1e6 * round_host[s]:.2f} us host clock "
              f"(device synced), {1e6 * round_event[s]:.2f} us CUDA events; "
              f"add {1e6 * add_event[s]:.2f} us", flush=True)
    print(f"calibrate: Python round alpha {python['alpha']:.4e} s, beta "
          f"{python['beta']:.4e} s/B ({1e-9 / python['beta']:.2f} GB/s); NCCL events "
          f"alpha {nccl['alpha']:.4e} s, beta {nccl['beta']:.4e} s/B "
          f"({1e-9 / nccl['beta']:.2f} GB/s); gamma {python['gamma']:.4e} s/B "
          f"({1e-9 / python['gamma']:.2f} GB/s reduced), add launch "
          f"{python['add_intercept']:.3e} s", flush=True)
    for key in sorted({k for c in cal for k in c["allreduce"]}):
        w, n, alg = key.split("/")
        w, n = int(w[1:]), int(n[1:])
        n_bytes = 4 * n
        host_s = over_ranks("allreduce", key, "host_s")
        event_s = over_ranks("allreduce", key, "event_s")
        row = {"w": w, "n": n, "algorithm": alg, "host_s": host_s, "event_s": event_s,
               "bus_gb_s": 2 * (w - 1) / w * n_bytes / host_s / 1e9}
        if alg != "psum":
            p = predict(hw, w, n_bytes, alg)
            row.update(predicted_s=p["counters"], eq_s=p["eq"],
                       rel_err=(p["counters"] - host_s) / host_s,
                       eq_rel_err=(p["eq"] - host_s) / host_s)
        out["allreduce"][key] = row
        print(f"  all-reduce w={w} n={n} {alg:16s} measured {1e3 * host_s:.4f} ms host "
              f"({1e3 * event_s:.4f} ms events), bus {row['bus_gb_s']:.2f} GB/s"
              + (f"; predicted {1e3 * row['predicted_s']:.4f} ms (counters, rel err "
                 f"{row['rel_err']:+.3f}), eq. {2 if alg == 'ring' else 3} "
                 f"{1e3 * row['eq_s']:.4f} ms (rel err {row['eq_rel_err']:+.3f})"
                 if alg != "psum" else " (NCCL's own)"), flush=True)
    for name, fit in (("python_round", python), ("nccl_events", nccl)):
        for k in ("alpha", "beta", "gamma"):
            check(math.isfinite(fit[k]) and fit[k] > 0, f"calibrate {name}: {k} = {fit[k]}")
    print("calibrate: " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------ (c) ResNet dp --
def resnet_dp_phase(smi: list[str]) -> dict:
    t0 = time.perf_counter()
    out = {"card": smi, "runs": {}}
    gated = []
    for spec, control_steps in ((cs.DP, cs.DP.steps), (cs.DP_W3, None)):
        spec = dataclasses.replace(spec, backend=BACKEND, device=DEVICE)
        key = f"w{spec.world}"
        summary, ranks = cs.dp_run(spec, control_steps)
        out["runs"][key] = summary
        cs.dp_report(f"resnet_dp {key}", summary, "; ".join(smi))
        gated.append((spec, summary, ranks))
    w4 = out["runs"]["w4"]["algorithms"]
    print(f"resnet_dp: exchange at w = 4 over {BACKEND}, medians in the steps: "
          + ", ".join(f"{a} {v['exchange_ms_median']:.3f} ms" for a, v in w4.items())
          + f"; one card over gloo-host (PERF.md section 5): "
          f"{GLOO_HOST['resnet_exchange_ms_w4']} ms", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print("resnet_dp phase: " + json.dumps(out), flush=True)
    for spec, summary, ranks in gated:
        cs.dp_gates(f"resnet_dp w={spec.world}", spec, summary, ranks,
                    cs.launches(fused_sgd_update=1), cs.DP_UPDATE_LIMIT)
        cards_gate(f"resnet_dp w={spec.world}", summary, spec.world)
    return out


def cards_gate(where: str, summary: dict, world: int) -> None:
    if BACKEND == "nccl":
        check(summary["cards"] == list(range(world)),
              f"{where}: ranks on cards {summary['cards']}, one card a rank expected")


# ------------------------------------------------ (d) qwen2.5-3b dp --
def long_update_check(n: int) -> dict:
    """fused_sgd_update at n elements on card 0 against its plain version
    applied a chunk at a time to the same inputs (the plain version of
    the whole buffer would not fit beside it), and
    ``explicit_allreduce.update_rel_err`` at that length: 0 for the true
    update, and with every element from CUT on zeroed in the expected
    update (CUT > 2**31), the share those elements hold of it."""
    t0 = time.perf_counter()
    dev, chunk = torch.device(DEVICE), dp._CHUNK
    cut = 45 * chunk
    gen = torch.Generator(device=dev).manual_seed(11)
    p, g, mu = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    p0, mu0 = p.cpu(), mu.cpu()
    sgd_kernel.fused_sgd_update(p, g, mu, 0.1)
    dp._sync(dev)
    tol = cs.TOL["fused_sgd_update"][torch.float32]
    err, ok = 0.0, True
    for a in range(0, n, chunk):
        want_p, want_mu = ref.fused_sgd_update_ref(p0[a:a + chunk].to(dev), g[a:a + chunk],
                                                   mu0[a:a + chunk].to(dev), 0.1)
        got_p, got_mu = p[a:a + chunk], mu[a:a + chunk]
        err = max(err, float((got_p - want_p).abs().max()),
                  float((got_mu - want_mu).abs().max()))
        ok &= bool(torch.allclose(got_p, want_p, rtol=tol, atol=tol)
                   and torch.allclose(got_mu, want_mu, rtol=tol, atol=tol))
    del g, mu, mu0, want_p, want_mu
    want, head, tail = torch.empty(n), 0.0, 0.0
    for a in range(0, n, chunk):
        u = (p[a:a + chunk].double() - p0[a:a + chunk].to(dev, torch.float64)).float()
        want[a:a + chunk] = u.cpu()
        sq = float(u.double().square().sum())
        head, tail = (head + sq, tail) if a < cut else (head, tail + sq)
    exact = dp.update_rel_err(p, p0, want)
    want[cut:] = 0
    zeroed = dp.update_rel_err(p, p0, want)
    expected = math.sqrt(tail / head)
    del p, p0, want
    torch.cuda.empty_cache()
    out = {"n": n, "max_abs_err": err, "update_rel_err_exact": exact,
           "update_rel_err_tail_zeroed": zeroed, "tail_share_expected": expected,
           "cut": cut, "seconds": time.perf_counter() - t0}
    print(f"lm_dp: fused_sgd_update at n = {n} vs its plain version a chunk at a "
          f"time: max abs err {err}; update_rel_err at that length {exact} (true "
          f"update), {zeroed} with elements from {cut} zeroed (expected {expected})",
          flush=True)
    check(ok, f"fused_sgd_update at n = {n}: max abs err {err}")
    check(exact < 1e-6, f"update_rel_err at n = {n}: {exact}")
    check(abs(zeroed - expected) <= 1e-4 * expected,
          f"update_rel_err at n = {n} past 2**31: {zeroed}, expected {expected}")
    return out


def lm_dp_phase(smi: list[str]) -> dict:
    t0 = time.perf_counter()
    # all three exchanges (the one-card smoke runs ring alone)
    spec = dataclasses.replace(cs.LM_DP, cfg=get_config(cs.ARCH), backend=BACKEND,
                               device=DEVICE, timeout_s=LM_DP_TIMEOUT_S,
                               algorithms=cs.DP.algorithms)
    n = spec.cfg.param_count()
    room = host_room(Path(tempfile.gettempdir()))
    print(f"lm_dp: {n} parameters at {spec.cfg.n_layers} layers; host "
          f"{json.dumps(room)}", flush=True)
    check(n == LM_PARAMS, f"lm_dp: {n} parameters")
    long_check = long_update_check(n) if DEVICE == "cuda" else None
    summary, ranks = cs.dp_run(spec, control_steps=1)
    summary["seconds"]["total"] = time.perf_counter() - t0
    out = {"card": smi, "layers": spec.cfg.n_layers, "long_update_check": long_check,
           "tokens_per_rank_step": spec.m_per_worker * spec.seq, **summary,
           "launches": cs.dp_launches(ranks)}
    cs.dp_report("lm_dp", summary, "; ".join(smi))
    print(f"lm_dp: the {4 * n} B gradient's exchange over {BACKEND} at w = 4: " + ", ".join(
        f"{a} {v['exchange_ms_median']:.2f} ms" for a, v in summary["algorithms"].items())
          + f"; 2 layers (776,485,888 values) over gloo-host on one card (PERF.md "
          f"section 5): {GLOO_HOST['lm_2layer_exchange_s_w4']} s", flush=True)
    print("lm_dp phase: " + json.dumps(out), flush=True)
    cfg = spec.cfg
    cs.dp_gates("lm_dp", spec, summary, ranks,
                cs.launches(rmsnorm=2 * cfg.n_layers + 1, swa_attention=cfg.n_layers,
                            fused_sgd_update=1), cs.LM_DP_UPDATE_LIMIT)
    cards_gate("lm_dp", summary, spec.world)
    return out


# --------------------------------------------------- (e) sharded step --
def sharded_phase(smi: list[str]) -> dict:
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_sharded_rank as sr

    t0 = time.perf_counter()
    ranks = dp.spawn(sr.sharded_rank, CARDS, (CARDS, sr.CASES, BACKEND), SHARDED_TIMEOUT_S)
    out = {"card": smi, "mesh": "2x2", "cases": {}, "seconds": time.perf_counter() - t0}
    for case in sr.CASES:
        rows = []
        for r in ranks:
            res = r[case]
            kind = case[0]
            if "error" in res:
                rows.append({"error": res["error"].strip().splitlines()[-1]})
                print(f"sharded {case} rank {len(rows) - 1}:\n{res['error']}", flush=True)
                continue
            if kind == "prefill":
                got, want = res["sharded"], res["one"]
                row = {"rel_err": cs.rel_err(got.double(), want.double()),
                       "finite": bool(torch.isfinite(got).all()),
                       "shape_ok": got.shape == want.shape, "placements": res["placements"]}
            elif kind == "grad":
                (loss, grads), (sloss, sgrads) = res["one"], res["sharded"]
                row = {"loss_rel_err": abs(float(sloss) - float(loss)) / abs(float(loss)),
                       "rel_err": cs.rel_err(sgrads.double(), grads.double()),
                       "shape_ok": sgrads.shape == grads.shape,
                       "nonzero": float(sgrads.abs().max()) > 0}
            else:
                (loss, update), (sloss, supdate) = res["one"], res["sharded"]
                row = {"loss_rel_err": abs(float(sloss) - float(loss)) / abs(float(loss)),
                       "update_max_abs_diff": float((supdate - update).abs().max()),
                       "update_max": float(update.abs().max()), "sgd_calls": res["sgd_calls"]}
            row["launches"] = res["launches"]
            rows.append(row)
        out["cases"]["/".join(map(str, case))] = rows
    print("sharded phase: " + json.dumps(out), flush=True)
    for case, rows in out["cases"].items():
        for rank, row in enumerate(rows):
            at = f"sharded {case} rank {rank}"
            check("error" not in row, f"{at}: {row.get('error')}")
            if "placements" in row:
                check(row["finite"] and row["shape_ok"] and row["rel_err"] < sr.TOL
                      and row["placements"] == ["S(0)", "S(2)"], f"{at}: {row}")
            elif "nonzero" in row:
                check(row["loss_rel_err"] <= sr.TOL and row["shape_ok"]
                      and row["rel_err"] < sr.TOL and row["nonzero"], f"{at}: {row}")
            else:
                check(row["sgd_calls"] == 1 and row["loss_rel_err"] <= sr.TOL
                      and row["update_max_abs_diff"] <= 1e-6 and row["update_max"] > 1e-3,
                      f"{at}: {row}")
            n = row["launches"]
            check(n["sharded"] == n["one"], f"{at}: launches on the local shards "
                                            f"{n['sharded']}, one process {n['one']}")
            if BACKEND == "nccl":
                check(n["sharded"]["rmsnorm"] + n["sharded"]["swa_attention"] > 0,
                      f"{at}: no kernel launched: {n}")
                if case.startswith("sgd"):
                    check(n["sharded"]["fused_sgd_update"] == 1, f"{at}: {n}")
    return out


# ------------------------------------------- (g) dbrx-132b over 4 cards --
def dbrx_rank(rank, world, init_method, out_dir):
    """Rank ``rank`` of the (1, 4) mesh, on card ``rank``: dbrx_readings,
    saved."""
    dev = rank_device(rank)
    mesh_module.init_data_group(rank, world, init_method, BACKEND, dev, TIMEOUT_S)
    try:
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        torch.save(dbrx_readings(dev), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def peak_bytes(dev) -> int | None:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def dbrx_readings(dev: torch.device) -> dict:
    """One rank's readings: the local draw, the [2, 1024] prefill through
    the kernels and the plain versions in bf16 and in each run of
    DBRX_GATED (with the routing flips), decode against prefill at
    capacity factor 8 in the gated runs with both faulty-cache controls,
    the serve, and a profile of a decode step and a prefill."""
    cfg = get_config(DBRX_ARCH)
    sh = Sharder(mesh_module.device_mesh(DBRX_MESH))
    model = build_model(cfg)
    model8 = build_model(dataclasses.replace(cfg, capacity_factor=cs.MOE_DECODE_CF))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = cs.sync_time() if dev.type == "cuda" else time.perf_counter()
    params = pspec.init_local(DBRX_SEED, model.param_specs(), sh.mesh, sh.rules, dev)
    leaves = pspec.flatten(params).values()
    out = {"card": dev.index,
           "init_seconds": (cs.sync_time() if dev.type == "cuda" else time.perf_counter()) - t0,
           "n_params": sum(t.numel() for t in leaves),
           "local_bytes": sum(t.to_local().numel() * t.element_size() for t in leaves),
           "memory_allocated_after_init": (torch.cuda.memory_allocated(dev)
                                           if dev.type == "cuda" else None)}
    b, s = cs.PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=dev)
    prefill = make_prefill(model, sh, device=cs.DEVICE)
    runs = {}
    for name in dict.fromkeys(("bf16", *DBRX_GATED)):
        f32 = name == "f32"
        with cs.f32_activations() if f32 else contextlib.nullcontext():
            r = cs.prefill_vs_plain(model, params, {"tokens": tokens}, sh=sh)
            logits = r.pop("logits")
            del r["plain"]
            r["finite"] = bool(torch.isfinite(logits).all())
            r["shape"] = list(logits.shape)
            del logits
            routes = {"kernels": [], "plain": []}
            with cs.recording_routes(routes["kernels"]):
                prefill(params, {"tokens": tokens})
            with cs.plain_versions(), cs.recording_routes(routes["plain"]):
                prefill(params, {"tokens": tokens})
            k, p = routes["kernels"], routes["plain"]
            r["routing_flips_vs_plain"] = {
                "layer_0": cs.route_flips(k[0], p[0], cfg.n_experts),
                "last_layer": cs.route_flips(k[-1], p[-1], cfg.n_experts),
                "all_layers": cs.route_flips(torch.stack(k), torch.stack(p), cfg.n_experts)}
            del routes, k, p
            if name in DBRX_GATED:
                # capacity factor 8 drops nothing, so the prefill of the
                # first DBRX_POSITIONS tokens gives those positions' logits
                head = tokens[:, :DBRX_POSITIONS]
                logits8 = cs.whole(make_prefill(model8, sh, device=cs.DEVICE)(
                    params, {"tokens": head}))
                ops.reset_launch_counts()
                t1 = time.perf_counter()
                sound = cs.decode_vs_prefill(
                    make_decode_step(model8, sh, device=cs.DEVICE), model8, params, head,
                    logits8, DBRX_POSITIONS, controls=cs.CONTROL_FAULTS, sh=sh,
                    cache_dtype=torch.float32 if f32 else torch.bfloat16)
                r["decode_vs_prefill_faulty_controls"] = sound.pop("controls")
                r["decode_vs_prefill"] = {"capacity_factor": cs.MOE_DECODE_CF, **sound,
                                          "steps": DBRX_POSITIONS,
                                          "seconds": time.perf_counter() - t1,
                                          "launches": ops.launch_counts()}
                del logits8
        runs[name] = r
    out["prefill"] = runs
    out["prefill_peak_memory_bytes"] = peak_bytes(dev)

    serve(cfg, batch=DBRX_SERVE["batch"], prompt_len=4, new_tokens=2, params=params,
          device=cs.DEVICE, log=False, sh=sh)  # warm-up at a tiny length
    ops.reset_launch_counts()
    generated, seconds, last = serve(cfg, params=params, device=cs.DEVICE, log=False,
                                     return_logits=True, sh=sh, **DBRX_SERVE)
    steps = DBRX_SERVE["prompt_len"] + DBRX_SERVE["new_tokens"] - 1
    out["serve"] = {**DBRX_SERVE, "decode_steps": steps, "seconds": seconds,
                    "tokens_per_s": DBRX_SERVE["batch"] * DBRX_SERVE["new_tokens"] / seconds,
                    "decode_step_wall_ms": 1e3 * seconds / steps,
                    "launches": ops.launch_counts(), "tokens": generated.tolist(),
                    "last_shape": list(last.shape),
                    "last_finite": bool(torch.isfinite(last).all())}

    # a decode step at the serve's cache length and batch, and a prefill
    # (the dry-run's shapes), with NCCL's kernels as a group of their own
    decode = make_decode_step(model, sh, device=cs.DEVICE)
    length = DBRX_SERVE["prompt_len"] + DBRX_SERVE["new_tokens"]
    cache = pspec.distributed(model.cache_specs(InputShape(
        "p", length, DBRX_SERVE["batch"], "decode")), sh.mesh, sh.rules, dev)
    step = {"tokens": torch.zeros((DBRX_SERVE["batch"], 1), dtype=torch.int32, device=dev),
            "pos": torch.full((DBRX_SERVE["batch"],), length // 2, dtype=torch.int32,
                              device=dev)}
    groups = {"nccl": ("nccl",)}
    out["profile"] = {
        "decode_step": cs.device_profile(lambda: decode(params, cache, step), 4, groups),
        "prefill": cs.device_profile(lambda: prefill(params, {"tokens": tokens}), 2, groups)}
    out["peak_memory_bytes"] = peak_bytes(dev)
    return out


def dbrx_bounds() -> dict:
    """The dry-run of the profiled prefill and decode step on the (1, 4)
    AbstractMesh with the Sharder's rules: per device, its flops, bytes and
    collective bytes by kind, and the roofline bound."""
    cfg = get_config(DBRX_ARCH)
    b, s = cs.PREFILL_SHAPE
    length = DBRX_SERVE["prompt_len"] + DBRX_SERVE["new_tokens"]
    out = {}
    for shape in (InputShape("dbrx_prefill", s, b, "prefill"),
                  InputShape("dbrx_decode", length, DBRX_SERVE["batch"], "decode")):
        t0 = time.perf_counter()
        rec = dryrun.dryrun_on(cfg, shape, DBRX_MESH, skip_costs=True, rules=default_rules())
        roof = rec["roofline"]
        out[shape.kind] = {
            "shape": [shape.global_batch, shape.seq_len], "flops": roof["flops_per_device"],
            "bytes": roof["bytes_per_device"],
            "collective_bytes": roof["collective_bytes_per_device"],
            "collectives": roof["collectives"], "compute_ms": 1e3 * roof["compute_s"],
            "memory_ms": 1e3 * roof["memory_s"], "collective_ms": 1e3 * roof["collective_s"],
            "dominant": roof["dominant"], "bound_ms": 1e3 * roof["bound_s"],
            "kernel_calls": rec["kernel_calls"], "memory": rec["memory"],
            "dryrun_seconds": time.perf_counter() - t0}
    return out


def dbrx_tp_phase(smi: list[str]) -> dict:
    t0 = time.perf_counter()
    cfg = get_config(DBRX_ARCH)
    n = cfg.param_count()
    local = pspec.flatten(pspec.local_specs(build_model(cfg).param_specs(), DBRX_MESH,
                                            default_rules()))
    reckoned = sum(math.prod(v.shape) * v.dtype.itemsize for v in local.values())
    print(f"dbrx_tp: {cfg.name}, {n} parameters, on a "
          f"{'x'.join(map(str, DBRX_MESH.sizes))} {DBRX_MESH.names} mesh: "
          f"{reckoned / 1e9:.2f} GB of local shards a rank reckoned", flush=True)
    check(n == DBRX_PARAMS, f"dbrx_tp: {n} parameters")
    check(abs(reckoned / DBRX_LOCAL_BYTES - 1) < 0.01, f"dbrx_tp: {reckoned} B reckoned")
    bounds = dbrx_bounds()
    t1 = time.perf_counter()
    ranks = dp.spawn(dbrx_rank, CARDS, (CARDS,), DBRX_TIMEOUT_S)
    out = {"card": smi, "mesh": "x".join(map(str, DBRX_MESH.sizes)), "n_params": n,
           "local_bytes_reckoned": reckoned, "gated": list(DBRX_GATED),
           "positions": DBRX_POSITIONS, "bounds": bounds, "ranks": ranks,
           "seconds": {"dryrun": t1 - t0, "ranks": time.perf_counter() - t1}}
    # NCCL's kernels run on a stream of their own and spin until the
    # slowest rank arrives: their time is mostly waiting on the host, so
    # the step's busy time (and its idle share) is that of its other kernels
    for r in ranks:
        for kind, key in (("prefill", "prefill"), ("decode", "decode_step")):
            prof = r["profile"][key]
            total, groups = prof["device_busy_ms_per_call"], prof.get("groups_ms_per_call", {})
            busy = None if total is None else total - groups.get("nccl", 0.0)
            r.setdefault("roofline", {})[kind] = {
                "bound_ms": bounds[kind]["bound_ms"], "device_busy_ms": busy,
                "nccl_ms": groups.get("nccl"), "wall_ms": prof["wall_ms_per_call"],
                "idle_share": None if busy is None else 1 - busy / prof["wall_ms_per_call"],
                "bound_share_of_busy": bounds[kind]["bound_ms"] / busy if busy else None}
    for r in ranks:
        r["serve"]["tokens_equal_rank0"] = r["serve"]["tokens"] == ranks[0]["serve"]["tokens"]
    print("dbrx_tp phase: " + json.dumps(out), flush=True)
    dbrx_report(out, "; ".join(smi))
    dbrx_gates(out, cfg)
    return out


def dbrx_report(out: dict, smi: str) -> None:
    for kind, bd in out["bounds"].items():
        print(f"dbrx_tp: dry-run {kind} {bd['shape']}: bound {bd['bound_ms']:.3f} ms "
              f"({bd['dominant']}; compute {bd['compute_ms']:.3f}, memory "
              f"{bd['memory_ms']:.3f}, collective {bd['collective_ms']:.3f} ms), collective "
              f"bytes {json.dumps(bd['collectives'])}, kernels {bd['kernel_calls']} "
              f"(H100 SXM5 datasheet constants)", flush=True)
    for i, r in enumerate(out["ranks"]):
        sv = r["serve"]
        print(f"dbrx_tp rank {i} (card {r['card']}): {r['local_bytes'] / 1e9:.2f} GB local, "
              f"{r['memory_allocated_after_init']} B allocated after init, peak "
              f"{r['peak_memory_bytes']} B; serve {sv['tokens_per_s']:.2f} tok/s, decode step "
              f"{sv['decode_step_wall_ms']:.1f} ms wall; roofline "
              + json.dumps(r["roofline"]) + f" [{smi}]", flush=True)
        for name, run in r["prefill"].items():
            d = run.get("decode_vs_prefill")
            print(f"dbrx_tp rank {i} {name}: prefill {run['seconds']:.2f} s, kernels vs plain "
                  f"rel err {run['rel_err_vs_plain']}, argmax {run['argmax_agree_vs_plain']}, "
                  f"routing flips {json.dumps(run['routing_flips_vs_plain']['all_layers'])}"
                  + (f"; decode vs prefill over {d['positions']}: rel err {d['rel_err_all']}, "
                     f"argmax {d['argmax_agree']}, controls " + json.dumps(
                         {f: [c["rel_err_all"], c["argmax_agree"]] for f, c in
                          run["decode_vs_prefill_faulty_controls"].items()}) if d else ""),
                  flush=True)


def dbrx_gates(out: dict, cfg) -> None:
    per_pass = cs.launches(rmsnorm=2 * cfg.n_layers + 1, swa_attention=cfg.n_layers)
    per_step = cs.launches(rmsnorm=2 * cfg.n_layers + 1)
    cards = [r["card"] for r in out["ranks"]]
    check(cards == list(range(CARDS)) or BACKEND != "nccl", f"dbrx_tp: ranks on cards {cards}")
    for i, r in enumerate(out["ranks"]):
        at = f"dbrx_tp rank {i}"
        check(r["n_params"] == DBRX_PARAMS, f"{at}: {r['n_params']} parameters")
        check(r["local_bytes"] == out["local_bytes_reckoned"]
              and abs(r["local_bytes"] / DBRX_LOCAL_BYTES - 1) < 0.01,
              f"{at}: {r['local_bytes']} B of local shards")
        if r["peak_memory_bytes"] is not None:
            total = torch.cuda.get_device_properties(r["card"]).total_memory
            check(r["peak_memory_bytes"] < total, f"{at}: peak {r['peak_memory_bytes']} B")
        cs.check_prefill_runs(at, r["prefill"], DBRX_GATED, per_pass["rmsnorm"], 0,
                              cfg.n_layers, cfg.vocab_size)
        for name in DBRX_GATED:
            d = r["prefill"][name]["decode_vs_prefill"]
            check(d["launches"] == {k: v * d["steps"] for k, v in per_step.items()},
                  f"{at} {name}: decode launches {d['launches']} over {d['steps']} steps")
        sv = r["serve"]
        check(sv["launches"] == {k: v * sv["decode_steps"] for k, v in per_step.items()},
              f"{at}: serve launches {sv['launches']}, {per_step} a step")
        check(sv["tokens_equal_rank0"], f"{at}: generated tokens differ from rank 0's")
        toks = np.asarray(sv["tokens"])
        check(toks.shape == (sv["batch"], sv["new_tokens"])
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{at}: serve tokens {toks.shape}")
        check(sv["last_finite"] and sv["last_shape"] == [sv["batch"], 1, cfg.vocab_size],
              f"{at}: serve's last logits {sv['last_shape']}")
        for kind, roof in r["roofline"].items():
            check(roof["device_busy_ms"] is not None
                  and roof["bound_ms"] <= roof["device_busy_ms"],
                  f"{at}: the {kind} bound {roof['bound_ms']} ms exceeds the device busy "
                  f"time {roof['device_busy_ms']} ms")
    check(out["bounds"]["prefill"]["kernel_calls"] == {
        k: v for k, v in per_pass.items() if v}, f"dbrx_tp: the prefill dry-run counted "
          f"{out['bounds']['prefill']['kernel_calls']}")
    check(out["bounds"]["decode"]["kernel_calls"] == {"rmsnorm": per_step["rmsnorm"]},
          f"dbrx_tp: the decode dry-run counted {out['bounds']['decode']['kernel_calls']}")


# ------------------------------------------------ (f) stop + restart --
def restart_layers(cfg, room: dict) -> int:
    """The deepest cut of ``cfg`` whose AdamW checkpoint (f32 parameters
    and both moments, 12 bytes a parameter) fits twice on the disk with a
    tenth to spare, and four restores plus the save's copy in the host's
    available memory with a fifth to spare."""
    for layers in range(cfg.n_layers, 0, -1):
        ckpt = 12 * dataclasses.replace(cfg, n_layers=layers).param_count()
        if 2 * ckpt <= 0.9 * room["disk_free"] and 5 * ckpt <= 0.8 * room["mem_available"]:
            return layers
    raise RuntimeError(f"restart: no depth fits {room}")


def run_logged(argv: list[str], env: dict, log: Path, timeout_s: float):
    """Run ``argv`` in a session of its own, its output read line by line
    and stamped with the host clock as it arrives (also written to
    ``log``); the session is killed after ``timeout_s``. Returns the exit
    code, the start and exit times and the stamped lines."""
    lines = []
    t_start = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=ROOT, start_new_session=True)
    timer = threading.Timer(timeout_s, os.killpg, (proc.pid, signal.SIGKILL))
    timer.start()
    try:
        with open(log, "w") as f:
            for line in proc.stdout:
                lines.append((time.perf_counter(), line.rstrip("\n")))
                f.write(line)
                f.flush()
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return rc, t_start, time.perf_counter(), lines


def first(lines, pattern: str):
    for t, line in lines:
        m = re.search(pattern, line)
        if m:
            return t, m
    raise RuntimeError(f"restart: no line matches {pattern!r}")


STEP_LINE = r"step +(\d+) loss (\S+) lr (\S+)"


def restart_phase(smi: list[str]) -> dict:
    cfg = get_config(cs.ARCH)
    ckpt_root = Path(tempfile.mkdtemp(prefix="restart_"))
    try:
        room = host_room(ckpt_root)
        layers = restart_layers(cfg, room) if DEVICE == "cuda" else cfg.n_layers
        r = RESTART
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONUNBUFFERED="1")
        runs = []
        for workers, steps in zip(r["workers"], r["steps"]):
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(workers), "-m", "repro_torch.launch.train",
                    "--arch", cs.ARCH, "--workers", str(workers), "--steps", str(steps),
                    "--m-per-worker", str(r["m_per_worker"]), "--seq", str(r["seq"]),
                    "--lr", str(r["lr"]), "--grad-exchange", "ring", "--backend", BACKEND,
                    "--device", DEVICE, "--ckpt-dir", str(ckpt_root), "--log-every", "1",
                    *TRAIN_FLAGS]
            if layers != cfg.n_layers:
                argv += ["--layers", str(layers)]
            if runs:
                argv.append("--resume")
            OUT.mkdir(parents=True, exist_ok=True)
            rc, t_start, t_exit, lines = run_logged(argv, env, OUT / f"restart_w{workers}.log",
                                                    RESTART_TIMEOUT_S)
            print("\n".join(f"restart w={workers}| {line}" for _, line in lines[-12:]),
                  flush=True)
            check(rc == 0, f"restart: the {workers}-rank run exited {rc}")
            runs.append((t_start, t_exit, lines))
        (_, exit1, lines1), (start2, _, lines2) = runs
        t_saved, m_saved = first(lines1, r"checkpointed step (\d+) in (\S+)s \(params "
                                          r"checksum (\w+)\)")
        t_ready, m_ready = first(lines2, r"process group ready: (\w+), (\d+) ranks")
        t_restored, m_restored = first(lines2, r"restored step (\d+) in (\S+)s .*params "
                                                r"checksum (\w+)\)")
        t_step, _ = first(lines2, STEP_LINE)
        save_s, restore_s = float(m_saved.group(2)), float(m_restored.group(2))
        parts = {"save_s": save_s, "old_ranks_exit_s": exit1 - t_saved,
                 "relaunch_to_nccl_ready_s": t_ready - start2,
                 "state_init_s": t_restored - t_ready - restore_s,
                 "restore_s": restore_s, "first_step_s": t_step - t_restored,
                 "total_s": t_step - (t_saved - save_s),
                 "paper_s": cs.PAPER_RESTART_SECONDS}
        step0 = int(m_restored.group(1))
        steps2 = r["steps"][1]
        sched = warmup_cosine(rescale_lr(r["lr"], r["workers"][1], 1),
                              warmup=min(20, steps2 // 5 + 1), total=steps2)
        resumed = [(int(m.group(1)), float(m.group(2)), m.group(3)) for _, line in lines2
                   for m in [re.search(STEP_LINE, line)] if m]
        out = {"card": smi, "layers": layers, "full_depth": layers == cfg.n_layers,
               "room": room, "parts": parts, "saved_step": int(m_saved.group(1)),
               "restored_step": step0, "saved_checksum": m_saved.group(3),
               "restored_checksum": m_restored.group(3), "backend": m_ready.group(1),
               "ranks_ready": int(m_ready.group(2)), "resumed": resumed,
               "lr_expected": [f"{sched(i):.2e}" for i, _, _ in resumed]}
        print(f"restart: qwen2.5-3b at {layers} of {cfg.n_layers} layers, 2 -> 4 ranks "
              f"over {BACKEND}: save {save_s:.2f} s + old ranks' exit "
              f"{parts['old_ranks_exit_s']:.2f} s + relaunch until NCCL is ready "
              f"{parts['relaunch_to_nccl_ready_s']:.2f} s + state init "
              f"{parts['state_init_s']:.2f} s + restore {restore_s:.2f} s + first step "
              f"{parts['first_step_s']:.2f} s = {parts['total_s']:.2f} s (host clock; "
              f"the paper's stop + restart ~{cs.PAPER_RESTART_SECONDS:.0f} s) "
              f"[{'; '.join(smi)}]", flush=True)
        print("restart phase: " + json.dumps(out), flush=True)
        check(out["backend"] == BACKEND and out["ranks_ready"] == r["workers"][1],
              f"restart: group {m_ready.group(0)}")
        check(out["restored_step"] == out["saved_step"] == r["steps"][0]
              and out["restored_checksum"] == out["saved_checksum"],
              f"restart: saved step {out['saved_step']} {out['saved_checksum']}, restored "
              f"{out['restored_step']} {out['restored_checksum']}")
        check([i for i, _, _ in resumed] == list(range(step0, step0 + steps2)),
              f"restart: resumed steps {resumed}")
        check([lr for _, _, lr in resumed] == out["lr_expected"],
              f"restart: LR {resumed} against eq. 7 at 4 workers {out['lr_expected']}")
        check(all(math.isfinite(loss) for _, loss, _ in resumed), f"restart: losses {resumed}")
        return out
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


# ----------------------------------------------------------------- main --
def main(argv=None) -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="run only this phase (repeatable); all by default")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory for NCCL's logs and the restart runs' output")
    args = ap.parse_args(argv)
    OUT = args.out.resolve()
    phases = args.phase or list(PHASES)
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"chip_nccl: needs {CARDS} CUDA devices, one a rank; "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        print(f"card {i}: {line}", flush=True)
    print(subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True).stdout, flush=True)
    print(f"host: {json.dumps(host_room(Path(tempfile.gettempdir())))}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}", flush=True)
    (OUT / "nccl").mkdir(parents=True, exist_ok=True)
    os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=str(OUT / "nccl" / "%h.%p.log"))
    print(f"build: {build.build_all():.1f} s", flush=True)

    results, failed = {}, []
    collectives = tuple(p for p in ("exchange", "calibrate") if p in phases)
    if collectives:
        run_phase("+".join(collectives), lambda: collectives_phase(collectives, smi),
                  results, failed)
    for name, fn in (("sharded", sharded_phase), ("dbrx_tp", dbrx_tp_phase),
                     ("resnet_dp", resnet_dp_phase), ("lm_dp", lm_dp_phase),
                     ("restart", restart_phase)):
        if name in phases:
            torch.cuda.empty_cache()
            run_phase(name, lambda: fn(smi), results, failed)
    transports = nccl_transports()
    print(f"NCCL transports (NCCL_DEBUG=INFO, every rank): {json.dumps(transports)}",
          flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s; phases {phases}; "
          f"failed {failed}", flush=True)
    if failed:
        return 1
    print(json.dumps({"cards": smi, "transports": transports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
