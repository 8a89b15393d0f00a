"""Dry-run: every (arch x shape x mesh) step run on ``meta`` DTensors over a
``fake`` process group, proving that its shardings fit together, with its
per-device memory and roofline terms (torch twin of
``repro.launch.dryrun``).

Each combo joins a ``fake`` group of the mesh's size in this process (256
or 512 ranks; 8 with ``--tiny``), builds the train step, prefill or decode
step on DTensors whose local shards are ``meta`` tensors of the shapes the
sharding rules give, and runs it to its end under DTensor propagation:
the counterpart of the reference's compile proof. The outputs are
redistributed to the reference's out-shardings. A dispatch mode
(``analysis.StepCounter``) counts what one device does: flops, bytes, the
functional collectives' output bytes by kind and the peak of live
intermediates; the hand-written kernels count as one op each, with their
own flops and bytes (``kernels.ops.counting_kernel_costs``).

PyTorch runs every layer eagerly, so the run counts the full depth
directly; no scan hides layers from the count. ``raw_costs_scan_body_once``
and ``raw_costs_two_units`` hold the 1- and 2-unit records (the cost pass
runs those depths, and ``corrected_costs`` of the two equals the
full-depth count); under ``--skip-costs`` the first is null.

Memory, per device: ``argument_bytes`` and ``output_bytes`` are the local
bytes of the step's inputs (the LR scalar included) and outputs; as the
reference's memory analysis does, ``output_bytes`` also counts the 8-byte
buffer pointer of each leaf when the step returns several arrays.
``alias_bytes`` is the donated state (train) or cache (decode);
``temp_bytes`` the peak of live intermediates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh single --tiny     # one combo, 8 ranks
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --skip-costs --out experiments/dryrun_torch

The reference's ``--save-hlo`` has no counterpart: there is no compiled
module to save.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.engine.steps import (make_decode_step, make_prefill,
                                      make_sharded_train_step,
                                      train_state_specs)
from repro_torch.kernels import ops
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (device_mesh, join_fake_group,
                                     production_mesh_shape, tiny_mesh_shape)
from repro_torch.models import spec as pspec
from repro_torch.models.layers import Sharder
from repro_torch.models.registry import build_model, decode_window
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding.rules import default_rules

PROFILES: dict[str, dict] = {
    "baseline": {},
    # FSDP/ZeRO-3: additionally shard every weight's embed dim over "data"
    "fsdp": {"embed": ("data",)},
    # padheads: mask-padded Q-heads up to the next multiple of the model
    # axis so attention shards by head instead of by head_dim;
    # math-identical. Combines the rule table of baseline.
    "padheads": {},
    "padheads_fsdp": {"embed": ("data",)},
    # dponly: the paper's own regime — pure data parallelism, params
    # replicated, gradient exchange is THE collective (Horovod semantics).
    "dponly": {"heads": (), "kv_heads": (), "mlp": (), "vocab": (),
               "experts": (), "ssm_heads": ()},
}

NOTE = ("PyTorch runs every layer eagerly: roofline counts the full depth; "
        "raw_costs_scan_body_once and raw_costs_two_units are the 1- and "
        "2-unit records (absent under --skip-costs)")


def apply_profile_cfg(cfg, profile: str):
    if profile.startswith("padheads") and cfg.n_heads % 16 != 0:
        return dataclasses.replace(cfg, pad_heads_to=-(-cfg.n_heads // 16) * 16)
    return cfg


def rules_for(kind: str, profile: str = "baseline"):
    table = dict(PROFILES[profile])
    if kind == "decode":
        # context-parallel cache: shard the cache sequence dim over whatever
        # axes the batch dim leaves free (long_500k: all of them)
        table["cache_seq"] = ("pod", "data", "model")
    return default_rules(table)


def with_depth(cfg, units: int):
    """Same-family config with ``units`` layer units."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=units, encoder_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def depth_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _leaves(tree) -> list[torch.Tensor]:
    return list(analysis._tensors(tree))


def _storage(t) -> int:
    return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()._cdata


def _local_bytes(ts) -> int:
    return sum(analysis._nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in ts)


@dataclasses.dataclass
class Step:
    """A built step: ``run()`` returns its outputs, redistributed to the
    reference's out-shardings; ``inputs`` and ``donated`` are the leaves of
    its arguments and of the state or cache it updates in place;
    ``extra_argument_bytes`` the LR scalar's."""

    run: object
    inputs: list
    donated: list
    extra_argument_bytes: int = 0


def build_step(cfg, shape, mesh, rules, *, window, microbatches: int = 1,
               device="meta") -> Step:
    """The step of ``shape``'s kind on DTensors over ``mesh`` (a
    DeviceMesh), its arguments built from the spec trees: local shards of
    zeros on ``device`` (``meta``: no storage)."""
    sh = Sharder(mesh, rules)
    logits_axes = ("batch", "seq", "vocab")
    if shape.kind == "train":
        opt = adamw()
        model = build_model(cfg, torch.float32)
        specs = train_state_specs(model, opt)
        local = pspec.flatten(pspec.local_specs(specs["params"], mesh, rules))
        n = sum(torch.Size(s.shape).numel() for s in local.values())
        params = pspec.views(torch.zeros(n, device=device),
                             {p: s.shape for p, s in local.items()})
        state = {"params": params, "opt": opt.init(params)}
        batch = pspec.distributed(model.input_specs(shape), mesh, rules, device)
        step = make_sharded_train_step(model, opt, sh, device=device,
                                       microbatches=microbatches)

        def run():
            new_state, loss = step(state, batch, 0.0)
            return [*_leaves(new_state), loss]

        return Step(run, _leaves(state) + _leaves(batch), _leaves(state),
                    extra_argument_bytes=4)
    model = build_model(cfg)
    params = pspec.distributed(pspec.cast(model.param_specs(), torch.bfloat16),
                               mesh, rules, device)
    batch = pspec.distributed(model.input_specs(shape), mesh, rules, device)
    if shape.kind == "prefill":
        fn = make_prefill(model, sh, window=window, device=device)
        return Step(lambda: [sh(fn(params, batch), *logits_axes)],
                    _leaves(params) + _leaves(batch), [])
    cache = pspec.distributed(model.cache_specs(shape), mesh, rules, device)
    fn = make_decode_step(model, sh, window=window, device=device)

    def run():
        logits, new_cache = fn(params, cache, batch)
        return [sh(logits, *logits_axes), *_leaves(new_cache)]

    return Step(run, _leaves(params) + _leaves(cache) + _leaves(batch),
                _leaves(cache))


def count_step(step: Step) -> dict:
    """Run ``step`` once under the counters -> its cost record and memory."""
    with ops.counting_kernel_costs() as kern, analysis.StepCounter() as ctr:
        outputs = step.run()
    # as jit prunes an argument the step never reads (mamba2's decode
    # takes pos and does not read it), so is an input no op read
    arg = _local_bytes(t for t in step.inputs if _storage(t) in ctr.read)
    arg += step.extra_argument_bytes
    out = _local_bytes(outputs) + (8 * len(outputs) if len(outputs) > 1 else 0)
    alias = _local_bytes(step.donated)
    before = {_storage(t) for t in step.inputs}
    fresh = _local_bytes(t for t in outputs if _storage(t) not in before)
    return {"flops": ctr.flops + kern["flops"], "bytes": ctr.bytes + kern["bytes"],
            "coll": dict(ctr.collectives), "kernel_calls": dict(kern["calls"]),
            "memory": {"argument_bytes": arg, "output_bytes": out,
                       "temp_bytes": max(0, ctr.peak - fresh),
                       "alias_bytes": alias}}


def corrected_costs(c1: dict, c2: dict, units_full: int) -> dict:
    """Totals at ``units_full`` units from the 1-unit/2-unit cost records
    (exact for a step whose cost is linear in depth, as an eager one is)."""
    def tot(key):
        per = max(0.0, c2[key] - c1[key])
        return c1[key] + (units_full - 1) * per

    kinds = set(c1["coll"]) | set(c2["coll"])
    coll = {}
    for k in kinds:
        a, b = c1["coll"].get(k, 0.0), c2["coll"].get(k, 0.0)
        coll[k] = a + (units_full - 1) * max(0.0, b - a)
    return {"flops": tot("flops"), "bytes": tot("bytes"), "coll": coll,
            "per_layer_flops": max(0.0, c2["flops"] - c1["flops"]),
            "per_layer_bytes": max(0.0, c2["bytes"] - c1["bytes"])}


def _cost(rec: dict) -> dict:
    return {"flops": rec["flops"], "bytes": rec["bytes"], "coll": rec["coll"]}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               tiny: bool = False, profile: str = "baseline",
               skip_costs: bool = False, rules=None, microbatches: int = 1) -> dict:
    """One registry combo's record, on a production mesh or (``tiny``) the
    8-rank one; ``dryrun_on`` takes any config, shape and mesh."""
    cfg = apply_profile_cfg(get_config(arch), profile)
    shape = SHAPES[shape_name]
    mesh_shape = (tiny_mesh_shape(multi_pod=multi_pod) if tiny
                  else production_mesh_shape(multi_pod=multi_pod))
    rec = dryrun_on(cfg, shape, mesh_shape, profile=profile,
                    skip_costs=skip_costs, rules=rules,
                    microbatches=microbatches)
    rec.update(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16", tiny=tiny)
    return rec


def dryrun_on(cfg, shape, mesh_shape, *, profile: str = "baseline",
              skip_costs: bool = False, rules=None, microbatches: int = 1,
              device="meta") -> dict:
    """The record of ``cfg`` at ``shape`` on a mesh of ``mesh_shape`` (an
    AbstractMesh), over a fake group of its size joined for the run and
    left after it."""
    rules = rules or rules_for(shape.kind, profile)
    window = decode_window(cfg, shape.seq_len)
    join_fake_group(mesh_shape.size)
    try:
        mesh = device_mesh(mesh_shape, "cpu")
        t0 = time.perf_counter()
        step = build_step(cfg, shape, mesh, rules, window=window,
                          microbatches=microbatches, device=device)
        t_build = time.perf_counter() - t0
        full = count_step(step)
        del step
        t_run = time.perf_counter() - t0 - t_build
        units = depth_units(cfg)
        raw, per_layer = None, {}
        if not skip_costs:
            costs = []
            for u in (1, 2):
                s_u = build_step(with_depth(cfg, u), shape, mesh, rules,
                                 window=window, device=device)
                costs.append(_cost(count_step(s_u)))
                del s_u
            raw = costs[0]
            corr = corrected_costs(costs[0], costs[1], units)
            per_layer = {"raw_costs_two_units": costs[1],
                         "per_layer_flops": corr["per_layer_flops"],
                         "per_layer_bytes": corr["per_layer_bytes"]}
    finally:
        dist.destroy_process_group()

    roof = analysis.Roofline(
        flops_per_device=full["flops"], bytes_per_device=full["bytes"],
        collective_bytes_per_device=float(sum(full["coll"].values())),
        collectives=full["coll"], n_devices=mesh_shape.size)
    model = build_model(cfg)
    n_total = pspec.n_params(model.param_specs())
    n_active = cfg.active_param_count() if cfg.is_moe else n_total
    mf = analysis.model_flops(cfg, shape, n_total, n_active)
    flops_total = roof.flops_per_device * mesh_shape.size
    ma = full["memory"]
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape.sizes)), "tiny": False,
        "profile": profile, "n_devices": mesh_shape.size,
        "window": window, "scan_units": units,
        "params_total": int(n_total), "params_active": int(n_active),
        "memory": {**ma, "peak_bytes_per_device": (
            ma["argument_bytes"] + ma["output_bytes"] + ma["temp_bytes"]
            - ma["alias_bytes"])},
        "roofline": {**roof.as_dict(), "bound_s": roof.bound_s},
        "raw_costs_scan_body_once": raw,
        "raw_costs_note": NOTE,
        **per_layer,
        "kernel_calls": full["kernel_calls"],
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_total if flops_total else None,
        "lower_s": t_build, "compile_s": t_run,
    }


def format_line(rec: dict) -> str:
    r = rec["roofline"]
    return (f"mem/dev={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
            f"compute={r['compute_s']*1e3:.2f}ms "
            f"memory={r['memory_s']*1e3:.2f}ms "
            f"coll={r['collective_s']*1e3:.2f}ms "
            f"dom={r['dominant']} "
            f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
            f"run={rec['compile_s']:.0f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--profile", default="baseline", choices=list(PROFILES))
    ap.add_argument("--tiny", action="store_true",
                    help="8-device test mesh")
    ap.add_argument("--skip-costs", action="store_true",
                    help="full-depth run only (no 1- and 2-unit cost runs)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches (train shapes)")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos whose JSON record already exists")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                prof = args.profile + (f"_mb{args.microbatches}"
                                       if args.microbatches > 1 else "")
                tag = (f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                       f"|{prof}")
                fn = tag.replace("|", "__").replace(".", "_") + ".json"
                if args.out and args.skip_existing:
                    if os.path.exists(os.path.join(args.out, fn)):
                        print(f"SKIP {tag} (exists)", flush=True)
                        continue
                try:
                    t0 = time.perf_counter()
                    rec = dryrun_one(arch, shape, multi_pod=mp,
                                     tiny=args.tiny, profile=args.profile,
                                     skip_costs=args.skip_costs,
                                     microbatches=args.microbatches)
                    rec["profile"] = prof
                    rec["total_s"] = time.perf_counter() - t0
                    print(f"OK   {tag} {format_line(rec)} "
                          f"total={rec['total_s']:.0f}s", flush=True)
                    if args.out:
                        with open(os.path.join(args.out, fn), "w") as f:
                            json.dump(rec, f, indent=1)
                except Exception as e:
                    failures += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
