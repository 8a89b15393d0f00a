"""A spawned rank of tests/test_torch_moe_tp.py: dbrx-132b's serving path
on a (1, 4) ("data", "model") mesh of gloo CPU ranks, as ``chip_nccl.py``'s
dbrx_tp phase runs it on four cards, at the smoke config widened to the
full config's layout (8 query heads, 4 KV heads, 8 experts: each rank holds
2 query heads, 1 KV head and 2 experts), with f32 activations. It loads no
jax: the reference's outputs are made in the test's own process, and the
same weights come here as numpy arrays.

Each rank runs the sharded prefill, ``DECODE_STEPS`` sharded decode steps
on a DTensor cache (and the same steps on a cache zeroed before each
step, the ``no_cache`` control), and draws ``models.spec.init_local`` on
the (1, 4) mesh and on a 2 x 2 mesh; it saves what the test compares."""
import dataclasses
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

import repro_torch.models.layers as TL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.engine import steps
from repro_torch.launch.mesh import AbstractMesh, device_mesh, init_data_group
from repro_torch.models import spec as pspec
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import placements

B, S = 2, 16
DECODE_STEPS = 8
WORLD = 4
MESH_TP = AbstractMesh((1, 4), ("data", "model"))
MESH_2X2 = AbstractMesh((2, 2), ("data", "model"))
INIT_SEED = 5


def config(capacity_factor: float | None = None):
    """The smoke dbrx-132b with the full config's layout on a 4-way model
    axis: GQA groups of 2, 8 experts top-2."""
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"), n_heads=8, n_kv_heads=4,
                              n_experts=8)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def tokens_of(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _embed_f32(embedding, tokens, scale=None):
    x = TL.lookup(embedding, tokens).float()  # on local shards, as the port's
    return x * scale if scale is not None else x


def _decode(model, params, sh, tokens, zeroed: bool) -> tuple[torch.Tensor, dict]:
    """Logits [B, DECODE_STEPS, V] of sharded decode steps over the first
    tokens, and the cache's placements; ``zeroed``: every cache shard
    zeroed before each step."""
    shape = InputShape("d", S, B, "decode")
    cache = pspec.distributed(model.cache_specs(shape, torch.float32), sh.mesh,
                              sh.rules, "cpu")
    decode = steps.make_decode_step(model, sh, device="cpu")
    out = []
    for t in range(DECODE_STEPS):
        if zeroed:
            for leaf in pspec.flatten(cache).values():
                leaf.to_local().zero_()
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1],
                                               "pos": np.full((B,), t, np.int32)})
        out.append(logits.full_tensor()[:, 0])
    return torch.stack(out, 1), {k: [str(p) for p in v.placements]
                                 for k, v in pspec.flatten(cache).items()}


def _local_draws(model, mesh_shape) -> dict:
    """init_local's shards on a mesh of ``mesh_shape``: each leaf's local
    values and the global offset of its shard."""
    sh = TL.Sharder(device_mesh(mesh_shape))
    specs = model.param_specs()
    tree = pspec.init_local(INIT_SEED, specs, sh.mesh, sh.rules, "cpu")
    out = {}
    for path, t in pspec.flatten(tree).items():
        s = pspec.flatten(specs)[path]
        place = placements(sh.rules.spec_for(s.axes, s.shape, sh.axes), sh.axes)
        _, offset = compute_local_shape_and_global_offset(s.shape, sh.mesh, place)
        out[path] = {"local": t.to_local().clone(), "offset": tuple(offset),
                     "global_shape": tuple(t.shape)}
    return out


def tp_rank(rank, world, weights_path, init_method, out_dir):
    """Rank ``rank`` of the (1, 4) mesh: the readings of the test's
    cases, saved (a case that raises leaves its traceback under
    "error")."""
    TL.embed_tokens = _embed_f32
    torch.set_num_threads(1)
    init_data_group(rank, world, init_method, "gloo", "cpu", 120.0)
    out = {}
    try:
        flat = {k: v.numpy() for k, v in torch.load(weights_path).items()}
        sh = TL.Sharder(device_mesh(MESH_TP))
        cfg = config()
        model = build_model(cfg, torch.float32)
        params = steps.shard_tree(params_from_numpy(flat, cfg, "cpu", torch.float32),
                                  model.param_specs(), sh)
        tokens = tokens_of(cfg)
        try:
            logits = steps.make_prefill(model, sh, device="cpu")(params, {"tokens": tokens})
            out["prefill"] = {"logits": logits.full_tensor(),
                              "placements": [str(p) for p in logits.placements]}
        except Exception:
            out["prefill"] = {"error": traceback.format_exc()}
        try:
            model8 = build_model(config(8.0), torch.float32)
            sound, cache_place = _decode(model8, params, sh, tokens, zeroed=False)
            control, _ = _decode(model8, params, sh, tokens, zeroed=True)
            out["decode"] = {"logits": sound, "no_cache": control,
                             "cache_placements": cache_place}
        except Exception:
            out["decode"] = {"error": traceback.format_exc()}
        try:
            serving = build_model(cfg)  # bf16 matmul weights, as served
            out["init"] = {"1x4": _local_draws(serving, MESH_TP),
                           "2x2": _local_draws(serving, MESH_2X2)}
        except Exception:
            out["init"] = {"error": traceback.format_exc()}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
