"""A spawned rank of tests/test_torch_sharded.py: the port's sharded
prefill, loss, gradient and SGD step on a 2 x 2 ("data", "model") mesh of
gloo CPU ranks, each held to the one-process port in the same rank, with
f32 activations (``_torch_parity``'s f32 patches, copied here so that the
ranks load no jax)."""
import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

import repro_torch.models.layers as TL
import repro_torch.models.whisper as TW
from repro_torch.configs import get_smoke_config
from repro_torch.engine import steps
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh, device_mesh, init_data_group
from repro_torch.models import spec as pspec
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.sharding.rules import placements

B, S = 4, 16


def _embed_f32(embedding, tokens, scale=None):
    x = embedding[tokens.long()].float()
    return x * scale if scale is not None else x


class _TorchWithF32Bfloat16:
    bfloat16 = torch.float32

    def __getattr__(self, name):
        return getattr(torch, name)


def config(arch: str, heads: int | None):
    cfg = get_smoke_config(arch)
    if heads is not None:  # a head count the model axis does not divide
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=1)
    return cfg


def batch_of(cfg, kind: str) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if kind != "prefill":
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def local_flat(params, specs, sh) -> pspec.FlatTree:
    """This rank's shards of the f32 ``params``, in one flat buffer."""
    flat = pspec.flatten(params)
    return pspec.flat_tree(pspec.unflatten({
        path: DTensor.to_local(distribute_tensor(
            flat[path], sh.mesh, placements(sh.rules.spec_for(
                s.axes, s.shape, sh.axes), sh.axes), src_data_rank=None))
        for path, s in pspec.flatten(specs).items()}))


def gathered(local: pspec.FlatTree, specs, sh) -> torch.Tensor:
    """The whole tree of the shards in ``local``, flat in path order."""
    flat = pspec.flatten(local)
    return torch.cat([DTensor.from_local(
        flat[path], sh.mesh, placements(sh.rules.spec_for(s.axes, s.shape, sh.axes),
                                        sh.axes), run_check=False).full_tensor().reshape(-1)
        for path, s in pspec.flatten(specs).items()])


def run_case(kind: str, arch: str, heads, sh) -> dict:
    cfg = config(arch, heads)
    model = build_model(cfg, torch.float32)
    specs = model.param_specs()
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    batch = batch_of(cfg, kind)
    if kind == "prefill":
        one = steps.make_prefill(model, device="cpu")(params, batch)
        dt = steps.make_prefill(model, sh, device="cpu")(
            steps.shard_tree(params, specs, sh), batch)
        return {"one": one, "sharded": dt.full_tensor(),
                "placements": [str(p) for p in dt.placements]}
    if kind == "grad":
        loss, grads = steps.value_and_flat_grad(
            model, params, {k: torch.as_tensor(v) for k, v in batch.items()})
        local = local_flat(params, specs, sh)
        g = torch.zeros_like(local.flat)
        sl = steps.accumulate_sharded_grad(model, local, steps._on(batch, "cpu", sh), g, sh)
        return {"one": (loss, grads),
                "sharded": (sl, gathered(pspec.views(g, local.shapes()), specs, sh))}
    # one SGD step, from the same weights, at LR 0.1
    local = local_flat(params, specs, sh)
    calls = []
    inner = ops.fused_sgd_update

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    ops.fused_sgd_update = counted
    try:
        opt = sgd()
        state = {"params": local, "opt": opt.init(local)}
        _, sl = steps.make_sharded_train_step(model, opt, sh, device="cpu")(state, batch, 0.1)
        n_sharded = len(calls)
        one_state = {"params": params, "opt": opt.init(params)}
        p0 = params.flat.clone()
        _, loss = steps.make_train_step(model, opt, device="cpu")(one_state, batch, 0.1)
    finally:
        ops.fused_sgd_update = inner
    return {"one": (loss, params.flat - p0), "sharded": (
        sl, gathered(local, specs, sh) - p0), "sgd_calls": n_sharded}


def sharded_rank(rank, world, cases, init_method, out_dir):
    TL.embed_tokens = _embed_f32
    TW.torch = _TorchWithF32Bfloat16()
    torch.set_num_threads(1)
    init_data_group(rank, world, init_method, "gloo", "cpu", 120.0)
    try:
        sh = TL.Sharder(device_mesh(AbstractMesh((2, 2), ("data", "model"))))
        out = {case: run_case(*case, sh) for case in cases}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
