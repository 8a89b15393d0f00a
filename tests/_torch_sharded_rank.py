"""A spawned rank of tests/test_torch_sharded.py: the port's sharded
prefill, loss, gradient and SGD step on a 2 x 2 ("data", "model") mesh of
gloo CPU ranks, each held to the one-process port in the same rank, with
f32 activations (``_torch_parity``'s f32 patches, copied here so that the
ranks load no jax). ``chip_nccl.py`` runs the same ranks over nccl, rank r
on card r, where the kernels launch; each case also returns the kernels'
launches of the one-process and the sharded run."""
import dataclasses
import traceback
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
# (kind, arch, heads): the smoke configs' prefills, a head count the model
# axis does not divide, the loss and gradient, and one SGD step
CASES = [("prefill", "qwen2.5-3b", None), ("prefill", "qwen3-moe-30b-a3b", None),
         ("prefill", "whisper-base", None), ("prefill", "qwen2.5-3b", 5),
         ("grad", "qwen2.5-3b", None), ("grad", "qwen2.5-3b", 5),
         ("sgd", "qwen2.5-3b", None)]
TOL = 1e-5  # relative max error against the one-process port, f32


def _embed_f32(embedding, tokens, scale=None):
    x = TL.lookup(embedding, tokens).float()  # on local shards, as the port's
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


def _launches(fn):
    """fn()'s result and the kernels' launches during it."""
    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()


def run_case(kind: str, arch: str, heads, sh, device="cpu") -> dict:
    cfg = config(arch, heads)
    model = build_model(cfg, torch.float32)
    specs = model.param_specs()
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    params = pspec.views(params.flat.to(device), params.shapes())
    batch = batch_of(cfg, kind)
    if kind == "prefill":
        one, n_one = _launches(lambda: steps.make_prefill(model, device=device)(
            params, batch))
        dt, n_sharded = _launches(lambda: steps.make_prefill(model, sh, device=device)(
            steps.shard_tree(params, specs, sh), batch))
        return {"one": one, "sharded": dt.full_tensor(),
                "placements": [str(p) for p in dt.placements],
                "launches": {"one": n_one, "sharded": n_sharded}}
    if kind == "grad":
        (loss, grads), n_one = _launches(lambda: steps.value_and_flat_grad(
            model, params, {k: torch.as_tensor(v, device=device)
                            for k, v in batch.items()}))
        local = local_flat(params, specs, sh)
        g = torch.zeros_like(local.flat)
        sl, n_sharded = _launches(lambda: steps.accumulate_sharded_grad(
            model, local, steps._on(batch, device, sh), g, sh))
        return {"one": (loss, grads),
                "sharded": (sl, gathered(pspec.views(g, local.shapes()), specs, sh)),
                "launches": {"one": n_one, "sharded": n_sharded}}
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
        (_, sl), n_sharded = _launches(lambda: steps.make_sharded_train_step(
            model, opt, sh, device=device)(state, batch, 0.1))
        sgd_calls = len(calls)
        one_state = {"params": params, "opt": opt.init(params)}
        p0 = params.flat.clone()
        (_, loss), n_one = _launches(lambda: steps.make_train_step(
            model, opt, device=device)(one_state, batch, 0.1))
    finally:
        ops.fused_sgd_update = inner
    return {"one": (loss, params.flat - p0), "sharded": (
        sl, gathered(local, specs, sh) - p0), "sgd_calls": sgd_calls,
        "launches": {"one": n_one, "sharded": n_sharded}}


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    return x


def sharded_rank(rank, world, cases, backend, init_method, out_dir):
    """Rank ``rank`` of the 2 x 2 mesh: the ``cases`` in turn, saved (a
    case that raises as its traceback under "error"). Under gloo on the
    CPU; under nccl on card ``rank``, TF32 off."""
    TL.embed_tokens = _embed_f32
    TW.torch = _TorchWithF32Bfloat16()
    torch.set_num_threads(1)
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_data_group(rank, world, init_method, backend, device, 120.0)
    try:
        sh = TL.Sharder(device_mesh(AbstractMesh((2, 2), ("data", "model"))))
        out = {}
        for case in cases:  # a case that raises leaves its traceback
            try:
                out[case] = _to_cpu(run_case(*case, sh, device))
            except Exception:
                out[case] = {"error": traceback.format_exc()}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
