"""dbrx-132b's serving path on a (1, 4) ("data", "model") mesh against the
reference, as ``chip_nccl.py``'s dbrx_tp phase runs it on four cards: 4
gloo ranks (spawned, a fresh ``file://`` rendezvous, a join timeout) at the
smoke config widened to the full config's layout (8 query heads, 4 KV
heads, 8 experts top-2: 2 query heads, 1 KV head and 2 experts a rank),
f32 activations in both packages, the reference's weights bridged in
(the ranks are ``_torch_moe_tp_rank.tp_rank``):

(a) the sharded prefill at the config's capacity factor equals the
    reference's prefill, relative max error below 1e-5
    (tests/test_torch_transformer.py's f32 tolerance);
(b) 8 sharded decode steps through ``write_slot`` on a DTensor cache (KV
    heads split over "model") equal the reference's ``decode_step`` at the
    same tolerance, and the same steps on a cache zeroed before each step
    (the ``no_cache`` control) do not;
(c) ``models.spec.init_local``: every shard has the shape ``local_specs``
    gives, ranks holding the same shard (same global offset: on a 2 x 2
    mesh, "data" replicates) drew the same values and ranks holding
    different shards different ones, and each random leaf's standard
    deviation is its global spec's (a fan-in read from the local shape
    would be 2x off for the attention output and expert weights);
(d) ``init_local`` on ``meta`` for the full dbrx-132b on a (1, 4) mesh
    of a fake group holds 66.42 GB a rank and makes no tensor larger than
    a local leaf."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.store import _flatten
from repro.configs.shapes import InputShape as JInputShape
from repro.models import spec as jspec
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch.explicit_allreduce import spawn
from repro_torch.launch.mesh import device_mesh, join_fake_group
from repro_torch.models import spec as pspec
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import default_rules
from _torch_moe_tp_rank import (B, DECODE_STEPS, MESH_2X2, MESH_TP, S, WORLD,
                                config, tokens_of, tp_rank)
from _torch_parity import patch_f32_embeddings

TIMEOUT_S = 180
F32_TOL = 1e-5
DBRX_LOCAL_BYTES = 66.42e9  # a rank's shards of dbrx-132b on a (1, 4) mesh


def _jax_config(cfg):
    from repro.configs import get_smoke_config as jax_smoke_config

    jcfg = jax_smoke_config("dbrx-132b")
    return dataclasses.replace(jcfg, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                               n_experts=cfg.n_experts,
                               capacity_factor=cfg.capacity_factor)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's prefill and decode logits, and the ranks' readings."""
    cfg = config()
    jcfg = _jax_config(cfg)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tokens = tokens_of(cfg)
    with pytest.MonkeyPatch.context() as mp:
        patch_f32_embeddings(mp)
        want_prefill = np.asarray(jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}))
        jm8 = jax_build_model(_jax_config(config(8.0)))
        shape = JInputShape("d", S, B, "decode")
        jcache = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jspec.init_params(
            jax.random.PRNGKey(1), jm8.cache_specs(shape)))
        jdecode = jax.jit(jm8.decode_step)
        want_decode = []
        for t in range(DECODE_STEPS):
            lj, jcache = jdecode(jparams, jcache, {
                "tokens": jnp.asarray(tokens[:, t:t + 1]),
                "pos": jnp.full((B,), t, jnp.int32)})
            want_decode.append(np.asarray(lj[:, 0]))
    path = tmp_path_factory.mktemp("moe_tp") / "weights.pt"
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in _flatten(jparams).items()}, path)
    ranks = spawn(tp_rank, WORLD, (WORLD, str(path)), TIMEOUT_S)
    return {"prefill": want_prefill, "decode": np.stack(want_decode, 1), "ranks": ranks}


def _case(r: dict, key: str) -> dict:
    assert "error" not in r[key], r[key]["error"]
    return r[key]


def test_sharded_prefill_equals_reference(run):
    for r in run["ranks"]:
        got = _case(r, "prefill")
        assert got["logits"].shape == run["prefill"].shape
        assert _rel_err(got["logits"], run["prefill"]) < F32_TOL
        # batch over the size-1 "data" axis, the vocab over "model"
        assert got["placements"] == ["S(0)", "S(2)"]


def test_sharded_decode_equals_reference_and_no_cache_fails(run):
    for r in run["ranks"]:
        got = _case(r, "decode")
        assert _rel_err(got["logits"], run["decode"]) < F32_TOL
        assert _rel_err(got["no_cache"], run["decode"]) > 100 * F32_TOL
        # the KV cache: batch over "data", KV heads over "model"
        assert got["cache_placements"]["k"] == ["S(1)", "S(3)"]


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_local_init_shapes_shards_and_std(run, mesh):
    shape = {"1x4": MESH_TP, "2x2": MESH_2X2}[mesh]
    specs = pspec.flatten(build_model(config()).param_specs())
    local = pspec.flatten(pspec.local_specs(build_model(config()).param_specs(), shape,
                                            default_rules()))
    draws = [_case(r, "init")[mesh] for r in run["ranks"]]
    distinct = 0
    for path, s in specs.items():
        by_offset = {}
        for d in draws:
            leaf = d[path]
            assert tuple(leaf["local"].shape) == local[path].shape, path
            assert leaf["global_shape"] == s.shape, path
            by_offset.setdefault(leaf["offset"], []).append(leaf["local"])
        for same in by_offset.values():
            assert all(torch.equal(same[0], t) for t in same[1:]), path
        if s.init in ("zeros", "ones"):
            continue
        firsts = [ts[0] for ts in by_offset.values()]
        assert all(not torch.equal(a, b) for i, a in enumerate(firsts)
                   for b in firsts[i + 1:]), path
        distinct += len(firsts) > 1
        want = pspec._std(s)
        for t in firsts:
            assert abs(float(t.float().std()) / want - 1) < 0.1, (path, mesh)
    # the attention and expert weights are split, so shards differ
    assert distinct >= 5


def test_local_init_std_is_the_global_fan_in():
    """The trap the global std avoids: the local spec of wo or an expert
    weight gives a std 2x the global one on the (1, 4) mesh."""
    specs = pspec.flatten(build_model(config()).param_specs())
    local = pspec.flatten(pspec.local_specs(build_model(config()).param_specs(), MESH_TP,
                                            default_rules()))
    for path in ("layers/attn/wo", "layers/moe/wi_gate", "layers/moe/wo"):
        assert pspec._std(local[path]) == pytest.approx(2 * pspec._std(specs[path]))


class _Largest(TorchDispatchMode):
    """The largest tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_full_dbrx_local_init_on_meta_is_a_quarter():
    cfg = get_config("dbrx-132b")
    specs = build_model(cfg).param_specs()
    local = pspec.flatten(pspec.local_specs(specs, MESH_TP, default_rules()))
    join_fake_group(WORLD)
    try:
        mesh = device_mesh(MESH_TP, "cpu")
        with _Largest() as made:
            tree = pspec.init_local(0, specs, mesh, default_rules(), "meta")
    finally:
        torch.distributed.destroy_process_group()
    leaves = pspec.flatten(tree)
    nbytes = sum(t.to_local().numel() * t.element_size() for t in leaves.values())
    assert nbytes == sum(math.prod(s.shape) * s.dtype.itemsize for s in local.values())
    assert abs(nbytes / DBRX_LOCAL_BYTES - 1) < 1e-3, nbytes
    assert sum(t.numel() for t in leaves.values()) == cfg.param_count() == 131_596_523_520
    assert made.numel == max(math.prod(s.shape) for s in local.values())
    assert all(t.to_local().device.type == "meta" for t in leaves.values())
