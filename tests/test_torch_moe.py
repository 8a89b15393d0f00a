"""The port's MoE FFN (repro_torch.models.moe) against repro.models.moe,
mirroring tests/test_moe.py, from the same weights (one JAX init, handed
over as numpy) and the same numpy inputs.

* f32: ``moe_ffn`` and its aux loss within the reference's own 1e-4 of the
  reference's ``moe_ffn``, at ample capacity (where both equal the
  dense all-experts computation) and at tight capacity (cf 0.25, where the
  same assignments drop in both).
* bf16: the same inputs rounded to bf16 in both packages, within the
  2e-2 of tests/test_kernels.py.
* ``group_capacity``, the expert accounting and ``active_param_count``
  equal the reference's, qwen3-moe-30b-a3b's 3,353,020,416 active
  parameters included.
* ``moe_ffn`` runs no op whose output shape depends on the data, so a
  step never waits on the host.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro.models.layers import NO_SHARD as JAX_NO_SHARD
from repro.models.registry import build_model as jax_build_model
from repro.models.spec import init_params as jax_init_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe
from repro_torch.models import spec as tspec
from repro_torch.models.layers import NO_SHARD
from repro_torch.models.registry import build_model
from _torch_parity import as_f32, both

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def setup(cf=8.0, E=4, K=2, seed=0):
    """tests/test_moe.py's setup in both packages: one layer's weights of
    the dbrx smoke config, drawn by the reference, as numpy."""
    jcfg = dataclasses.replace(jax_smoke_config("dbrx-132b"),
                               capacity_factor=cf, n_experts=E, top_k=K)
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"),
                              capacity_factor=cf, n_experts=E, top_k=K)
    p = jax_init_params(jax.random.PRNGKey(seed), jax_moe.moe_specs(jcfg, 1))
    return cfg, jcfg, {k: np.array(v[0]) for k, v in p.items()}


def dense_ref(cfg, p1, x):
    """tests/test_moe.py's dense all-experts computation (no capacity)."""
    logits = jnp.einsum("bsd,de->bse", x, p1["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    gate, eid = jax.lax.top_k(probs, cfg.top_k)
    gate = gate / gate.sum(-1, keepdims=True)
    B, S, _ = x.shape
    g_full = jnp.zeros_like(probs).at[
        jnp.arange(B)[:, None, None], jnp.arange(S)[None, :, None], eid
    ].set(gate)
    h = (jax.nn.silu(jnp.einsum("bsd,edf->bsef", x, p1["wi_gate"]))
         * jnp.einsum("bsd,edf->bsef", x, p1["wi_up"]))
    return jnp.einsum("bsef,efd,bse->bsd", h, p1["wo"], g_full)


def _both_ffn(cfg, jcfg, p1, x: np.ndarray, dtype="float32"):
    """(port out, port aux, reference out, reference aux) on the same x."""
    jx, tx = both(x, dtype)
    jp = {k: jnp.asarray(v) for k, v in p1.items()}
    tp = {k: torch.from_numpy(v) for k, v in p1.items()}
    out, aux = moe.moe_ffn(cfg, tp, tx, NO_SHARD)
    want, want_aux = jax_moe.moe_ffn(jcfg, jp, jx, JAX_NO_SHARD)
    assert out.dtype == tx.dtype and aux.dtype == torch.float32
    return as_f32(out), float(aux), as_f32(want), float(want_aux)


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K,B,S", [(4, 2, 3, 16), (8, 1, 2, 8),
                                     (4, 4, 1, 32), (2, 2, 2, 5)])
def test_dispatch_exact_at_ample_capacity(E, K, B, S, dtype):
    cfg, jcfg, p1 = setup(cf=8.0, E=E, K=K)
    x = _x(2, B, S, cfg.d_model)
    out, aux, want, want_aux = _both_ffn(cfg, jcfg, p1, x, dtype)
    np.testing.assert_allclose(out, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    assert aux >= 1.0 - 1e-6  # Switch aux lower bound is 1 (balanced)
    if dtype == "float32":  # no drop: the dense all-experts computation
        dense = np.asarray(dense_ref(cfg, {k: jnp.asarray(v) for k, v in p1.items()},
                                     jnp.asarray(x)))
        np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_tight_capacity_drops_the_reference_tokens(seed):
    """cf 0.25: C = 8 slots for 32 assignments an expert on average, so
    most drop; the port drops the same ones (its output equals the
    reference's, and both differ from the no-drop computation)."""
    cfg, jcfg, p1 = setup(cf=0.25)
    x = _x(seed, 2, 64, cfg.d_model)
    out, aux, want, want_aux = _both_ffn(cfg, jcfg, p1, x)
    assert moe.group_capacity(64, cfg) == 8
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    dense = np.asarray(dense_ref(cfg, {k: jnp.asarray(v) for k, v in p1.items()},
                                 jnp.asarray(x)))
    assert float(np.max(np.abs(out - dense))) > 1e-4


@pytest.mark.parametrize("seed", range(4))
def test_combine_weights_bounded(seed):
    """tests/test_moe.py's property on the port (convex gates: finite
    output) at the reference's seeds, equal to the reference's output."""
    cfg, jcfg, p1 = setup(cf=8.0, seed=seed % 3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 8, cfg.d_model)))
    out, _, want, _ = _both_ffn(cfg, jcfg, p1, x)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_top_k_breaks_ties_as_the_reference():
    """Router logits are bf16 values, so equal probabilities are common:
    the k largest come largest first, ties to the lower index."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4  # many ties
    got_v, got_i = moe._top_k(torch.from_numpy(probs), 5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("tokens", [1, 5, 64, 1024])
def test_group_capacity(tokens, cf):
    cfg, jcfg, _ = setup(cf=cf, E=4, K=2)
    C = moe.group_capacity(tokens, cfg)
    assert C == jax_moe.group_capacity(tokens, jcfg)
    assert C >= max(8, int(tokens * 2 * cf / 4)) and C % 8 == 0
    full = get_config("qwen3-moe-30b-a3b")
    assert moe.group_capacity(tokens, full) == jax_moe.group_capacity(
        tokens, jax_get_config("qwen3-moe-30b-a3b"))


@pytest.mark.parametrize("arch,active", [("qwen3-moe-30b-a3b", 3_353_020_416),
                                         ("dbrx-132b", None)])
def test_expert_param_accounting(arch, active):
    """The expert subtree and the active parameter count at full width
    are the reference's."""
    cfg = get_config(arch)
    sub = build_model(cfg).expert_param_specs()
    want = jax_build_model(jax_get_config(arch)).expert_param_specs()
    assert sub and all("experts" in t.axes for t in sub.values())
    assert {k: v.shape for k, v in sub.items()} == {k: v.shape for k, v in want.items()}
    assert cfg.active_param_count() == jax_get_config(arch).active_param_count()
    assert cfg.param_count() == jax_get_config(arch).param_count()
    if active is not None:
        assert cfg.active_param_count() == active
    assert cfg.active_param_count() < cfg.param_count()


def test_dense_active_param_count_is_the_total():
    cfg = get_config("qwen2.5-3b")
    assert cfg.active_param_count() == cfg.param_count() == \
        jax_get_config("qwen2.5-3b").active_param_count()


def test_specs_store_router_and_experts_in_param_dtype():
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    for dtype in (torch.bfloat16, torch.float32):
        specs = build_model(cfg, dtype).param_specs()["layers"]["moe"]
        assert {s.dtype for s in specs.values()} == {dtype}
        assert specs["router"].shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)


class _Ops(TorchDispatchMode):
    """Names of the ops run under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_moe_ffn_never_reads_the_device():
    """No op of moe_ffn reads a value back to the host or makes a shape
    from the data (what would wait on the device in a CUDA step)."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    p = tspec.init_params(torch.Generator().manual_seed(0),
                          moe.moe_specs(cfg, 1, torch.bfloat16), "cpu")
    x = torch.randn(4, 1, cfg.d_model).to(torch.bfloat16)
    with _Ops() as seen:
        out, aux = moe.moe_ffn(cfg, {k: v[0] for k, v in p.items()}, x, NO_SHARD)
    assert out.shape == x.shape and len(seen.names) > 20
    host = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.unique", "aten._unique2", "aten.item", "aten.bincount"}
    assert not host & set(seen.names), sorted(host & set(seen.names))
