"""The port's dense transformer against repro.models.transformer at smoke
size, from one JAX init bridged through repro_torch.bridge.

* f32 (embed_tokens patched to f32 in both packages, f32 caches): forward,
  prefill and a step-by-step KV-cache decode match the reference to a
  relative max error (max |port - ref| / max |ref|) below 1e-5.
* bf16: the reference's own serving contract of
  tests/test_decode_consistency.py: relative max error below 0.08 and
  argmax agreement above 0.95.

h2o-danube decodes 48 steps so that its smoke sliding window (32) masks.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.store import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import InputShape
from repro.models import spec as jspec
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.engine.steps import make_decode_step, make_prefill
from repro_torch.models import spec as tspec
from repro_torch.models.registry import build_model
from _torch_parity import patch_f32_embeddings

ARCHS = {"qwen2.5-3b": 24, "gemma-2b": 24, "h2o-danube-1.8b": 48}
F32_TOL = 1e-5


def _run_both(cfg, jcfg, seq, f32: bool, seed: int = 0):
    """Forward and step-by-step decode logits of both packages, as numpy."""
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    dtype = torch.float32 if f32 else torch.bfloat16
    tm = build_model(cfg, dtype)
    tparams = params_from_numpy(_flatten(jparams), cfg, "cpu", dtype)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)

    want_fwd, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got_fwd, aux = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert aux == 0.0
    got_prefill = make_prefill(tm, device="cpu")(tparams, {"tokens": tokens})
    torch.testing.assert_close(got_prefill, got_fwd, rtol=0, atol=0)

    shape = InputShape("d", seq, 2, "decode")
    jcache = jspec.init_params(jax.random.PRNGKey(1), jm.cache_specs(shape))
    if f32:
        jcache = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jcache)
    tcache = tspec.init_params(None, tm.cache_specs(shape, dtype), "cpu")
    jdecode = jax.jit(jm.decode_step)
    tdecode = make_decode_step(tm, device="cpu")
    want_dec, got_dec = [], []
    for t in range(seq):
        pos = np.full((2,), t, np.int32)
        lj, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                               "pos": jnp.asarray(pos)})
        lt, tcache = tdecode(tparams, tcache, {"tokens": tokens[:, t:t + 1],
                                               "pos": pos})
        want_dec.append(np.asarray(lj[:, 0]))
        got_dec.append(lt[:, 0].numpy())
    return {"forward": (got_fwd.numpy(), np.asarray(want_fwd)),
            "decode": (np.stack(got_dec, 1), np.stack(want_dec, 1))}


@pytest.fixture(scope="module")
def outputs():
    """Runs each (arch, dtype) once per module; the tests read the result."""
    cache = {}

    def get(arch, f32):
        key = (arch, f32)
        if key not in cache:
            cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            with pytest.MonkeyPatch.context() as mp:
                if f32:
                    patch_f32_embeddings(mp)
                cache[key] = _run_both(cfg, jcfg, ARCHS[arch], f32)
        return cache[key]
    return get


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("path", ["forward", "decode"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_matches_reference_f32(outputs, arch, path):
    got, want = outputs(arch, True)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < F32_TOL, (arch, path, _rel_err(got, want))


@pytest.mark.parametrize("path", ["forward", "decode"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_matches_reference_bf16(outputs, arch, path):
    got, want = outputs(arch, False)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 0.08, (arch, path, _rel_err(got, want))
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree > 0.95, (arch, path, agree)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_own_forward_bf16(outputs, arch):
    """The port's cache path agrees with its own teacher-forced forward,
    under the same contract as the reference's decode-consistency test."""
    got_fwd = outputs(arch, False)["forward"][0]
    got_dec = outputs(arch, False)["decode"][0]
    assert _rel_err(got_dec, got_fwd) < 0.08
    assert float(np.mean(got_dec.argmax(-1) == got_fwd.argmax(-1))) > 0.95


def test_padded_heads_match_reference(monkeypatch):
    """pad_heads_to: extra Q heads (with nonzero weights) are masked to zero
    and keep the real heads' KV mapping, as in the reference."""
    patch_f32_embeddings(monkeypatch)
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), n_heads=3,
                              n_kv_heads=2, pad_heads_to=4)
    jcfg = dataclasses.replace(jax_smoke_config("qwen2.5-3b"), n_heads=3,
                               n_kv_heads=2, pad_heads_to=4)
    got, want = _run_both(cfg, jcfg, 12, f32=True, seed=3)["forward"]
    assert _rel_err(got, want) < F32_TOL


def test_bridge_rejects_mismatched_trees():
    cfg = get_smoke_config("qwen2.5-3b")
    flat = _flatten(jax_build_model(jax_smoke_config("qwen2.5-3b")).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="unembed"):
        params_from_numpy({k: v for k, v in flat.items() if k != "unembed"},
                          cfg, "cpu")
    flat["embed"] = flat["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(flat, cfg, "cpu")


def test_bridge_keeps_use_dtypes():
    cfg = get_smoke_config("qwen2.5-3b")
    flat = _flatten(jax_build_model(jax_smoke_config("qwen2.5-3b")).init(
        jax.random.PRNGKey(0)))
    p = params_from_numpy(flat, cfg, "cpu")
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["bq"].dtype == torch.bfloat16
    assert p["layers"]["mlp"]["wo"].dtype == torch.bfloat16
    assert p["layers"]["ln1"]["scale"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    assert p["embed"].dtype == p["unembed"].dtype == torch.float32
    np.testing.assert_array_equal(p["embed"].numpy(), flat["embed"])


def test_param_specs_match_reference():
    """The port declares the reference's tree: same paths, same shapes, and
    the same analytic parameter count at full width."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for arch in ARCHS:
        tflat = tspec.flatten(build_model(get_config(arch)).param_specs())
        jpaths = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      jax_build_model(jax_get_config(arch)).param_specs(),
                      is_leaf=jspec.is_spec)[0]}
        assert {k: s.shape for k, s in tflat.items()} == jpaths
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_are_copies_of_the_reference(arch, smoke):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    got = (get_smoke_config if smoke else get_config)(arch)
    want = (jax_smoke_config if smoke else jax_get_config)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_registry_lists_only_ported_archs():
    from repro_torch.configs import ARCH_IDS, get_config
    assert set(ARCH_IDS) == set(ARCHS)
    with pytest.raises(KeyError):
        get_config("mamba2-780m")
    with pytest.raises(KeyError):
        get_smoke_config("whisper-base")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b",
                                  "mamba2-780m", "whisper-base"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(jax_smoke_config(arch))
