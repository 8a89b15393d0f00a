"""The port's dense transformer against repro.models.transformer at smoke
size, from one JAX init bridged through repro_torch.bridge.

* f32 (embed_tokens patched to f32 in both packages, f32 caches): forward,
  prefill and a step-by-step KV-cache decode match the reference to a
  relative max error (max |port - ref| / max |ref|) below 1e-5.
* bf16: the reference's own serving contract of
  tests/test_decode_consistency.py: relative max error below 0.08 and
  argmax agreement above 0.95.

h2o-danube decodes 48 steps so that its smoke sliding window (32) masks.
The VLM's forward takes patch embeddings over its first 16 rows (the smoke
config's n_frontend_tokens). The MoE archs run at capacity_factor 8.0, as
tests/test_decode_consistency.py runs them (capacity drops tokens in the
forward but never at one-token decode); their forward at the config's own
capacity factor, where tokens drop, is held to the reference separately.
The VLM's decode is held to the reference's decode only: its decode
positions (every token text at pos - P + g) are not the forward's grid
positions, so the reference leaves it out of its decode-consistency test.
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

ARCHS = {"qwen2.5-3b": 24, "gemma-2b": 24, "h2o-danube-1.8b": 48,
         "qwen2-vl-2b": 24, "qwen3-moe-30b-a3b": 24, "dbrx-132b": 24,
         "qwen2.5-14b": 24}
MOE_ARCHS = [a for a in ARCHS if jax_smoke_config(a).is_moe]
# every arch the port builds: the transformers above, the ssm and hybrid
# families and the audio family (held to the reference in
# test_torch_mamba2.py, test_torch_hybrid.py and test_torch_whisper.py)
PORTED = [*ARCHS, "mamba2-780m", "jamba-v0.1-52b", "whisper-base"]
F32_TOL = 1e-5


def _inputs(cfg, seq, seed):
    """Tokens [2, seq], and for the VLM patch embeddings [2, P, D] at the
    embedding's scale."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = (rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)) * cfg.d_model ** -0.5
        ).astype(np.float32)
    return out


def _run_both(cfg, jcfg, seq, f32: bool, seed: int = 0, decode: bool = True):
    """Forward and step-by-step decode logits of both packages, as numpy."""
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    dtype = torch.float32 if f32 else torch.bfloat16
    tm = build_model(cfg, dtype)
    tparams = params_from_numpy(_flatten(jparams), cfg, "cpu", dtype)
    inputs = _inputs(cfg, seq, seed)
    tokens = inputs["tokens"]

    want_fwd, want_aux = jm.forward(jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    got_fwd, aux = tm.forward(tparams, {k: torch.from_numpy(v) for k, v in inputs.items()})
    if cfg.is_moe:
        aux_tol = F32_TOL if f32 else 2e-2
        assert abs(float(aux) - float(want_aux)) <= aux_tol * abs(float(want_aux))
    else:
        assert aux == 0.0
    got_prefill = make_prefill(tm, device="cpu")(tparams, inputs)
    torch.testing.assert_close(got_prefill, got_fwd, rtol=0, atol=0)
    out = {"forward": (got_fwd.numpy(), np.asarray(want_fwd))}
    if not decode:
        return out

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
    out["decode"] = (np.stack(got_dec, 1), np.stack(want_dec, 1))
    return out


@pytest.fixture(scope="module")
def outputs():
    """Runs each (arch, dtype) once per module; the tests read the result."""
    cache = {}

    def get(arch, f32):
        key = (arch, f32)
        if key not in cache:
            cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            if cfg.is_moe:
                cfg = dataclasses.replace(cfg, capacity_factor=8.0)
                jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
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


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "qwen2-vl-2b"])
def test_decode_matches_own_forward_bf16(outputs, arch):
    """The port's cache path agrees with its own teacher-forced forward,
    under the same contract as the reference's decode-consistency test."""
    got_fwd = outputs(arch, False)["forward"][0]
    got_dec = outputs(arch, False)["decode"][0]
    assert _rel_err(got_dec, got_fwd) < 0.08
    assert float(np.mean(got_dec.argmax(-1) == got_fwd.argmax(-1))) > 0.95


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_at_config_capacity_matches_reference_f32(arch, monkeypatch):
    """At the config's capacity_factor 1.25 a 48-token group has C = 32
    slots an expert for 24 assignments on average, so some drop; the port
    drops the same ones."""
    patch_f32_embeddings(monkeypatch)
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    assert cfg.capacity_factor == 1.25
    got, want = _run_both(cfg, jcfg, 48, f32=True, seed=2, decode=False)["forward"]
    assert _rel_err(got, want) < F32_TOL, _rel_err(got, want)
    ample = _run_both(dataclasses.replace(cfg, capacity_factor=8.0),
                      dataclasses.replace(jcfg, capacity_factor=8.0), 48,
                      f32=True, seed=2, decode=False)["forward"][0]
    assert _rel_err(got, ample) > 1e-4  # tokens were dropped


def test_vlm_forward_uses_patch_embeds_and_mrope(monkeypatch):
    """Patch embeddings replace the first P rows (other embeddings change
    the logits), and M-RoPE's grid positions are in effect (the same
    weights without M-RoPE give other logits, in the reference as in the
    port)."""
    patch_f32_embeddings(monkeypatch)
    cfg, jcfg = get_smoke_config("qwen2-vl-2b"), jax_smoke_config("qwen2-vl-2b")
    base = _run_both(cfg, jcfg, 24, f32=True, decode=False)["forward"]
    other = _run_both(cfg, jcfg, 24, f32=True, seed=1, decode=False)["forward"]
    plain = _run_both(dataclasses.replace(cfg, mrope=False),
                      dataclasses.replace(jcfg, mrope=False), 24, f32=True,
                      decode=False)["forward"]
    assert _rel_err(plain[0], plain[1]) < F32_TOL
    assert _rel_err(plain[0], base[0]) > 1e-3
    assert _rel_err(other[0], base[0]) > 1e-3
    tm = build_model(cfg, torch.float32)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 24, 0).items()}
    with_patches = tm.forward(params, inputs)[0]
    without = tm.forward(params, {"tokens": inputs["tokens"]})[0]
    P = cfg.n_frontend_tokens
    assert _rel_err(with_patches.numpy(), without.numpy()) > 1e-3
    # the text rows after the patches attend to them
    assert not torch.equal(with_patches[:, P:], without[:, P:])


def test_vlm_positions_are_the_reference_grid():
    """Prefill: the first P tokens at (0, i // g, i % g), text after at
    i - P + g on all three axes; decode: pos - P + g on all three."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for cfg, jcfg in ((get_smoke_config("qwen2-vl-2b"), jax_smoke_config("qwen2-vl-2b")),
                      (get_config("qwen2-vl-2b"), jax_get_config("qwen2-vl-2b"))):
        tm, jm = build_model(cfg), jax_build_model(jcfg)
        for seq in (8, cfg.n_frontend_tokens, cfg.n_frontend_tokens + 40):
            got = tm._positions(2, seq, "cpu")
            assert got.shape == (2, seq, 3) and got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(jm._positions(2, seq)))
        pos = np.array([0, 5, cfg.n_frontend_tokens + 3], np.int32)
        got = tm._decode_positions(torch.from_numpy(pos).long())
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jm._decode_positions(jnp.asarray(pos))))
    P = get_config("qwen2-vl-2b").n_frontend_tokens
    grid = build_model(get_config("qwen2-vl-2b"))._positions(1, P + 2, "cpu")[0]
    assert grid[17].tolist() == [0, 1, 1] and grid[P].tolist() == [16, 16, 16]


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


def _whole_leaf_draws(gen, specs: dict) -> dict:
    """What ``init_params`` drew before large leaves were drawn in
    slices: one f32 draw of each whole leaf, scaled, then cast."""
    out = {}
    for path, s in tspec.flatten(specs).items():
        if s.init in ("zeros", "ones"):
            out[path] = tspec._init_one(gen, s, "cpu")
            continue
        dims = list(s.shape)
        fan = dims[1:-1] if s.axes[0] == "layers" else dims[:-1]
        std = (s.scale / np.sqrt(dims[-1] if s.init == "embed" else
                                 max(1, int(np.prod(fan)) if fan else dims[-1])))
        x = torch.randn(s.shape, generator=gen, dtype=torch.float32)
        out[path] = (x * std).to(s.dtype)
    return out


def test_init_below_the_slice_threshold_draws_as_before():
    """Every qwen2.5-3b smoke leaf is below the threshold: the draws are
    bit for bit those of one whole-leaf draw per leaf."""
    specs = build_model(get_smoke_config("qwen2.5-3b")).param_specs()
    assert max(int(np.prod(s.shape)) for s in tspec.flatten(specs).values()) \
        <= tspec._MAX_DRAW
    got = tspec.flatten(tspec.init_params(torch.Generator().manual_seed(5),
                                          specs, "cpu"))
    want = _whole_leaf_draws(torch.Generator().manual_seed(5), specs)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype
        assert torch.equal(got[path], want[path]), path


def test_init_draws_a_large_leaf_one_layer_at_a_time(monkeypatch):
    """With the threshold below the MoE smoke config's expert leaves, each
    is drawn one layer at a time: the right shape and dtype, the fan-in
    std, the generator's stream in layer order, and the leaves below the
    threshold still drawn whole."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    specs = build_model(cfg).param_specs()
    wi = tspec.flatten(specs)["layers/moe/wi_gate"]
    monkeypatch.setattr(tspec, "_MAX_DRAW", int(np.prod(wi.shape)) - 1)
    p = tspec.flatten(tspec.init_params(torch.Generator().manual_seed(1),
                                        specs, "cpu"))
    w = p["layers/moe/wi_gate"]
    assert tuple(w.shape) == wi.shape and w.dtype == torch.bfloat16
    std = 1 / np.sqrt(cfg.n_experts * cfg.d_model)  # fan-in past "layers"
    assert abs(float(w.float().std()) / std - 1) < 0.02
    for i in range(cfg.n_layers):
        assert abs(float(w[i].float().std()) / std - 1) < 0.03
    assert not torch.equal(w[0], w[1])
    # slices follow the generator's stream: the same values as drawing
    # the layers one after another at that point of the stream
    gen = torch.Generator().manual_seed(1)
    order = list(tspec.flatten(specs))
    for path in order[:order.index("layers/moe/wi_gate")]:
        tspec._init_one(gen, tspec.flatten(specs)[path], "cpu")
    for i in range(cfg.n_layers):
        x = torch.randn(wi.shape[1:], generator=gen, dtype=torch.float32) * std
        assert torch.equal(w[i], x.to(torch.bfloat16)), i
    assert tuple(p["layers/moe/router"].shape) == (cfg.n_layers, cfg.d_model,
                                                   cfg.n_experts)


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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_bridge_is_the_identity_on_moe_and_vlm_paths(arch):
    """The new paths (layers/moe/router, layers/moe/wi_gate, ...) map to
    themselves; router and expert weights are stored in the model's
    param_dtype, bf16 to serve, with the values the reference drew."""
    cfg = get_smoke_config(arch)
    flat = _flatten(jax_build_model(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    p = params_from_numpy(flat, cfg, "cpu")
    got = tspec.flatten(p)
    assert got.keys() == flat.keys()
    if cfg.is_moe:
        assert {k for k in got if k.startswith("layers/moe/")} == {
            "layers/moe/router", "layers/moe/wi_gate", "layers/moe/wi_up",
            "layers/moe/wo"}
        assert "layers/mlp/wo" not in got
        for name in ("router", "wi_gate", "wi_up", "wo"):
            t = p["layers"]["moe"][name]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(), torch.from_numpy(np.array(
                    flat[f"layers/moe/{name}"])).to(torch.bfloat16).float().numpy())
    f32 = params_from_numpy(flat, cfg, "cpu", torch.float32)
    for path, v in tspec.flatten(f32).items():
        np.testing.assert_array_equal(v.numpy(), flat[path])


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
    for arch in PORTED:
        tflat = tspec.flatten(build_model(get_config(arch)).param_specs())
        jpaths = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      jax_build_model(jax_get_config(arch)).param_specs(),
                      is_leaf=jspec.is_spec)[0]}
        assert {k: s.shape for k, s in tflat.items()} == jpaths
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_configs_are_copies_of_the_reference(arch, smoke):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    got = (get_smoke_config if smoke else get_config)(arch)
    want = (jax_smoke_config if smoke else jax_get_config)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_registry_lists_only_ported_archs():
    """Every config of the reference is ported; an unknown one raises."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, get_config
    assert set(ARCH_IDS) == set(PORTED) == set(JAX_ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("whisper-large")
    with pytest.raises(KeyError):
        get_smoke_config("whisper-large")


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_unported_families_raise(arch):
    """The audio family builds and serves, but does not train yet: the
    gradient of its cross-attention (Sq != Sk) raises, naming the ROADMAP
    item."""
    from repro_torch.engine.steps import value_and_flat_grad
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4))),
             "frames": torch.zeros(1, cfg.n_frontend_tokens, cfg.d_model)}
    assert torch.isfinite(model.loss(params, batch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        value_and_flat_grad(model, params, batch)
