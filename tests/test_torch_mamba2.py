"""The port's Mamba-2 (repro_torch.models.mamba2, the ``ssm`` family)
against repro.models.mamba2 at smoke size, from the same numpy inputs and
one JAX init bridged through repro_torch.bridge.

Tolerances, each set before its first run:

* The chunked SSD against the naive recurrence of tests/test_mamba_ssd.py,
  in f32: that test's 2e-4, at its (S, chunk) cases.
* The mixer and one decode step against the reference: f32 1e-5 and bf16
  2e-2, the tolerances of tests/test_kernels.py. The port's own decode
  stepped against its mixer in f32: the reference's 1e-3.
* The whole model (forward, prefill, decode; f32 activations through both
  packages' ``embed_tokens`` patched to f32): relative max error below
  1e-5. In bf16 and against its own forward, the reference's serving
  contract of tests/test_decode_consistency.py: relative max error below
  0.08 and argmax agreement above 0.95. XLA keeps chains of bf16
  elementwise ops in f32 where torch rounds each op, so port and
  reference differ by about as much as the reference's decode differs from
  its own forward (reached: port vs reference 0.041 and 0.979 at seed 0;
  the reference's decode vs its forward 0.064 and 0.979).
* Loss and flat gradient against ``jax.value_and_grad`` of the reference
  in f32: tests/test_torch_train_lm.py's 1e-5 (loss), 1e-4 (flat, relative
  L2) and 1e-3 (worst leaf).
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
from repro.models import mamba2 as jm2
from repro.models import spec as jspec
from repro.models.layers import NO_SHARD as JAX_NO_SHARD
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.engine.steps import make_decode_step, make_prefill, value_and_flat_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba2 as m2
from repro_torch.models import spec as tspec
from repro_torch.models.layers import NO_SHARD
from repro_torch.models.registry import build_model
from _torch_parity import DTYPES, as_f32, both, patch_f32_embeddings
from test_mamba_ssd import naive_ssm

ARCH = "mamba2-780m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SEQ = 24  # tests/test_decode_consistency.py's S; 16-row chunks, one short


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


# ---------------------------------------------------------------- SSD ----
@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 16), (16, 16), (7, 4)])
def test_chunked_ssd_matches_naive(S, chunk):
    rng = np.random.default_rng(0)
    B, H, P, N = 2, 3, 4, 5
    xin = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.5
    a = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    want = naive_ssm(xin, Bm, Cm, dt, a)
    t = [torch.from_numpy(v) for v in (xin, Bm, Cm, dt, dt * a)]
    got = m2.ssd(*t, chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------ mixer and decode --
def _layer(dtype: str, seed: int = 0):
    """One mixer's weights of the smoke config, drawn by the reference (as
    numpy), and the same weights in the port's dtypes (param_dtype =
    ``dtype``)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    from repro.models.spec import init_params as jax_init_params
    jp = jax_init_params(jax.random.PRNGKey(seed), jm2.mamba_specs(jcfg, 1))
    flat = {k: np.array(v)[0] for k, v in _flatten(jp).items()}
    specs = tspec.flatten(m2.mamba_specs(cfg, 1, DTYPES[dtype][1]))
    tp = tspec.unflatten({k: torch.from_numpy(v).to(specs[k].dtype)
                          for k, v in flat.items()})
    return cfg, jcfg, tspec.unflatten({k: jnp.asarray(v) for k, v in flat.items()}), tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [20, 3])  # a short last chunk; S below the conv width
def test_mixer_matches_reference(S, dtype):
    cfg, jcfg, jp, tp = _layer(dtype)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32) * 0.3
    jx, tx = both(x, dtype)
    want = jm2.mamba_mixer(jcfg, jp, jx, JAX_NO_SHARD)
    got = m2.mamba_mixer(cfg, tp, tx, NO_SHARD)
    assert got.dtype == tx.dtype and got.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def _state(cfg, dtype: str, seed: int = 1) -> dict:
    """A decode state with history: random conv windows and SSM state."""
    rng = np.random.default_rng(seed)
    H, P, N, K = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    shapes = {"conv_x": (2, K - 1, H, P), "conv_B": (2, K - 1, N),
              "conv_C": (2, K - 1, N), "ssm": (2, H, P, N)}
    out = {}
    for k, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.5
        out[k] = both(a, "float32" if k == "ssm" else dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """One step from a state with history: the output, and the new state
    (the port's is written in place into the state it was given)."""
    cfg, jcfg, jp, tp = _layer(dtype)
    st = _state(cfg, dtype)
    x = np.random.default_rng(2).standard_normal((2, 1, cfg.d_model)).astype(np.float32) * 0.3
    jx, tx = both(x, dtype)
    want, want_st = jm2.mamba_decode(jcfg, jp, jx, {k: v[0] for k, v in st.items()},
                                     JAX_NO_SHARD)
    tstate = {k: v[1] for k, v in st.items()}
    got = m2.mamba_decode(cfg, tp, tx, tstate, NO_SHARD)
    assert got.shape == (2, 1, cfg.d_model) and got.dtype == tx.dtype
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    for k in st:
        assert tstate[k].dtype == st[k][1].dtype
        np.testing.assert_allclose(as_f32(tstate[k]), as_f32(want_st[k]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_matches_mixer_f32():
    """The port's recurrence stepped over the sequence against its own
    chunked mixer, through conv and gating (tests/test_mamba_ssd.py's
    check, at its 1e-3)."""
    cfg, _, _, tp = _layer("float32")
    B, S = 2, 20
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32) * 0.3)
    full = m2.mamba_mixer(cfg, tp, x, NO_SHARD)
    specs = m2.mamba_cache_specs(cfg, 1, B, torch.float32)
    state = {k: v[0] for k, v in tspec.init_params(None, specs, "cpu").items()}
    got = torch.cat([m2.mamba_decode(cfg, tp, x[:, t:t + 1], state, NO_SHARD)
                     for t in range(S)], dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-3, atol=1e-3)


# --------------------------------------------------------- whole model ----
def run_both(cfg, jcfg, seq: int, f32: bool, seed: int = 0) -> dict:
    """Forward and step-by-step decode logits of both packages from one
    JAX init, as numpy: {"forward": (port, reference), "decode": ...}."""
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    dtype = torch.float32 if f32 else torch.bfloat16
    tm = build_model(cfg, dtype)
    tparams = params_from_numpy(_flatten(jparams), cfg, "cpu", dtype)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    want, want_aux = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    prefill = make_prefill(tm, device="cpu")(tparams, {"tokens": tokens})
    torch.testing.assert_close(prefill, got, rtol=0, atol=0)

    shape = InputShape("d", seq, 2, "decode")
    jcache = jspec.init_params(jax.random.PRNGKey(1), jm.cache_specs(shape))
    if f32:
        jcache = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jcache)
    tcache = tspec.init_params(None, tm.cache_specs(shape, dtype), "cpu")
    jdecode, tdecode = jax.jit(jm.decode_step), make_decode_step(tm, device="cpu")
    want_dec, got_dec = [], []
    for t in range(seq):
        pos = np.full((2,), t, np.int32)
        lj, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                               "pos": jnp.asarray(pos)})
        lt, tcache = tdecode(tparams, tcache, {"tokens": tokens[:, t:t + 1], "pos": pos})
        want_dec.append(np.asarray(lj[:, 0]))
        got_dec.append(lt[:, 0].float().numpy())
    return {"forward": (got.numpy(), np.asarray(want)),
            "decode": (np.stack(got_dec, 1), np.stack(want_dec, 1)),
            "aux": (float(aux), float(want_aux))}


@pytest.fixture(scope="module")
def outputs():
    cache = {}

    def get(f32: bool):
        if f32 not in cache:
            cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            with pytest.MonkeyPatch.context() as mp:
                if f32:
                    patch_f32_embeddings(mp)
                cache[f32] = run_both(cfg, jcfg, SEQ, f32)
        return cache[f32]
    return get


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_model_matches_reference_f32(outputs, path):
    got, want = outputs(True)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 1e-5, _rel_err(got, want)
    assert outputs(True)["aux"] == (0.0, 0.0)


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_model_matches_reference_bf16(outputs, path):
    got, want = outputs(False)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 0.08, _rel_err(got, want)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree > 0.95, agree


def test_decode_matches_own_forward_bf16(outputs):
    got_fwd, got_dec = outputs(False)["forward"][0], outputs(False)["decode"][0]
    assert _rel_err(got_dec, got_fwd) < 0.08
    assert float(np.mean(got_dec.argmax(-1) == got_fwd.argmax(-1))) > 0.95


def test_norms_take_a_weight_per_head(monkeypatch):
    """A forward and a decode step call the rmsnorm dispatch 2 x layers + 1
    times, the gated norm's n_layers of them with the [H, P] weight over
    y [B, S, H, P]: the calls that go to the kernel on the card."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    shapes = []
    inner = ops.rmsnorm

    def recording(x, w, **kw):
        shapes.append((tuple(x.shape), tuple(w.shape)))
        return inner(x, w, **kw)

    monkeypatch.setattr(ops, "rmsnorm", recording)
    H, P = cfg.n_ssm_heads, cfg.ssm_headdim
    model.forward(params, {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
    cache = tspec.init_params(None, model.cache_specs(InputShape("d", 5, 2, "decode")), "cpu")
    model.decode_step(params, cache, {"tokens": torch.zeros((2, 1), dtype=torch.int32),
                                      "pos": torch.zeros(2, dtype=torch.int32)})
    for S, calls in ((5, shapes[:2 * cfg.n_layers + 1]), (1, shapes[2 * cfg.n_layers + 1:])):
        assert len(calls) == 2 * cfg.n_layers + 1
        assert sorted(calls).count(((2, S, H, P), (H, P))) == cfg.n_layers
        assert sum(w == (cfg.d_model,) for _, w in calls) == cfg.n_layers + 1


def test_loss_matches_jax_in_bf16():
    """In the bf16 compute the trainer runs, the loss within the bf16
    contract's 1e-2 of the reference's (the gradient is rounding-dominated
    in both packages; see tests/test_torch_train_lm.py)."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    want = float(jm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = float(build_model(cfg, torch.float32).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)


def test_loss_and_flat_grad_match_jax_in_f32(monkeypatch):
    patch_f32_embeddings(monkeypatch)
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, torch.float32)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    assert isinstance(params, tspec.FlatTree)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
             for k in ("tokens", "labels")}
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    loss, grads = value_and_flat_grad(tm, params, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    want_flat = np.concatenate([np.asarray(v, np.float64).reshape(-1)
                                for v in _flatten(want).values()])
    got = grads.double().numpy()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert np.linalg.norm(got - want_flat) / np.linalg.norm(want_flat) < 1e-4
    off = 0
    for path, shape in params.shapes().items():
        n = int(np.prod(shape))
        g, w = got[off:off + n], want_flat[off:off + n]
        off += n
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w) + 1e-12, path
    gnorm = tspec.views(grads, params.shapes())["layers"]["gnorm"]["scale"]
    assert gnorm.shape == (cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_headdim)
    assert float(gnorm.abs().min()) > 0  # every head's gain gets a gradient


def test_bridge_keeps_use_dtypes():
    """bf16 to serve: the projections, conv taps and D skip in bf16 with
    the values the reference drew; A_log, dt_bias, norm gains and the
    embeddings in f32."""
    cfg = get_smoke_config(ARCH)
    flat = _flatten(jax_build_model(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0)))
    p = tspec.flatten(params_from_numpy(flat, cfg, "cpu"))
    assert p.keys() == flat.keys()
    f32 = {"embed", "unembed", "final_norm/scale", "layers/norm/scale",
           "layers/gnorm/scale", "layers/A_log", "layers/dt_bias"}
    for path, t in p.items():
        assert t.dtype == (torch.float32 if path in f32 else torch.bfloat16), path
        np.testing.assert_array_equal(
            t.float().numpy(), torch.from_numpy(np.array(flat[path])).to(t.dtype).float().numpy())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_input_specs_match_reference(arch, kind):
    shape = InputShape("s", 32, 4, kind)
    got = build_model(get_smoke_config(arch)).input_specs(shape)
    want = jax_build_model(jax_smoke_config(arch)).input_specs(shape)
    assert {k: (s.shape, s.axes) for k, s in got.items()} == {
        k: (s.shape, s.axes) for k, s in want.items()}
    assert all(s.dtype == torch.int32 for s in got.values())


# -------------------------------------------------------- entry points ----
def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
                    "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 3)") == 1 and "sample:" in out


def test_train_cli_on_cpu():
    """launch.train: AdamW on f32 masters, finite losses that fall."""
    first, last = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "12",
                                  "--m-per-worker", "4", "--seq", "32",
                                  "--log-every", "6", "--device", "cpu"])
    assert np.isfinite(first) and np.isfinite(last) and last < first
