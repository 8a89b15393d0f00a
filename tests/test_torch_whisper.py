"""The port's audio family (repro_torch.models.whisper) against
repro.models.whisper at smoke size, from one JAX init bridged through
repro_torch.bridge, on the same numpy inputs.

Tolerances, each set before its first run:

* f32 (``_torch_parity.patch_whisper_f32``: embeddings and the encoder's
  input in f32 in both packages; f32 caches): the gelu MLP, attention
  with ``memory`` (cross-attention) and without, ``encode``, ``forward``,
  ``loss`` and a step-by-step decode match the reference to a relative
  max error (max |port - ref| / max |ref|) below 1e-5, as
  tests/test_torch_transformer.py holds the decoder-only families; the
  greedy tokens of ``launch.serve`` are identical.
* ``sinusoidal``: each value within 1e-6 + p * 2^-21 at position p. Both
  packages compute the angle p * f in f32, and XLA's and torch's f32
  ``exp`` differ in the last bit of some frequencies f, so the angle
  differs by up to about p * 2^-23; four times that bounds the sine's.
* bf16: the reference's serving contract of tests/test_decode_consistency.py
  (relative max error below 0.08, argmax agreement above 0.95) for the
  forward against the reference, and that test's whisper gate (relative
  max error below 0.08) for the port's decode against its own forward,
  with the encoder's output written into the cache. The same decode with
  ``cache["enc"]`` left at zeros must fail both the f32 and the bf16 gate:
  the cross-attention then reads no audio.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.layers as JL
import repro.models.transformer as JT
from repro.checkpoint.store import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import InputShape
from repro.launch.serve import serve as jax_serve
from repro.models import spec as jspec
from repro.models.registry import build_model as jax_build_model
from repro.models.whisper import sinusoidal as jax_sinusoidal
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.engine.steps import make_decode_step, make_prefill
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as TL
from repro_torch.models import spec as tspec
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.models.whisper import WhisperModel
from _torch_parity import both, patch_whisper_f32

ARCH = "whisper-base"
F32_TOL = 1e-5
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SEQ = 24  # decoder tokens; the smoke encoder reads 16 frames
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _argmax_agree(got, want) -> float:
    return float((np.asarray(got).argmax(-1) == np.asarray(want).argmax(-1)).mean())


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(cfg, seed=0, seq=SEQ):
    """tokens, labels [2, seq] and frames [2, n_frames, D] at scale 0.1, as
    tests/test_decode_consistency.py draws them."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32),
            "frames": (rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
                       * 0.1).astype(np.float32)}


def _models(dtype, seed=0):
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, DTYPES[dtype])
    return cfg, jm, jparams, tm, params_from_numpy(_flatten(jparams), cfg, "cpu",
                                                   DTYPES[dtype])


def _on_jax(batch, frames_dtype=jnp.float32):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frames" in out:
        out["frames"] = out["frames"].astype(frames_dtype)
    return out


def _on_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- layers ----
@pytest.mark.parametrize("d_model", [128, 512])
def test_sinusoidal_matches_reference(d_model):
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    got = TL.sinusoidal(torch.from_numpy(pos), d_model)
    want = np.asarray(jax_sinusoidal(jnp.asarray(pos), d_model))
    assert got.dtype == torch.float32 and got.shape == (2, 1500, d_model)
    bound = 1e-6 + pos[..., None].astype(np.float64) * 2.0 ** -21
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    D, F = cfg.d_model, cfg.d_ff
    w = {"wi": rng.normal(size=(D, F)) * D ** -0.5, "wi_bias": rng.normal(size=F) * 0.1,
         "wo": rng.normal(size=(F, D)) * F ** -0.5, "wo_bias": rng.normal(size=D) * 0.1}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jx, tx = both(rng.normal(size=(2, 5, D)).astype(np.float32), dtype)
    got = TL.mlp(cfg, {k: torch.from_numpy(v) for k, v in w.items()}, tx)
    assert got.dtype == tx.dtype
    want = JL.mlp(cfg, {k: jnp.asarray(v) for k, v in w.items()}, jx)
    np.testing.assert_allclose(_np(got), _np(want), rtol=LAYER_TOL[dtype],
                               atol=LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub_layer", ["cross", "encoder_self"])
def test_attention_with_memory_matches_reference(sub_layer, dtype):
    """The decoder's cross-attention (``memory`` from the encoder, no
    RoPE, not causal) and the encoder's non-causal self-attention, with
    layer 0's weights of the bridged init and random biases."""
    cfg, _, jparams, _, _ = _models("float32")
    rng = np.random.default_rng(6)
    tree = "xattn" if sub_layer == "cross" else "attn"
    part = "decoder" if sub_layer == "cross" else "encoder"
    p = {k: np.array(v[0]) for k, v in jparams[part][tree].items()}
    for k in ("bq", "bk", "bv"):
        p[k] = (rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    jx, tx = both(rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32), dtype)
    jm, tm = both(rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
                  .astype(np.float32), dtype)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    kw = dict(window=None, causal=False)
    if sub_layer == "cross":
        want, _ = JT.attention(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jx,
                               jnp.asarray(pos), JL.NO_SHARD, memory=jm, **kw)
        got = TT.attention(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, tx,
                           torch.from_numpy(pos.copy()), TL.NO_SHARD, memory=tm, **kw)
    else:
        want, _ = JT.attention(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jm,
                               None, JL.NO_SHARD, **kw)
        got = TT.attention(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, tm,
                           None, TL.NO_SHARD, **kw)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=LAYER_TOL[dtype],
                               atol=LAYER_TOL[dtype])


# -------------------------------------------------------------- model ----
@pytest.fixture(scope="module")
def f32_run():
    """encode, forward, loss, prefill and a step-by-step decode of both
    packages with f32 activations, and the port's decode with the cache's
    ``enc`` left at zeros, as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        patch_whisper_f32(mp)
        cfg, jm, jparams, tm, params = _models("float32")
        batch = _inputs(cfg)
        jb, tb = _on_jax(batch), _on_torch(batch)
        out = {"encode": (tm.encode(params, tb["frames"]), jm.encode(jparams, jb["frames"])),
               "forward": (tm.forward(params, tb)[0], jm.forward(jparams, jb)[0]),
               "loss": (tm.loss(params, tb), jm.loss(jparams, jb)),
               "prefill": (make_prefill(tm, device="cpu")(params, batch),
                           jm.prefill(jparams, jb))}
        out["decode"], out["decode_enc_zeroed"] = _decode_both(tm, params, jm, jparams,
                                                               batch, torch.float32)
        out["own_forward"] = out["forward"][0]
    return {k: ((_np(v[0]), _np(v[1])) if isinstance(v, tuple) else _np(v))
            for k, v in out.items()}


def _decode_both(tm, params, jm, jparams, batch, dtype):
    """Step decode over the tokens in both packages with ``enc`` from each
    one's ``encode``; and the port's again with ``enc`` left at zeros.
    Returns ((port, reference), port with enc zeroed) logits [2, S, V]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    shape = InputShape("d", s, b, "decode")
    tdecode = make_decode_step(tm, device="cpu")
    jcache = jspec.init_params(jax.random.PRNGKey(1), jm.cache_specs(shape))
    jcache = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jcache)
    jcache["enc"] = jm.encode(jparams, _on_jax(batch)["frames"]).astype(jnp.float32)
    jdecode = jax.jit(jm.decode_step)
    runs = {}
    for label in ("enc", "enc_zeroed"):
        cache = tspec.init_params(None, tm.cache_specs(shape, dtype), "cpu")
        if label == "enc":
            cache["enc"].copy_(tm.encode(params, torch.from_numpy(batch["frames"])))
        runs[label] = []
        for t in range(s):
            step = {"tokens": tokens[:, t:t + 1], "pos": np.full((b,), t, np.int32)}
            logits, cache = tdecode(params, cache, step)
            runs[label].append(logits[:, 0])
            if label == "enc":
                lj, jcache = jdecode(jparams, jcache, {k: jnp.asarray(v)
                                                       for k, v in step.items()})
                runs.setdefault("reference", []).append(np.asarray(lj[:, 0]))
    got = torch.stack(runs["enc"], 1)
    return (got, np.stack(runs["reference"], 1)), torch.stack(runs["enc_zeroed"], 1)


@pytest.mark.parametrize("path", ["encode", "forward", "loss", "prefill", "decode"])
def test_matches_reference_f32(f32_run, path):
    got, want = f32_run[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < F32_TOL, (path, _rel_err(got, want))


def test_decode_gate_fails_with_enc_zeroed_f32(f32_run):
    """Decode against the port's own forward: within 1e-5 with the
    encoder's output in the cache, far outside it with ``enc`` at zeros."""
    assert _rel_err(f32_run["decode"][0], f32_run["own_forward"]) < F32_TOL
    assert _rel_err(f32_run["decode_enc_zeroed"], f32_run["own_forward"]) >= F32_TOL


@pytest.fixture(scope="module")
def bf16_run():
    cfg, jm, jparams, tm, params = _models("bfloat16")
    batch = _inputs(cfg)
    got = tm.forward(params, _on_torch(batch))[0]
    want = jm.forward(jparams, _on_jax(batch, jnp.bfloat16))[0]
    (dec, _), zeroed = _decode_both(tm, params, jm, jparams, batch, torch.bfloat16)
    return {"forward": (_np(got), _np(want)), "decode": _np(dec),
            "decode_enc_zeroed": _np(zeroed), "own_forward": _np(got)}


def test_forward_bf16_contract(bf16_run):
    got, want = bf16_run["forward"]
    assert _rel_err(got, want) < 0.08 and _argmax_agree(got, want) > 0.95


def test_decode_matches_forward_bf16_and_fails_with_enc_zeroed(bf16_run):
    """tests/test_decode_consistency.py::test_whisper_decode_matches_forward
    on the port, and its control."""
    fwd = bf16_run["own_forward"]
    assert _rel_err(bf16_run["decode"], fwd) < 0.08
    assert _rel_err(bf16_run["decode_enc_zeroed"], fwd) >= 0.08


# ---------------------------------------------------------- plumbing ----
def test_bridge_from_reference_init():
    """Every path of the reference's tree; layernorm gains and biases and
    the embedding tables in f32, matmul weights and biases in bf16."""
    cfg, _, jparams, tm, params = _models("bfloat16")
    flat = _flatten(jparams)
    got = tspec.flatten(params)
    assert got.keys() == flat.keys()
    assert {"decoder/lnx/scale", "decoder/xattn/wq", "decoder/xattn/bv",
            "encoder/mlp/wi_bias", "enc_norm/bias", "dec_norm/scale"} <= got.keys()
    for path, t in got.items():
        f32 = path in ("embed", "unembed") or "norm" in path or "/ln" in path
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
        np.testing.assert_array_equal(
            t.float().numpy(), torch.from_numpy(np.array(flat[path])).to(t.dtype).float().numpy())


def test_param_count_is_whisper_base():
    assert get_config(ARCH).param_count() == 97_241_088
    assert isinstance(build_model(get_config(ARCH)), WhisperModel)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    shape = InputShape("s", 32, 4, kind)
    got = build_model(get_smoke_config(ARCH)).input_specs(shape)
    want = jax_build_model(jax_smoke_config(ARCH)).input_specs(shape)
    assert {k: (s.shape, s.axes) for k, s in got.items()} == {
        k: (s.shape, s.axes) for k, s in want.items()}


def test_cache_specs_match_reference():
    shape = InputShape("s", 32, 4, "decode")
    got = build_model(get_smoke_config(ARCH)).cache_specs(shape)
    want = jax_build_model(jax_smoke_config(ARCH)).cache_specs(shape)
    assert {k: s.shape for k, s in got.items()} == {k: s.shape for k, s in want.items()}


def test_serve_tokens_identical_in_f32(monkeypatch):
    """launch.serve as the reference serves whisper: a cache whose ``enc``
    stays at zeros (no audio frames are passed)."""
    patch_whisper_f32(monkeypatch)
    cfg, jm, jparams, _, params = _models("float32")
    kw = dict(batch=2, prompt_len=8, new_tokens=6)
    want, _ = jax_serve(jax_smoke_config(ARCH), params=jparams, log=False, **kw)
    got, _ = serve_cli.serve(cfg, params=params, device="cpu", **kw)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
                    "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 3)") == 1 and "sample:" in out
