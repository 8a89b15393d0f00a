"""The port's layers (repro_torch.models.layers) against
repro.models.layers on the same numpy inputs. f32 cases hold to 1e-5
(summation order is the only difference); bf16 cases to the 2e-2 of
tests/test_kernels.py (bf16 rounds at other places in the two frameworks)."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import repro.models.layers as JL
import repro_torch.models.layers as TL
from repro_torch.kernels import ref
from repro_torch.configs import get_smoke_config
from _torch_parity import both

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got: torch.Tensor, want, tol: float):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta, dtype):
    rng = np.random.default_rng(0)
    jx, tx = both(_normal(rng, 2, 40, 3, 32), dtype)
    pos = rng.integers(0, 4096, (2, 40)).astype(np.int32)
    got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    _close(got, JL.apply_rope(jx, jnp.asarray(pos), theta),
           1e-4 if dtype == "float32" else TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,d", [((2, 2, 2), 12), ((16, 24, 24), 128)])
def test_apply_rope_mrope_sections(sections, d, dtype):
    """M-RoPE: positions [B, S, 3] (t, h, w), the half-dim split by
    ``sections``, against the reference; the grid coordinates of Qwen2-VL's
    256 patches (t = 0, h and w up to 15) and text positions past them.
    Also the reference's own case: ones rotated by (i, 2i, 3i)."""
    rng = np.random.default_rng(9)
    jx, tx = both(_normal(rng, 2, 40, 3, d), dtype)
    pos = rng.integers(0, 300, (2, 40, 3)).astype(np.int32)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 1_000_000.0, sections)
    assert got.dtype == tx.dtype
    _close(got, JL.apply_rope(jx, jnp.asarray(pos), 1_000_000.0, sections),
           1e-6 if dtype == "float32" else TOL[dtype])
    if d == 12:
        pos3 = np.stack([np.arange(4), np.arange(4) * 2, np.arange(4) * 3],
                        axis=-1)[None].astype(np.int32)
        ones = np.ones((1, 4, 1, 12), np.float32)
        got = TL.apply_rope(torch.from_numpy(ones), torch.from_numpy(pos3),
                            10_000.0, sections)
        _close(got, JL.apply_rope(jnp.asarray(ones), jnp.asarray(pos3),
                                  10_000.0, sections), 1e-6)


def test_apply_rope_refuses_sections_that_do_not_split_the_half_dim():
    x = torch.zeros(1, 4, 1, 12)
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.apply_rope(x, torch.zeros(1, 4, 3, dtype=torch.int32), 1e4, (2, 2, 3))
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.apply_rope(x, torch.zeros(1, 4, dtype=torch.int32), 1e4, (2, 2, 2))


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    jk, tk = both(_normal(np.random.default_rng(1), 2, 5, 2, 8))
    got = TL.repeat_kv(tk, n_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL.repeat_kv(jk, n_rep)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,n_rep", [
    (True, None, 1), (True, 7, 1), (True, None, 2), (False, None, 1),
    (True, 16, 4)])
def test_chunked_attention(causal, window, n_rep, dtype):
    """Whole-sequence attention (the swa kernel's path in the port) against
    the reference's query-chunked XLA attention, GQA-repeated KV."""
    rng = np.random.default_rng(2)
    b, s, hkv, d = 2, 37, 2, 32
    jq, tq = both(_normal(rng, b, s, hkv * n_rep, d), dtype)
    jk, tk = both(_normal(rng, b, s, hkv, d), dtype)
    jv, tv = both(_normal(rng, b, s, hkv, d), dtype)
    got = TL.chunked_attention(tq, TL.repeat_kv(tk, n_rep),
                               TL.repeat_kv(tv, n_rep), causal=causal,
                               window=window)
    assert got.dtype == tq.dtype
    want = JL.chunked_attention(jq, JL.repeat_kv(jk, n_rep),
                                JL.repeat_kv(jv, n_rep), causal=causal,
                                window=window, q_chunk=16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (1, 40, False, None, 0), (9, 23, False, None, 0), (7, 30, True, None, 23),
    (7, 30, True, 5, 23), (12, 20, False, 10, 3)])
def test_chunked_attention_cross(sq, sk, causal, window, q_offset, dtype):
    """Cross-attention (Sk != Sq) and queries at an offset, [B, S, H, D]
    with GQA-repeated KV, against the reference's chunked attention."""
    rng = np.random.default_rng(5)
    b, hkv, n_rep, d = 2, 2, 2, 32
    jq, tq = both(_normal(rng, b, sq, hkv * n_rep, d), dtype)
    jk, tk = both(_normal(rng, b, sk, hkv, d), dtype)
    jv, tv = both(_normal(rng, b, sk, hkv, d), dtype)
    got = TL.chunked_attention(tq, TL.repeat_kv(tk, n_rep), TL.repeat_kv(tv, n_rep),
                               causal=causal, window=window, q_offset=q_offset)
    want = JL.chunked_attention(jq, JL.repeat_kv(jk, n_rep), JL.repeat_kv(jv, n_rep),
                                causal=causal, window=window, q_chunk=4,
                                q_offset=q_offset)
    _close(got, want, TOL[dtype])


def test_chunked_attention_refuses_cross_attention():
    """Cross-attention (Sq != Sk) and queries at an offset now take a
    gradient too (nothing is refused any more): the attention Function's
    backward formula has both cases, and its gradient is autograd's
    through the plain version (tests/test_torch_swa_cross_grad.py holds
    more shapes)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, 1, 4, 2, 32)).requires_grad_()
    kv = torch.from_numpy(_normal(rng, 1, 6, 2, 32)).requires_grad_()
    def to_bh(t):  # [B, S, H, D] -> [B*H, S, D]
        return t.permute(0, 2, 1, 3).reshape(2, t.shape[1], 32)

    for args, kw, wrt in (((q, kv, kv), dict(causal=False), (q, kv)),
                          ((q, q, q), dict(q_offset=3), (q,))):
        got = torch.autograd.grad(TL.chunked_attention(*args, **kw).sum(), wrt)
        want = torch.autograd.grad(ref.swa_attention_ref(*map(to_bh, args), **kw).sum(), wrt)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert TL.chunked_attention(q, kv, kv, causal=False).shape == q.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,repeated", [(None, False), (5, False),
                                             (None, True)])
def test_decode_attention(window, repeated, dtype):
    rng = np.random.default_rng(3)
    b, s, hkv, h, d = 3, 20, 2, 4, 32
    jq, tq = both(_normal(rng, b, 1, h, d), dtype)
    kv_heads = h if repeated else hkv
    jk, tk = both(_normal(rng, b, s, kv_heads, d), dtype)
    jv, tv = both(_normal(rng, b, s, kv_heads, d), dtype)
    pos = np.array([0, 9, 19], np.int32)
    got = TL.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=window,
                              repeated=repeated)
    want = JL.decode_attention(jq, jk, jv, jnp.asarray(pos), window=window,
                               repeated=repeated)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b"])  # silu, geglu
def test_mlp(arch, dtype):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(4)
    D, F = cfg.d_model, cfg.d_ff
    w = {"wi_gate": _normal(rng, D, F, scale=D ** -0.5),
         "wi_up": _normal(rng, D, F, scale=D ** -0.5),
         "wo": _normal(rng, F, D, scale=F ** -0.5)}
    jx, tx = both(_normal(rng, 2, 5, D), dtype)
    got = TL.mlp(cfg, {k: torch.from_numpy(v) for k, v in w.items()}, tx)
    assert got.dtype == tx.dtype
    want = JL.mlp(cfg, {k: jnp.asarray(v) for k, v in w.items()}, jx)
    _close(got, want, TOL[dtype])


def test_mlp_refuses_unported_activation():
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), activation="relu")
    with pytest.raises(ValueError, match="relu"):
        TL.mlp(cfg, {}, torch.zeros(1, 1, cfg.d_model))


@pytest.mark.parametrize("scale", [None, 128 ** 0.5])
def test_embed_tokens(scale):
    """Gather in f32, cast to bf16, then the scale (rounded to bf16) — the
    rounding steps match the reference exactly."""
    rng = np.random.default_rng(5)
    je, te = both(_normal(rng, 50, 16))
    tokens = rng.integers(0, 50, (2, 7)).astype(np.int32)
    got = TL.embed_tokens(te, torch.from_numpy(tokens), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(JL.embed_tokens(je, jnp.asarray(tokens), scale), np.float32))


def test_lm_logits():
    rng = np.random.default_rng(6)
    jx, tx = both(_normal(rng, 2, 3, 16), "bfloat16")
    je, te = both(_normal(rng, 40, 16))
    got = TL.lm_logits(tx, te)
    assert got.dtype == torch.float32
    _close(got, JL.lm_logits(jx, je), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_layer(dtype):
    rng = np.random.default_rng(7)
    jx, tx = both(_normal(rng, 2, 9, 64), dtype)
    w = _normal(rng, 64, scale=0.1)
    got = TL.apply_norm(get_smoke_config("qwen2.5-3b"), tx,
                        {"scale": torch.from_numpy(w)})
    _close(got, JL.rmsnorm(jx, jnp.asarray(w)), TOL[dtype])


def test_layernorm():
    rng = np.random.default_rng(8)
    jx, tx = both(_normal(rng, 2, 9, 64))
    w, b = _normal(rng, 64), _normal(rng, 64)
    got = TL.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b))
    _close(got, JL.layernorm(jx, jnp.asarray(w), jnp.asarray(b)), 1e-5)
