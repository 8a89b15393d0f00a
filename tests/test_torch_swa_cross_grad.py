"""The cross-attention gradient on the CPU: ``kernels.ops.swa_attention``'s
backward formula with queries and keys of different lengths and queries
at an offset, against autograd of the plain version; whisper-base's smoke
loss and gradient against ``jax.grad`` of the reference's
``WhisperModel.loss`` from the bridged weights, with f32 activations in
both packages (``_torch_parity.patch_whisper_f32``) at
tests/test_torch_whisper.py's f32 tolerance (relative max error 1e-5);
and self-attention gradients bit-identical to the formula as it stood
before the cross case was added (a frozen copy below)."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.store import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.engine.steps import value_and_flat_grad
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build_model
from _torch_parity import patch_whisper_f32

F32_TOL = 1e-5
# (bh, sq, sk, d, causal, window, q_offset): whisper's shapes at small
# size (encoder frames longer than the text, one decode row), causal
# continuations at an offset, with and without a window
CROSS = [(2, 5, 16, 32, False, None, 0), (2, 1, 16, 32, False, None, 0),
         (3, 7, 12, 16, True, None, 5), (2, 6, 20, 16, True, 4, 14),
         (1, 9, 4, 8, False, None, 0), (2, 8, 11, 16, False, 3, 2)]


def _args(bh, sq, sk, d, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32))
               .to(dtype) for n in (sq, sk, sk))
    do = torch.from_numpy(rng.standard_normal((bh, sq, d), dtype=np.float32)).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("bh,sq,sk,d,causal,window,q_offset", CROSS)
def test_cross_attention_backward_matches_autograd_of_plain(bh, sq, sk, d, causal,
                                                            window, q_offset):
    q, k, v, do = _args(bh, sq, sk, d, seed=sq * sk + q_offset)
    args = [t.requires_grad_() for t in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = ops.swa_attention(*args, **kw)
    assert type(out.grad_fn).__name__ == "_SWAAttentionBackward"
    got = torch.autograd.grad(out, args, do)
    want = torch.autograd.grad(ref.swa_attention_ref(*args, **kw), args, do)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_cross_attention_backward_in_row_blocks(monkeypatch):
    """Blocks of 3 query rows (a ragged last block) over Sk = 13 keys at an
    offset give the one-block result."""
    q, k, v, do = _args(2, 10, 13, 16, seed=5)
    kw = dict(causal=True, window=6, q_offset=3)
    whole = ops.swa_attention_backward(q, k, v, do, **kw)
    monkeypatch.setattr(ops, "_SWA_BWD_BLOCK", 2 * 13 * 3)
    blocks = ops.swa_attention_backward(q, k, v, do, **kw)
    for a, b in zip(blocks, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def _self_attention_backward_before(q, k, v, do, *, causal=True, window=None):
    """The self-attention backward formula as it stood before the cross
    case (Sq = Sk, no offset), frozen."""
    bh, s, d = q.shape
    ct = ref.math_dtype(q.dtype)
    qf, kf, vf, dof = (t.to(ct) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    mask = ref.swa_mask(s, s, q.device, causal=causal, window=window)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = max(1, min(s, ops._SWA_BWD_BLOCK // max(1, bh * s)))
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qb, dob = qf[:, r0:r1], dof[:, r0:r1]
        scores = torch.einsum("bqd,bkd->bqk", qb, kf) * scale
        p = torch.softmax(torch.where(mask[None, r0:r1], scores, ref.NEG_INF), -1)
        dv += torch.einsum("bqk,bqd->bkd", p, dob)
        dp = torch.einsum("bqd,bkd->bqk", dob, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, r0:r1] = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
        dk += torch.einsum("bqk,bqd->bkd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,causal,window,block", [
    (16, 32, True, None, None), (24, 16, True, 5, None), (12, 8, False, None, None),
    (20, 16, True, 7, 2 * 20 * 3)])
def test_self_attention_gradients_keep_their_bits(s, d, causal, window, block, dtype,
                                                  monkeypatch):
    if block is not None:
        monkeypatch.setattr(ops, "_SWA_BWD_BLOCK", block)
    q, k, v, do = _args(2, s, s, d, dtype, seed=s + d)
    want = _self_attention_backward_before(q, k, v, do, causal=causal, window=window)
    got = ops.swa_attention_backward(q, k, v, do, causal=causal, window=window)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    through = torch.autograd.grad(
        ops.swa_attention(*args, causal=causal, window=window), args, do)
    for a, b, c in zip(got, want, through):
        assert torch.equal(a, b) and torch.equal(c, b)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def test_whisper_loss_gradient_matches_jax_grad_f32(monkeypatch):
    """whisper-base smoke: loss and flat gradient (encoder, decoder with
    its cross-attention, embeddings) against jax.value_and_grad of the
    reference's loss from the same weights; every leaf gets a gradient."""
    patch_whisper_f32(monkeypatch)
    arch = "whisper-base"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, torch.float32)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "frames": (rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
                        * 0.1).astype(np.float32)}
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    loss, grads = value_and_flat_grad(tm, params, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    want_flat = np.concatenate([np.asarray(v, np.float64).reshape(-1)
                                for v in _flatten(want).values()])
    assert _rel_err(float(loss), float(want_loss)) < F32_TOL
    assert _rel_err(grads.double().numpy(), want_flat) < F32_TOL
    offset = 0
    for path, shape in params.shapes().items():
        n = math.prod(shape)
        assert float(np.abs(want_flat[offset:offset + n]).max()) == 0 or \
            float(grads[offset:offset + n].abs().max()) > 0, path
        offset += n
