"""The port's Jamba hybrid (repro_torch.models.hybrid, the ``hybrid``
family) against repro.models.hybrid at smoke size (4 layers: 2 blocks of
attn_every = 2, a mamba mixer and an attention layer each, an MoE FFN at
the odd position), from one JAX init bridged through repro_torch.bridge.
As in tests/test_decode_consistency.py, the forward and decode run at
capacity factor 8 (capacity drops tokens in the forward but never at
one-token decode).

Tolerances, each set before its first run:

* f32 (both packages' ``embed_tokens`` patched to f32, f32 caches):
  forward, prefill and decode within 1e-5 relative max error of the
  reference, and the aux loss within 1e-5; the port's decode within the
  reference's absolute 1e-4 of its own forward
  (``test_jamba_decode_exact_in_f32``).
* bf16, against the reference and against its own forward: the
  reference's hybrid contract, relative max error below 0.08 and argmax
  agreement above 0.9 (mamba, MoE and attention layers stack more bf16
  noise; tests/test_decode_consistency.py). XLA keeps chains of bf16
  elementwise ops in f32 where torch rounds each op (reached at seed 0:
  forward 0.060 and 0.917, decode 0.077 and 0.917 against the
  reference; the reference's decode against its forward 0.038 and 0.917).
* Loss (cross-entropy + 0.01 x aux) and flat gradient against
  ``jax.value_and_grad`` of the reference in f32: 1e-5, 1e-4 and 1e-3 (worst
  leaf), as tests/test_torch_train_lm.py holds the MoE.
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
from repro_torch.engine.steps import make_decode_step, make_prefill, value_and_flat_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import spec as tspec
from repro_torch.models.hybrid import JambaModel
from repro_torch.models.registry import build_model
from _torch_parity import patch_f32_embeddings

ARCH = "jamba-v0.1-52b"
SEQ = 24


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _configs(cf: float = 8.0):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return (dataclasses.replace(cfg, capacity_factor=cf),
            dataclasses.replace(jcfg, capacity_factor=cf))


def run_both(f32: bool, seed: int = 0, seq: int = SEQ) -> dict:
    """Forward and step-by-step decode logits of both packages from one
    JAX init, as numpy, and the aux losses."""
    cfg, jcfg = _configs()
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
            with pytest.MonkeyPatch.context() as mp:
                if f32:
                    patch_f32_embeddings(mp)
                cache[f32] = run_both(f32)
        return cache[f32]
    return get


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_model_matches_reference_f32(outputs, path):
    got, want = outputs(True)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 1e-5, _rel_err(got, want)
    aux, want_aux = outputs(True)["aux"]
    assert abs(aux - want_aux) <= 1e-5 * abs(want_aux)


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_model_matches_reference_bf16(outputs, path):
    got, want = outputs(False)[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 0.08, _rel_err(got, want)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree > 0.9, agree
    aux, want_aux = outputs(False)["aux"]
    assert abs(aux - want_aux) <= 2e-2 * abs(want_aux)


def test_decode_matches_own_forward_bf16(outputs):
    got_fwd, got_dec = outputs(False)["forward"][0], outputs(False)["decode"][0]
    assert _rel_err(got_dec, got_fwd) < 0.08
    assert float(np.mean(got_dec.argmax(-1) == got_fwd.argmax(-1))) > 0.9


def test_decode_exact_in_f32(outputs):
    """tests/test_decode_consistency.py::test_jamba_decode_exact_in_f32 on
    the port: the KV caches and SSM states are exact, so the bf16
    disagreement above is rounding."""
    got_fwd, got_dec = outputs(True)["forward"][0], outputs(True)["decode"][0]
    assert float(np.max(np.abs(got_dec - got_fwd))) < 1e-4


def test_forward_at_config_capacity_matches_reference_f32(monkeypatch):
    """At the config's capacity factor 1.25 some assignments drop: the
    port drops the same ones."""
    patch_f32_embeddings(monkeypatch)
    cfg, jcfg = _configs(cf=get_smoke_config(ARCH).capacity_factor)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, _ = build_model(cfg, torch.float32).forward(tparams, {"tokens": torch.from_numpy(tokens)})
    ample, _ = build_model(dataclasses.replace(cfg, capacity_factor=8.0), torch.float32).forward(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert _rel_err(got.numpy(), np.asarray(want)) < 1e-5
    assert _rel_err(got.numpy(), ample.numpy()) > 1e-4  # tokens were dropped


def test_block_layout_matches_reference():
    """Attention at attn_every // 2, MoE at odd positions, stacked over
    the blocks; the full config's 4 blocks of 8 and its parameter count."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    full = JambaModel(get_config(ARCH))
    assert (full.block_size, full.n_blocks, full.attn_pos) == (8, 4, 4)
    blocks = full.param_specs()["blocks"]
    assert [("attn" in blocks[f"pos{p}"], "moe" in blocks[f"pos{p}"]) for p in range(8)] == [
        (False, False), (False, True), (False, False), (False, True),
        (True, False), (False, True), (False, False), (False, True)]
    assert blocks["pos4"]["attn"]["wq"].shape == (4, 4096, 32, 128)
    assert blocks["pos1"]["moe"]["wi_gate"].shape == (4, 16, 4096, 14336)
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count() \
        == 51_459_770_368
    with pytest.raises(ValueError, match="attn_every"):
        JambaModel(dataclasses.replace(get_config(ARCH), n_layers=12))


def test_norm_calls_per_block(monkeypatch):
    """Per forward: 3 rmsnorm calls a mamba layer (its pre-norm, the gated
    norm with the [H, P] weight, ln2), 2 an attention layer, 1 final; the
    attention runs through swa_attention once a block, and no RoPE (Jamba's
    rope_theta is 0)."""
    cfg, _ = _configs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    calls = {"rmsnorm": [], "swa": 0}
    inner_rms, inner_swa = ops.rmsnorm, ops.swa_attention

    def rms(x, w, **kw):
        calls["rmsnorm"].append(tuple(w.shape))
        return inner_rms(x, w, **kw)

    def swa(*a, **kw):
        calls["swa"] += 1
        return inner_swa(*a, **kw)

    monkeypatch.setattr(ops, "rmsnorm", rms)
    monkeypatch.setattr(ops, "swa_attention", swa)
    monkeypatch.setattr(TL, "apply_rope", None)  # raises if called
    model.forward(params, {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
    nb, n_mamba = model.n_blocks, model.n_blocks * (model.block_size - 1)
    assert len(calls["rmsnorm"]) == 3 * n_mamba + 2 * nb + 1
    assert calls["rmsnorm"].count((cfg.n_ssm_heads, cfg.ssm_headdim)) == n_mamba
    assert calls["swa"] == nb


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
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, torch.float32)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    assert isinstance(params, tspec.FlatTree)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = value_and_flat_grad(tm, params, tbatch)
    logits, aux = tm.forward(params, tbatch)
    ce = TL.softmax_cross_entropy(logits, tbatch["labels"])
    assert abs(float(loss) - float(ce + 0.01 * aux)) <= 1e-6 * float(loss)
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
    tree = tspec.views(grads, params.shapes())["blocks"]
    assert float(tree["pos1"]["moe"]["router"].abs().max()) > 0
    assert float(tree["pos0"]["mamba"]["gnorm"]["scale"].abs().min()) > 0


def test_bridge_is_the_identity_on_the_block_paths():
    """blocks/pos{p}/... map to themselves; matmul weights, conv taps and
    D skip in bf16 to serve, norm gains, A_log, dt_bias and embeddings in
    f32; all f32 (one FlatTree) to train."""
    cfg = get_smoke_config(ARCH)
    flat = _flatten(jax_build_model(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0)))
    p = tspec.flatten(params_from_numpy(flat, cfg, "cpu"))
    assert p.keys() == flat.keys()
    assert "blocks/pos1/attn/wq" in p and "blocks/pos1/moe/wo" in p
    f32_leaves = ("scale", "A_log", "dt_bias", "embed", "unembed")
    for path, t in p.items():
        assert t.dtype == (torch.float32 if path.endswith(f32_leaves) else torch.bfloat16), path
    f32 = params_from_numpy(flat, cfg, "cpu", torch.float32)
    for path, v in tspec.flatten(f32).items():
        np.testing.assert_array_equal(v.numpy(), flat[path])


# -------------------------------------------------------- entry points ----
def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
                    "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 3)") == 1 and "sample:" in out


def test_train_cli_on_cpu():
    first, last = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4",
                                  "--m-per-worker", "2", "--seq", "16",
                                  "--log-every", "2", "--device", "cpu"])
    assert np.isfinite(first) and np.isfinite(last)
