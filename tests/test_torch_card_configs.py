"""The configs and the training step that chip_smoke.py runs on the card
for the first time, checked on the CPU: the full-width parameter counts of
gemma-2b, h2o-danube-1.8b and qwen2.5-14b against the reference's and the
dense phase's gates; the kernel route's contiguous heads at batch 1; the
faulty-cache controls decoded in one batch with the sound decode;
``chip_smoke.lm_step_vs_plain`` generalised to
whisper's ``encoder/...`` and ``decoder/...`` stacks (kernels against
plain versions read about 0 on the CPU, where both routes run the plain
forward; both controls fail the gate), and still splitting the
decoder-only and SSM ``layers/...`` leaves as before; and one AdamW step
of whisper-base's smoke config through the port's ``make_train_step``
against the reference's from the same weights in f32."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.store import _flatten
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.engine.steps import make_train_step as jax_make_train_step
from repro.models.registry import build_model as jax_build_model
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import make_decode_step, make_prefill, make_train_step
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_module
from repro_torch.kernels import swa_attention as swa_module
from repro_torch.models import spec as pspec
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from _torch_parity import patch_whisper_f32

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

F32_TOL = 1e-5


@pytest.mark.parametrize("arch", ["gemma-2b", "h2o-danube-1.8b", "qwen2.5-14b"])
def test_full_width_param_count_is_the_reference_and_the_dense_gate(arch):
    n = get_config(arch).param_count()
    assert n == jax_config(arch).param_count() == chip_smoke.DENSE_PARAMS[arch]
    # what init_full counts: the leaves the model draws
    assert pspec.n_params(build_model(get_config(arch)).param_specs()) == n


def test_danube_window_binds_only_in_the_long_prefill():
    cfg = get_config(chip_smoke.DANUBE_ARCH)
    assert chip_smoke.PREFILL_SHAPE[1] < cfg.sliding_window < chip_smoke.DANUBE_LONG[1]
    assert chip_smoke.DANUBE_CUT_WINDOW < chip_smoke.CONTROL_POSITIONS \
        < chip_smoke.DANUBE_CUT_SHAPE[1]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-base"])
def test_attention_hands_the_kernel_contiguous_heads(arch, batch, monkeypatch):
    """The kernel route (forced here, with the plain versions standing in
    for the kernels) gets contiguous [B*H, S, D] tensors, as the CUDA
    wrapper requires, at batch 1 too (a [1, 8192] prefill on the card
    found the strided view)."""
    shapes = []

    def contiguous_only(q, k, v, **kw):
        assert all(t.is_contiguous() for t in (q, k, v)), [t.stride() for t in (q, k, v)]
        shapes.append(tuple(q.shape))
        return ref.swa_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(ops, "_route", lambda x, name: True)
    monkeypatch.setattr(swa_module, "swa_attention", contiguous_only)
    monkeypatch.setattr(rms_module, "rmsnorm", ref.rmsnorm_ref)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = TokenStream(cfg.vocab_size, 40, seed=1).batch(0, batch)["tokens"]
    inputs = {"tokens": torch.as_tensor(tokens)}
    if cfg.family == "audio":
        inputs["frames"] = torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model))
    logits = make_prefill(model, device="cpu")(params, inputs)
    assert logits.shape == (batch, 40, cfg.vocab_size)
    assert len(shapes) == cfg.n_layers + cfg.encoder_layers + (
        cfg.n_layers if cfg.family == "audio" else 0)


@pytest.mark.parametrize("arch,faults", [("h2o-danube-1.8b", ("pos_lag", "no_cache")),
                                         ("whisper-base", ("no_cache", "enc_zeroed"))])
def test_decode_controls_in_one_batch_read_as_alone(arch, faults, monkeypatch):
    """decode_vs_prefill's ``controls`` (each fault on its own copy of the
    rows, in the same steps) read what each fault's decode reads alone,
    and the sound decode reads what it reads without them."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CONTROL_POSITIONS", 8)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, 12, seed=5).batch(0, 2)["tokens"])
    batch, enc = {"tokens": tokens}, None
    if cfg.family == "audio":
        batch["frames"] = 0.1 * torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=torch.Generator().manual_seed(1))
        enc = model.encode(params, batch["frames"])
    logits = make_prefill(model, device="cpu")(params, batch)
    decode = make_decode_step(model, device="cpu")
    grouped = chip_smoke.decode_vs_prefill(decode, model, params, tokens, logits, 12,
                                           enc=enc, controls=faults)
    alone = {f: chip_smoke.decode_vs_prefill(decode, model, params, tokens, logits,
                                             8 if f else 12, fault=f, enc=enc)
             for f in (None, *faults)}
    readings = [(grouped, alone[None]), (grouped["head"], alone[None]["head"])] + [
        (grouped["controls"][f], alone[f]) for f in faults]
    for got, want in readings:
        assert got["positions"] == want["positions"]
        assert got["argmax_agree"] == want["argmax_agree"]
        for key in ("rel_err_last", "rel_err_all"):
            assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6)
        if "finite" in got:
            assert got["finite"] and want["finite"]
            assert got["last_shape"] == want["last_shape"] == [2, 1, cfg.vocab_size]
    assert all(not chip_smoke.decode_gate(grouped["controls"][f]) for f in faults)
    assert "head" in grouped and chip_smoke.decode_gate(grouped["head"])


def _whisper_step_check(monkeypatch, cfg, model, params, leaf):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.as_tensor(v) for k, v in
             TokenStream(cfg.vocab_size, 24, seed=3).batch(0, 2).items()}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32) * 0.1)
    return chip_smoke.lm_step_vs_plain(model, params, batch, leaf)


def test_lm_step_vs_plain_on_whisper_reads_zero_and_fails_its_controls(monkeypatch):
    cfg = get_smoke_config("whisper-base")
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    stacked = chip_smoke.stacked_leaves(model)
    assert stacked == {p for p in params.shapes()
                       if p.startswith(("encoder/", "decoder/"))}
    assert chip_smoke.zero_gradient_leaves(model) == {
        "encoder/attn/bk", "decoder/attn/bk", "decoder/xattn/bk"}
    r = _whisper_step_check(monkeypatch, cfg, model, params, chip_smoke.AUDIO_ZEROED_LEAF)
    k = r["kernels"]
    # on the CPU both routes run the plain forward; only the backward
    # formula against autograd differs
    assert k["loss_rel_err"] < 1e-6 and k["flat_rel_err"] < 1e-3 \
        and k["worst_leaf_rel_err"] < 1e-2, k
    assert chip_smoke.lm_step_gate(k)
    assert k["zero_gradient_leaves_norm_rel"] < chip_smoke.AUDIO_ZERO_GRAD_LIMIT
    last = f"{chip_smoke.AUDIO_ZEROED_LEAF}[{cfg.n_layers - 1}]"
    assert r["one_layer_zeroed"]["worst_leaf"] == last
    assert r["one_layer_zeroed"]["worst_leaf_rel_err"] == 1.0
    for control in chip_smoke.LM_CONTROLS:
        assert not chip_smoke.lm_step_gate(r[control]), (control, r[control])


def _old_lm_grad_errors(got, want, shapes):
    """chip_smoke.lm_grad_errors as it stood before whisper's stacks: a
    leaf under ``layers/`` is split per layer."""
    num = den = worst = 0.0
    worst_leaf, off = None, 0
    for path, shape in shapes.items():
        size = math.prod(shape)
        g, w = got[off:off + size].view(shape), want[off:off + size].view(shape)
        off += size
        if path.startswith("layers/"):
            pairs = [(f"{path}[{i}]", a, b)
                     for i, (a, b) in enumerate(zip(g.unbind(0), w.unbind(0)))]
        else:
            pairs = [(path, g, w)]
        for name, a, b in pairs:
            d2 = float((a - b).double().square().sum())
            b2 = float(b.double().square().sum())
            num, den = num + d2, den + b2
            err = math.sqrt(d2 / b2) if b2 else (0.0 if d2 == 0 else math.inf)
            if err > worst:
                worst, worst_leaf = err, name
    return {"flat_rel_err": math.sqrt(num / den), "worst_leaf_rel_err": worst,
            "worst_leaf": worst_leaf}


@pytest.mark.parametrize("arch,leaf", [("qwen2.5-3b", "layers/mlp/wo"),
                                       ("mamba2-780m", "layers/gnorm/scale")])
def test_lm_step_vs_plain_splits_layers_as_before(arch, leaf, monkeypatch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    shapes, stacked = params.shapes(), chip_smoke.stacked_leaves(model)
    assert stacked == {p for p in shapes if p.startswith("layers/")}
    assert chip_smoke.zero_gradient_leaves(model) == set()
    gen = torch.Generator().manual_seed(1)
    want = torch.randn(params.flat.shape, generator=gen)
    got = want + 0.01 * torch.randn(params.flat.shape, generator=gen)
    assert chip_smoke.lm_grad_errors(got, want, shapes, stacked) == \
        _old_lm_grad_errors(got, want, shapes)
    r = _whisper_step_check(monkeypatch, cfg, model, params, leaf)
    assert r["zeroed_leaf"] == leaf
    assert r["one_layer_zeroed"]["worst_leaf"] == f"{leaf}[{cfg.n_layers - 1}]"
    assert chip_smoke.lm_step_gate(r["kernels"])


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_one_adamw_step_of_whisper_matches_the_reference_f32(monkeypatch):
    """From the same weights and batch with f32 activations in both
    packages: the loss, and the parameters after the update, to 1e-5. The
    key biases' gradient is rounding in both packages (its exact value is
    0: zero_gradient_leaves), and AdamW scales rounding up to a step of
    up to lr, so those leaves are held only to that bound."""
    patch_whisper_f32(monkeypatch)
    arch = "whisper-base"
    cfg = get_smoke_config(arch)
    jm = jax_build_model(jax_smoke_config(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, torch.float32)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "frames": (rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
                        * 0.1).astype(np.float32)}
    lr = 1e-3
    jstate = {"params": jparams, "opt": jax_adamw().init(jparams)}
    jstate, jloss = jax.jit(jax_make_train_step(jm, jax_adamw()))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lr))
    opt = adamw()
    p0 = {k: v.clone() for k, v in pspec.flatten(params).items()}
    state, loss = make_train_step(model, opt, device="cpu")(
        {"params": params, "opt": opt.init(params)},
        {k: torch.from_numpy(v) for k, v in batch.items()}, lr)
    assert abs(float(loss) - float(jloss)) / float(jloss) < F32_TOL
    got, want = pspec.flatten(state["params"]), _flatten(jstate["params"])
    assert set(got) == set(want)
    zero = chip_smoke.zero_gradient_leaves(model)
    kept = sorted(set(got) - zero)
    g = np.concatenate([got[p].double().numpy().ravel() for p in kept])
    w = np.concatenate([np.asarray(want[p], np.float64).ravel() for p in kept])
    assert _rel(g, w) < F32_TOL
    for path in zero:
        for p in (got[path].double().numpy(), np.asarray(want[path], np.float64)):
            assert np.abs(p - p0[path].double().numpy()).max() <= lr * (1 + 1e-6), path
