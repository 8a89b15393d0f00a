"""The port's ResNet against repro.models.resnet at smoke size, from one JAX
init bridged through repro_torch.bridge.

* f32 (the reference's bf16 cast patched to f32, the port built with
  ``dtype=torch.float32``): conv, groupnorm, the residual block, logits and
  loss to a relative max error (max |port - ref| / max |ref|) below 1e-5
  (reached: below 4e-7), and the flat gradient buffer against ``jax.grad``
  flattened in the same key order below 1e-4 (reached: below 4e-7).
* bf16: logits within the reference's bf16 contract, relative max error
  below 0.08 (reached: 0.0044).

Depth 8 (the smoke config, n = 1) has no stacked ``stageK_rest`` blocks;
depth 14 (n = 2) adds them.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import repro.models.resnet as JR
from repro.checkpoint.store import _flatten
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.resnet110 import CONFIG as JCONFIG, ResNetConfig as JResNetConfig
from repro.configs.resnet110 import smoke_config as jax_smoke_config
from repro.models import spec as jspec
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.resnet110 import CONFIG, ResNetConfig, smoke_config
from repro_torch.engine.steps import value_and_flat_grad
from repro_torch.models import resnet as TR
from repro_torch.models import spec as tspec
from repro_torch.models.registry import build_model
from _torch_parity import patch_resnet_f32

F32_TOL = 1e-5
GRAD_TOL = 1e-4
DEPTHS = (8, 14)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _configs(depth):
    name = f"resnet{depth}-test"
    return (JResNetConfig(name=name, depth=depth, width=8),
            ResNetConfig(name=name, depth=depth, width=8))


@pytest.fixture(scope="module")
def jax_params():
    """One reference init per depth, shared by the module's tests."""
    return {d: JR.ResNetModel(_configs(d)[0]).init(jax.random.PRNGKey(d))
            for d in DEPTHS}


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, b).astype(np.int32))


# ------------------------------------------------------------ pieces ----
@pytest.mark.parametrize("size,stride,want", [(32, 1, (1, 1)), (32, 2, (0, 1)),
                                              (16, 2, (0, 1)), (33, 2, (1, 1)),
                                              (7, 1, (1, 1))])
def test_same_pads_follow_xla(size, stride, want):
    assert TR._same_pads(size, 3, stride) == want


@pytest.mark.parametrize("size,stride", [(32, 1), (32, 2), (16, 2), (8, 1)])
def test_conv_matches_reference(size, stride):
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((2, size, size, 4), dtype=np.float32)
    w = rng.standard_normal((3, 3, 4, 8), dtype=np.float32)
    want = np.asarray(JR.conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = TR.conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < F32_TOL


def test_stride2_conv_with_symmetric_padding_misses_reference():
    """The control: ``padding=1`` gives "SAME"'s output shape at stride 2
    but shifts every window, so the check above would catch it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 4), dtype=np.float32)
    w = rng.standard_normal((3, 3, 4, 8), dtype=np.float32)
    want = np.asarray(JR.conv(jnp.asarray(x), jnp.asarray(w), 2))
    wrong = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                     padding=1).permute(0, 2, 3, 1)
    assert tuple(wrong.shape) == want.shape
    assert rel_err(wrong, want) > 0.1


@pytest.mark.parametrize("c", [4, 8, 16, 32])
def test_groupnorm_matches_reference(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((3, 8, 8, c), dtype=np.float32) * 2 + 0.5
    scale = rng.standard_normal(c, dtype=np.float32)
    bias = rng.standard_normal(c, dtype=np.float32)
    want = JR.groupnorm(*(jnp.asarray(a) for a in (x, scale, bias)))
    got = TR.groupnorm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("stride,cin,cout", [(1, 8, 8), (2, 8, 16)])
def test_block_matches_reference(stride, cin, cout):
    """A residual block, option-A shortcut included when it downsamples."""
    specs = JR._block_specs(1, cin, cout)
    p = jspec.init_params(jax.random.PRNGKey(cin + cout), specs)
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    x = np.random.default_rng(1).standard_normal((2, 16, 16, cin), dtype=np.float32)
    jm = JR.ResNetModel(jax_smoke_config())
    tm = TR.ResNetModel(smoke_config(), torch.float32)
    want = jm._apply_block(p, jnp.asarray(x), stride)
    got = tm._apply_block({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                          torch.from_numpy(x), stride)
    assert tuple(got.shape) == want.shape == (2, 16 // stride, 16 // stride, cout)
    assert rel_err(got, want) < F32_TOL


# ------------------------------------------------------------- model ----
@pytest.mark.parametrize("depth", DEPTHS)
def test_apply_loss_and_grads_f32(depth, jax_params, monkeypatch):
    patch_resnet_f32(monkeypatch)
    jcfg, cfg = _configs(depth)
    jm, tm = JR.ResNetModel(jcfg), build_model(cfg, torch.float32)
    jp = jax_params[depth]
    tp = params_from_numpy(_flatten(jp), cfg, "cpu")
    images, labels = _batch(depth)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}

    want_logits = jax.jit(jm.apply)(jp, jbatch["images"])
    assert want_logits.dtype == jnp.float32  # the patch reached the reference
    got_logits = tm.apply(tp, torch.from_numpy(images))
    assert got_logits.dtype == torch.float32
    assert rel_err(got_logits, want_logits) < F32_TOL

    want_loss, want_grads = jax.jit(jax.value_and_grad(jm.loss))(jp, jbatch)
    got_loss, got_grads = value_and_flat_grad(
        tm, tp, {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)})
    assert abs(float(got_loss) - float(want_loss)) / abs(float(want_loss)) < F32_TOL
    flat_want = np.concatenate([g.reshape(-1) for g in _flatten(want_grads).values()])
    assert got_grads.shape == tp.flat.shape
    assert rel_err(got_grads, flat_want) < GRAD_TOL
    assert float(tm.accuracy(tp, {"images": images, "labels": labels})) == float(
        jm.accuracy(jp, jbatch))


@pytest.mark.parametrize("depth", DEPTHS)
def test_apply_bf16_within_contract(depth, jax_params):
    jcfg, cfg = _configs(depth)
    jm, tm = JR.ResNetModel(jcfg), build_model(cfg)
    jp = jax_params[depth]
    tp = params_from_numpy(_flatten(jp), cfg, "cpu")
    images, _ = _batch(depth + 100, b=8)
    want = jax.jit(jm.apply)(jp, jnp.asarray(images))
    got = tm.apply(tp, torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got, want) < 0.08


def test_bridge_is_an_identity_onto_flat_views(jax_params):
    jcfg, cfg = _configs(14)
    flat = _flatten(jax_params[14])
    tp = params_from_numpy(flat, cfg, "cpu")
    assert isinstance(tp, tspec.FlatTree) and tp.flat.dtype == torch.float32
    leaves = tspec.flatten(tp)
    assert list(leaves) == list(flat)  # the reference's key order
    off = 0
    for path, leaf in leaves.items():
        assert leaf.data_ptr() == tp.flat.data_ptr() + 4 * off
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(flat[path]))
        off += leaf.numel()
    assert off == tp.flat.numel()
    tp.flat.zero_()  # the leaves are views: they see the write
    assert not any(v.any() for v in leaves.values())


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_refuses_a_wrong_tree(fault, jax_params):
    _, cfg = _configs(8)
    flat = dict(_flatten(jax_params[8]))
    if fault == "missing":
        del flat["fc_b"]
    elif fault == "extra":
        flat["stage3_first/conv1"] = flat["fc_b"]
    else:
        flat["fc_b"] = np.zeros(11, np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        params_from_numpy(flat, cfg, "cpu")


def test_full_size_param_count_and_init():
    """ResNet-110 as the reference declares it: 1,727,962 f32 parameters,
    drawn into one flat buffer from an explicit generator."""
    model = build_model(CONFIG)
    assert tspec.n_params(model.param_specs()) == 1_727_962
    assert jspec.n_params(JR.ResNetModel(JCONFIG).param_specs()) == 1_727_962
    a = model.init(torch.Generator().manual_seed(0), "cpu")
    b = model.init(torch.Generator().manual_seed(0), "cpu")
    assert isinstance(a, tspec.FlatTree) and a.flat.numel() == 1_727_962
    assert torch.equal(a.flat, b.flat)
    assert {v.dtype for v in tspec.flatten(a).values()} == {torch.float32}
    assert a["stage2_rest"]["conv1"].shape == (17, 3, 3, 64, 64)
    assert bool((a["stem_s"] == 1).all()) and not a["fc_b"].any()


def test_config_is_a_copy_of_the_reference():
    import dataclasses
    for mine, theirs in ((CONFIG, JCONFIG), (smoke_config(), jax_smoke_config())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.n == theirs.n
    assert CONFIG.n == 18
    with pytest.raises(ValueError, match="6n\\+2"):
        ResNetConfig(depth=12).n
    # neither arch registry lists the ResNet
    assert not any("resnet" in a for a in ARCH_IDS + JAX_ARCH_IDS)
