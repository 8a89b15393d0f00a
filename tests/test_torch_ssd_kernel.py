"""Mamba-2's chunked SSD: the CUDA kernels of ``csrc/ssd.cu`` behind
``kernels.ops.ssd``, and its CPU and meta routes.

On the card (``cuda`` marker, skipped without a GPU; this file imports no
JAX, so the card's machine runs it: ``python -m pytest -q -m cuda
tests/test_torch_ssd_kernel.py``): the output and the gradients of all
five inputs at the shapes the port runs, in bf16 and f32, against the
plain version (``kernels.ref.ssd``) run in float64 on the card, twice:
from the unrounded float64 inputs, and from the inputs as rounded to the
run's dtypes (x, B, C and the cotangent in bf16 or f32, dt and dA in
f32). Against the second, the rounding of the inputs cancels and only
each version's own arithmetic is left, so a kernel that rounded an f32
intermediate to bf16 shows there. Limits, against each of the two, set
before the first run: in bf16 the kernels' relative L2 error on each
tensor is at most 1.5 times the plain bf16 version's own error against
the same float64 result (the kernels keep the plain version's casts
forward and compute the backward in f32, so their error should not pass
the plain version's); in f32 it is at most 1e-5, or 1.5 times the plain
f32 version's own error where that is larger (sums of up to 256 f32
terms, and ddA a reverse cumsum of differences, can leave more than 1e-5
in either version).

On the CPU: the route is the plain version, bit for bit the code it
replaced, with autograd through its ops; the meta route charges
``ssd_cost``; the mixer of both SSM families goes through ``ops.ssd``.
"""
import pytest

torch = pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models.layers import NO_SHARD  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.spec import init_params  # noqa: E402
from repro_torch.models.transformer import _layer_params  # noqa: E402

NAMES = ("y", "dxin", "dBm", "dCm", "ddt", "ddA")
# (name, B, S, H, N, chunk, regime): mamba2-780m's train shape, jamba-v0.1-52b's
# mixer at its [2, 1024] prefill, a short last chunk (2,000 = 7 x 256 +
# 208) and a sequence below one chunk, at Mamba-2's published init; and
# the train shape at the models' own init (A_log and dt_bias zero)
CARD_CASES = [("mamba2_train", 2, 2048, 48, 128, 256, "published"),
              ("jamba_prefill", 2, 1024, 128, 16, 256, "published"),
              ("short_last_chunk", 1, 2000, 48, 128, 256, "published"),
              ("below_one_chunk", 2, 100, 48, 128, 256, "published"),
              ("mamba2_train_zero_init", 2, 2048, 48, 128, 256, "zero")]
BF16_FACTOR = 1.5
F32_LIMIT = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _inputs(b, s, h, n, seed, device, regime="published"):
    """f64 inputs at the scales the models feed the SSD: unit-normal x, B,
    C; at Mamba-2's published init dt log-uniform in [1e-3, 1e-1] and A in
    [1, 16]; at the models' own (``zero``: A_log and dt_bias 0) A = 1 and
    dt = softplus of a unit normal, so that a chunk's cumsum runs to ~-180
    and most of its decays underflow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, 64))
    B = rng.standard_normal((b, s, n))
    C = rng.standard_normal((b, s, n))
    if regime == "zero":
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
        a = -np.ones((h,))
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
        a = -rng.uniform(1.0, 16.0, (h,))
    dy = rng.standard_normal((b, s, h, 64))
    return [torch.from_numpy(v).to(device) for v in (x, B, C, dt, dt * a, dy)]


def _run(fn, inputs, dtype, chunk):
    """fn's output and the gradients of its five inputs for the cotangent,
    as f64: x, B, C in ``dtype`` (f64 stays f64), dt and dA f32 (f64)."""
    *args, dy = inputs
    small = torch.float32 if dtype != torch.float64 else torch.float64
    leaves = [t.to(dtype if i < 3 else small).requires_grad_() for i, t in enumerate(args)]
    y = fn(*leaves, chunk)
    grads = torch.autograd.grad(y, leaves, dy.to(y.dtype))
    return [t.detach().double() for t in (y, *grads)], y


def _rounded(inputs, dtype):
    """The f64 inputs as the run in ``dtype`` sees them, back in f64: x, B,
    C and the cotangent rounded to ``dtype``, dt and dA to f32."""
    x, B, C, dt, dA, dy = inputs
    return [t.to(dtype).double() for t in (x, B, C)] + \
        [t.float().double() for t in (dt, dA)] + [dy.to(dtype).double()]


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_ssd_kernels_against_float64(cuda, case, dtype):
    _, b, s, h, n, chunk, regime = case
    inputs = _inputs(b, s, h, n, seed=b * s + h, device=cuda, regime=regime)
    wants = {"unrounded": _run(ref.ssd, inputs, torch.float64, chunk)[0],
             "rounded": _run(ref.ssd, _rounded(inputs, dtype), torch.float64, chunk)[0]}
    plain, _ = _run(ref.ssd, inputs, dtype, chunk)
    before = ops.launch_counts()
    got, y = _run(ops.ssd, inputs, dtype, chunk)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    assert 0 < after["ssd"] - before["ssd"] <= 4
    assert 0 < after["ssd_backward"] - before["ssd_backward"] <= 6
    errs = {}
    for ref_name, want in wants.items():
        for name, g, p, w in zip(NAMES, got, plain, want):
            assert torch.isfinite(g).all(), name
            k, pl = _rel(g, w), _rel(p, w)
            limit = BF16_FACTOR * pl if dtype == torch.bfloat16 else max(F32_LIMIT,
                                                                          BF16_FACTOR * pl)
            errs[f"{name}.{ref_name}"] = (k, pl, limit)
    print(case[0], dtype, {k: tuple(f"{v:.3g}" for v in e) for k, e in errs.items()})
    bad = {k: e for k, e in errs.items() if not e[0] <= e[2]}
    assert not bad, bad


@pytest.mark.cuda
def test_ssd_kernels_repeat_bit_for_bit_and_raise_on_what_they_do_not_take(cuda):
    x, B, C, dt, dA, dy = _inputs(1, 300, 4, 16, seed=3, device=cuda)
    args = [x.bfloat16(), B.bfloat16(), C.bfloat16(), dt.float(), dA.float()]
    one = ssd_kernel.ssd_forward(*args, 128)
    two = ssd_kernel.ssd_forward(*args, 128)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    g1 = ssd_kernel.ssd_backward(dy.bfloat16(), *args, *one[1:], 128)
    g2 = ssd_kernel.ssd_backward(dy.bfloat16(), *args, *one[1:], 128)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with pytest.raises(ValueError, match="chunks"):
        ops.ssd(*args, 512)
    with pytest.raises(ValueError, match="N in"):
        ops.ssd(args[0], args[1][..., :12], args[2][..., :12], *args[3:], 128)
    with pytest.raises(TypeError, match="f32 dt"):
        ops.ssd(*args[:3], dt.bfloat16(), args[4], 128)
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd(args[0].float(), *args[1:], 128)
    torch.cuda.synchronize()


# ------------------------------------------------------------------ CPU --
def _plain_before_the_kernels(xin, Bm, Cm, dt, dA, chunk):
    """The SSD as models.mamba2 held it before the kernels, verbatim: the
    CPU route must keep its bits."""
    def chunk_fn(h, xc, Bc, Cc, dtc, dAc, dt_):
        Q = xc.shape[1]
        cs = torch.cumsum(dAc, dim=1)
        CB = torch.einsum("bin,bjn->bij", Cc.float(), Bc.float())
        diff = cs[:, :, None, :] - cs[:, None, :, :]
        mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
        decay = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
        M = CB[:, :, :, None] * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", M.to(dt_), xc)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc.float(), h)
        y_inter = y_inter * torch.exp(cs)[:, :, :, None]
        w = torch.exp(cs[:, -1:, :] - cs) * dtc
        dh = torch.einsum("bjh,bjn,bjhp->bhpn", w, Bc.float(), xc.float())
        h = h * torch.exp(cs[:, -1])[:, :, None, None] + dh
        return h, (y_intra.float() + y_inter).to(dt_)

    B_, S, H, P = xin.shape
    Q = min(chunk, S)
    h = xin.new_zeros((B_, H, P, Bm.shape[-1]), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, Q):
        c1 = min(S, c0 + Q)
        h, y = chunk_fn(h, xin[:, c0:c1], Bm[:, c0:c1], Cm[:, c0:c1],
                        dt[:, c0:c1], dA[:, c0:c1], xin.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("S,chunk", [(40, 16), (16, 16), (7, 4), (5, 8)])
@pytest.mark.parametrize("fn", [ops.ssd, m2.ssd], ids=["ops", "mamba2"])
def test_cpu_route_is_the_plain_version_bit_for_bit(fn, S, chunk, dtype):
    inputs = _inputs(2, S, 3, 8, seed=S, device="cpu")
    want, yw = _run(_plain_before_the_kernels, inputs, dtype, chunk)
    got, yg = _run(fn, inputs, dtype, chunk)
    assert yg.dtype == yw.dtype == dtype and "_SSD" not in type(yg.grad_fn).__name__
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("S,chunk", [(2048, 256), (2000, 256), (100, 256)])
def test_meta_route_returns_the_shape_and_charges_ssd_cost(S, chunk, grad):
    b, h, n = 2, 48, 128
    x = torch.empty((b, S, h, 64), dtype=torch.bfloat16, device="meta", requires_grad=grad)
    B, C = (torch.empty((b, S, n), dtype=torch.bfloat16, device="meta") for _ in range(2))
    dt, dA = (torch.empty((b, S, h), device="meta") for _ in range(2))
    with ops.counting_kernel_costs() as rec:
        y = ops.ssd(x, B, C, dt, dA, chunk)
        assert y.shape == x.shape and y.dtype == x.dtype and y.device.type == "meta"
        if grad:
            y.sum().backward()
            assert x.grad.shape == x.shape
    fwd = ops.ssd_cost(b, S, h, 64, n, chunk, 2)
    bwd = ops.ssd_cost(b, S, h, 64, n, chunk, 2, backward=True)
    want = (fwd[0] + bwd[0], fwd[1] + bwd[1]) if grad else fwd
    assert rec["calls"] == ({"ssd": 1, "ssd_backward": 1} if grad else {"ssd": 1})
    assert (rec["flops"], rec["bytes"]) == pytest.approx(want, rel=1e-12)


def test_ssd_cost_counts_the_causal_pairs_of_each_chunk():
    # one chunk of 4 rows: 10 pairs; S 6 at chunk 4: 10 + 3 pairs
    b, h, p, n = 1, 2, 64, 16
    state = 2.0 * 6 * n * h * p
    ops_, nbytes = ops.ssd_cost(b, 6, h, p, n, 4, 2)
    assert ops_ == 2.0 * 13 * n + 2.0 * 13 * h * p + 2 * state
    assert nbytes == 6 * (2 * h * p * 2 + 2 * n * 2 + 2 * h * 4)
    ops_b, bytes_b = ops.ssd_cost(b, 6, h, p, n, 4, 2, backward=True)
    assert ops_b == 3 * 2.0 * 13 * n + 2 * 2.0 * 13 * h * p + 5 * state
    assert bytes_b == 6 * (3 * h * p * 2 + 4 * n * 2 + 4 * h * 4)


def _counting_ssd(monkeypatch):
    calls = []
    real = ops.ssd

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(ops, "ssd", counted)
    return calls


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_every_mixer_goes_through_ops_ssd(monkeypatch, arch):
    """A forward of the whole model calls ops.ssd once a Mamba layer: every
    layer of mamba2, all but the attention layer of each jamba block."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    calls = _counting_ssd(monkeypatch)
    logits, _ = model.forward(params, {"tokens": tokens})
    assert torch.isfinite(logits).all()
    mixers = cfg.n_layers - (cfg.n_layers // cfg.attn_every if arch.startswith("jamba") else 0)
    assert calls == [(2, 20, cfg.n_ssm_heads, cfg.ssm_headdim)] * mixers


def test_mamba_mixer_calls_ops_ssd_once(monkeypatch):
    cfg = get_smoke_config("mamba2-780m")
    p = _layer_params(init_params(torch.Generator().manual_seed(1),
                                  m2.mamba_specs(cfg, 1), "cpu"), 0)
    x = torch.randn((2, 9, cfg.d_model), generator=torch.Generator().manual_seed(2))
    calls = _counting_ssd(monkeypatch)
    out = m2.mamba_mixer(cfg, p, x, NO_SHARD)
    assert out.shape == x.shape and calls == [(2, 9, cfg.n_ssm_heads, cfg.ssm_headdim)]
