"""The port's kernels module against the JAX reference: the plain PyTorch
versions (what the CPU path runs and what the CUDA kernels are held against)
match ``repro.kernels.ref`` and the Pallas kernels in interpret mode, on the
shape sweeps and tolerances of tests/test_kernels.py. Attention with
queries and keys of different lengths (cross-attention) and queries at an
offset, which the Pallas kernel does not take, is held to the reference's
``chunked_attention`` (its XLA path) at the same tolerances: f32 2e-5, bf16
2e-2. The CUDA kernels themselves are checked against the plain versions by
the ``cuda`` tests below, which run only on a machine with a GPU."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _hypothesis_compat import given, settings, strategies as st

import repro.models.layers as JL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_update as sgd_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_kernel
from repro_torch.kernels import swa_attention as swa_kernel
from _torch_parity import DTYPES, as_f32, both


SWA_CASES = [
    (2, 256, 64, None, True),
    (2, 256, 64, 128, True),
    (1, 384, 128, 96, True),
    (3, 128, 128, None, False),
    (1, 130, 32, 64, True),          # ragged S
    (2, 64, 256, 32, True),          # gemma-style d=256
    (2, 1000, 128, None, True),      # ragged S at the prefill's D
    (2, 333, 80, 100, True),         # danube's D = 80, ragged S, a window
    (1, 64, 256, None, True),        # S within one tile at D = 256
]
# On the card only: many band-skipped tiles, a window that is a multiple
# of no tile (too slow for the reference's interpret mode on the CPU).
SWA_CUDA_ONLY = [(4, 2048, 128, 512, True), (2, 200, 80, None, True)]
# the reference's sweep, then the edges of csrc/rmsnorm.cu's routes: rows
# of 32 and 33 16-byte vectors (small and wide route) in bf16 (d = 256,
# 264) and f32 (128, 132), of 128 and 129 vectors (a row within a warp,
# a row across the warps of a block) in f32 (512, 516) and bf16 (1024,
# 1032), and of 1024 and 1025 vectors (wide and general route) in f32
# (4096, 4100) and bf16 (8192, 8200)
RMS_CASES = [(4, 128, 512), (1, 7, 64), (300, 1024), (2, 2048),
             (3, 256), (3, 264), (5, 128), (5, 132), (2, 516), (2, 1032),
             (2, 4100), (2, 8192), (2, 8200)]
# x [..., G, D] with a weight [G, D] (a gain per head: Mamba-2's gated norm
# of y [B, S, H, P]); mamba2-780m's decode shape (48 heads of 64), a
# smoke-size prefill shape, a width off the vector, jamba's 128 heads of 64
RMS_GROUPED_CASES = [(4, 1, 48, 64), (2, 9, 6, 16), (3, 5, 4, 100), (2, 3, 128, 64)]


# (bh, sq, sk, d, causal, window, q_offset): cross-attention and queries at
# an offset (the kernel at these and whisper-base's shapes:
# tests/test_torch_swa_cross.py, which the card's machine runs). whisper's decode step (one query row against its 1,500
# frames, 23 key tiles of 64 and one of 28), a ragged cross block, Sq > Sk,
# causal continuations at an offset with and without a window, and a
# non-causal window.
SWA_CROSS_CASES = [
    (2, 1, 1500, 64, False, None, 0),
    (2, 40, 1500, 64, False, None, 0),
    (1, 130, 70, 32, False, None, 0),
    (2, 20, 84, 64, True, None, 64),
    (2, 20, 84, 64, True, 16, 64),
    (1, 33, 50, 32, False, 24, 10),
]


def _swa_inputs(bh, s, d, seed, sk=None):
    """q [bh, s, d] and k, v [bh, sk, d] (sk = s when None)."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return [rng.standard_normal((bh, n, d), dtype=np.float32) for n in (s, sk, sk)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,window,causal", SWA_CASES)
def test_swa_attention_sweep(bh, s, d, window, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype)
                                    for a in _swa_inputs(bh, s, d, s + d))
    got = ops.swa_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_ref = jref.swa_attention_ref(jq, jk, jv, causal=causal, window=window)
    want_pallas = jops.swa_attention(jq, jk, jv, causal=causal, window=window,
                                     block_q=64, block_k=64, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def _to_bshd(x):  # [BH, S, D] -> [1, S, BH, D], chunked_attention's layout
    return jnp.transpose(x, (1, 0, 2))[None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window,q_offset", SWA_CROSS_CASES)
def test_swa_attention_cross_matches_reference(bh, sq, sk, d, causal, window,
                                               q_offset, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in
                                    _swa_inputs(bh, sq, d, sq + sk, sk))
    got = ops.swa_attention(tq, tk, tv, causal=causal, window=window,
                            q_offset=q_offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = JL.chunked_attention(_to_bshd(jq), _to_bshd(jk), _to_bshd(jv),
                                causal=causal, window=window, q_offset=q_offset)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want[0].transpose(1, 0, 2)),
                               rtol=tol, atol=tol)


def test_swa_attention_at_an_offset_is_the_tail_of_self_attention():
    """Queries at q_offset against the keys from 0 give the last rows of the
    self-attention over the whole sequence, bit for bit in f32."""
    q, k, v = (torch.from_numpy(a) for a in _swa_inputs(2, 96, 32, 7))
    whole = ops.swa_attention(q, k, v, window=40)
    tail = ops.swa_attention(q[:, 60:], k, v, window=40, q_offset=60)
    torch.testing.assert_close(tail, whole[:, 60:], rtol=0, atol=0)


@pytest.mark.parametrize("q_shape,kv_shape,window,q_offset,match", [
    ((2, 4, 32), (2, 6, 64), None, 0, r"\[BH, Sk, D\]"),   # head dims differ
    ((2, 4, 32), (3, 6, 32), None, 0, r"\[BH, Sk, D\]"),   # BH differs
    ((2, 4, 48), (2, 6, 48), None, 0, "head dim"),
    ((2, 4, 32), (2, 6, 32), 0, 0, "window"),
    ((2, 4, 32), (2, 6, 32), None, -1, "q_offset"),
    ((2, 4, 32), (2, 0, 32), None, 0, "no key"),
    ((2, 4, 32), (2, 6, 32), 2, 5, "no key"),             # the last row's band is past Sk
])
def test_swa_wrapper_checks_cross_attention_shapes(q_shape, kv_shape, window,
                                                   q_offset, match):
    """The kernel wrapper's shape checks: q [BH, Sq, D] and k, v
    [BH, Sk, D], and every query row sees a key. They run before the
    library loads, here on CPU tensors."""
    q, kv = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError, match=match):
        swa_kernel.check_shapes(q, kv, kv, window=window, q_offset=q_offset)
    with pytest.raises(ValueError, match=r"\[BH, Sk, D\]"):
        swa_kernel.check_shapes(q, kv, torch.zeros(2, 7, q_shape[-1]),
                                window=None, q_offset=0)
    ok_kv = torch.zeros(q_shape[0], 6, 32)
    swa_kernel.check_shapes(torch.zeros(q_shape[0], 4, 32), ok_kv, ok_kv,
                            window=3, q_offset=4)  # the last row sees key 5


@pytest.mark.parametrize("sq,sk,q_offset", [(4, 6, 0), (4, 4, 2)])
def test_swa_attention_gradient_refuses_cross_attention(sq, sk, q_offset):
    """The backward formula has no Sq != Sk or offset case: a call that
    wants a gradient raises, naming the ROADMAP item, and launches
    nothing; without grad the same call runs."""
    q = torch.zeros(2, sq, 32, requires_grad=True)
    kv = torch.zeros(2, sk, 32)
    before = ops.launch_counts()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.swa_attention(q, kv, kv, q_offset=q_offset)
    assert ops.launch_counts() == before
    with torch.no_grad():
        assert ops.swa_attention(q, kv, kv, q_offset=q_offset).shape == q.shape


def test_swa_window_blocks_are_skipped_semantically():
    """With a tiny window, far-away K must have zero influence."""
    q, k, v = (torch.from_numpy(a) for a in _swa_inputs(1, 256, 32, 1))
    base = ops.swa_attention(q, k, v, window=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, :128], v2[:, :128] = 99.0, -99.0
    pert = ops.swa_attention(q, k2, v2, window=16)
    np.testing.assert_allclose(pert[:, 192:].numpy(), base[:, 192:].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_CASES)
def test_rmsnorm_sweep(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    w = (rng.standard_normal(shape[-1], dtype=np.float32) * 0.1)
    (jx, tx), jw, tw = both(x, dtype), jnp.asarray(w), torch.from_numpy(w)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want_ref = jref.rmsnorm_ref(jx, jw)
    want_pallas = jops.rmsnorm(jx, jw, block_rows=128, interpret=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def test_rmsnorm_matches_model_layer():
    """The port's rmsnorm is a drop-in for repro.models.layers.rmsnorm."""
    from repro.models.layers import rmsnorm as layer_rmsnorm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 17, 256), dtype=np.float32)
    w = rng.standard_normal(256, dtype=np.float32) * 0.1
    np.testing.assert_allclose(
        ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(layer_rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_GROUPED_CASES)
def test_rmsnorm_with_a_weight_per_group(shape, dtype):
    """ops.rmsnorm with w [G, D] over x [..., G, D]: each row normalised
    over D and scaled by its group's gain, as the reference's plain
    versions broadcast it (repro.kernels.ref.rmsnorm_ref and
    repro.models.layers.rmsnorm, which mamba2's gated norm calls)."""
    from repro.models.layers import rmsnorm as layer_rmsnorm
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-2:], dtype=np.float32) * 0.1
    (jx, tx), jw, tw = both(x, dtype), jnp.asarray(w), torch.from_numpy(w)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jref.rmsnorm_ref(jx, jw), layer_rmsnorm(jx, jw)):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)
    # a different gain per group: group g alone equals the [D] call
    g = shape[-2] - 1
    np.testing.assert_array_equal(as_f32(got[..., g, :]),
                                  as_f32(ops.rmsnorm(tx[..., g, :].contiguous(), tw[g])))


@pytest.mark.parametrize("w_shape", [(65,), (3, 64), (4, 65), (1, 4, 64), (64, 4), ()])
def test_rmsnorm_kernel_refuses_a_weight_that_is_no_suffix_of_x(w_shape):
    """x [2, 5, 4, 64] takes w [64] or [4, 64]; any other shape is refused
    before the device is looked at, and nothing launches."""
    x, w = torch.zeros(2, 5, 4, 64), torch.zeros(w_shape)
    before = ops.launch_counts()
    with torch.no_grad(), pytest.raises(ValueError, match="do not match"):
        rms_kernel.rmsnorm(x, w)
    assert ops.launch_counts() == before


def _sgd_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n, dtype=np.float32) for _ in range(3)]


def _sgd_port(p, g, mu, lr, **kw):
    """The port's dispatch (the plain version on the CPU), in place on
    tensors made from the numpy inputs; -> (new_p, new_mu) as numpy."""
    tp, tg, tmu = (torch.from_numpy(a.copy()) for a in (p, g, mu))
    out_p, out_mu = ops.fused_sgd_update(tp, tg, tmu, lr, **kw)
    assert out_p is tp and out_mu is tmu  # updated in place
    return tp.numpy(), tmu.numpy()


def _assert_sgd_matches(got, want, atol=1e-5):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=atol)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 5000), lr=st.floats(1e-4, 1.0),
       momentum=st.floats(0.0, 0.99))
def test_fused_update_property(n, lr, momentum):
    p, g, mu = _sgd_inputs(n, n)
    got = _sgd_port(p, g, mu, lr, momentum=momentum)
    jp, jg, jmu = (jnp.asarray(a) for a in (p, g, mu))
    _assert_sgd_matches(got, jref.fused_sgd_update_ref(jp, jg, jmu, lr,
                                                       momentum=momentum))
    _assert_sgd_matches(got, jops.fused_sgd_update(jp, jg, jmu, lr,
                                                   momentum=momentum,
                                                   block=512, interpret=True))


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("n,block", [(65536, 65536), (100001, 4096), (7, 8)])
def test_fused_update_shapes(n, block, nesterov):
    p, g, mu = _sgd_inputs(n, 7)
    got = _sgd_port(p, g, mu, 0.1, nesterov=nesterov)
    jp, jg, jmu = (jnp.asarray(a) for a in (p, g, mu))
    _assert_sgd_matches(got, jref.fused_sgd_update_ref(jp, jg, jmu, 0.1,
                                                       nesterov=nesterov))
    _assert_sgd_matches(got, jops.fused_sgd_update(jp, jg, jmu, 0.1,
                                                   nesterov=nesterov,
                                                   block=block, interpret=True))


def test_fused_update_equals_sgd_optimizer_step():
    """The port's fused update over a flat buffer is a drop-in for the
    reference's per-leaf jnp SGD step."""
    from repro.optim.optimizers import sgd as jax_sgd
    opt = jax_sgd(momentum=0.9, weight_decay=1e-4)
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal(33, dtype=np.float32),
              "b": rng.standard_normal(17, dtype=np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    grads = jax.tree_util.tree_map(lambda x: x * 0.1, jparams)
    new_params, _ = opt.update(grads, opt.init(jparams), jparams, 0.05)

    flat_p = np.concatenate([params["a"], params["b"]])
    got_p, _ = _sgd_port(flat_p, flat_p * np.float32(0.1),
                         np.zeros_like(flat_p), 0.05,
                         momentum=0.9, weight_decay=1e-4)
    want_p = np.concatenate([new_params["a"], new_params["b"]])
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-6)


def test_fused_update_in_place_on_offset_views():
    """Views into larger buffers, at offsets that differ, are updated in
    place and nothing around them changes."""
    p, g, mu = _sgd_inputs(1001, 3)
    want = ref.fused_sgd_update_ref(*(torch.from_numpy(a) for a in (p, g, mu)), 0.1)
    bufs = [torch.zeros(1010) for _ in range(3)]
    views = [b[off:off + 1001] for b, off in zip(bufs, (1, 2, 5))]
    for v, a in zip(views, (p, g, mu)):
        v.copy_(torch.from_numpy(a))
    ops.fused_sgd_update(views[0], views[1], views[2], 0.1)
    torch.testing.assert_close(views[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(views[2], want[1], rtol=0, atol=0)
    for b, off in zip(bufs, (1, 2, 5)):
        assert not b[:off].any() and not b[off + 1001:].any()


def _call_wrapper(call, x, w):
    if call == "rmsnorm":
        return rms_kernel.rmsnorm(x, w)
    return swa_kernel.swa_attention(x, x, x)


@pytest.mark.parametrize("call,needs_grad", [("rmsnorm", "x"), ("rmsnorm", "w"),
                                             ("swa_attention", "x")])
def test_kernel_wrappers_refuse_inputs_that_require_grad(call, needs_grad):
    """The kernels have no backward: with grad mode on, an input that
    requires grad is refused (before the device check) rather than cut out
    of the graph; under no_grad the same inputs pass that check."""
    x, w = torch.zeros(2, 64, 32), torch.zeros(32)
    (x if needs_grad == "x" else w).requires_grad_()
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        _call_wrapper(call, x, w)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _call_wrapper(call, x, w)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("call", ["rmsnorm", "swa_attention"])
def test_plain_versions_still_give_gradients_on_cpu(call):
    """On CPU tensors ops.rmsnorm and ops.swa_attention run the plain
    versions, which autograd differentiates: the gradients of
    sum(out * cotangent) against jax.grad of the reference's plain
    versions, in f32."""
    rng = np.random.default_rng(4)
    if call == "rmsnorm":
        args = [rng.standard_normal((2, 8, 16), dtype=np.float32),
                rng.standard_normal(16, dtype=np.float32) * 0.1]
        port = lambda x, w: ops.rmsnorm(x, w)
        jax_fn = lambda x, w: jref.rmsnorm_ref(x, w)
    else:
        args = _swa_inputs(2, 12, 16, 4)
        port = lambda q, k, v: ops.swa_attention(q, k, v, window=5)
        jax_fn = lambda q, k, v: jref.swa_attention_ref(q, k, v, window=5)
    cot = rng.standard_normal(args[0].shape, dtype=np.float32)
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    (port(*tensors) * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda *a: (jax_fn(*a) * cot).sum(),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("call", ["rmsnorm", "swa_attention", "fused_sgd_update"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on CUDA tensors only; it never runs the
    plain version itself, and counts nothing when it refuses."""
    x = torch.zeros(2, 64, 32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if call == "rmsnorm":
            rms_kernel.rmsnorm(x, torch.zeros(32))
        elif call == "swa_attention":
            swa_kernel.swa_attention(x, x, x)
        else:
            sgd_kernel.fused_sgd_update(x[0, 0], x[0, 1], x[1, 0], 0.1)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype,d,error", [(torch.float16, 128, TypeError),
                                            (torch.bfloat16, 48, ValueError),
                                            (torch.float32, 512, ValueError)])
def test_swa_design_refuses_what_no_kernel_runs(dtype, d, error):
    """The design query checks dtype and head dim before it loads (and on
    a GPU machine builds) the library."""
    with pytest.raises(error):
        swa_kernel.design(dtype, d)


# ----------------------------------------------------------- on the GPU ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,window,causal", SWA_CASES + SWA_CUDA_ONLY)
def test_swa_attention_kernel_matches_plain(cuda, bh, s, d, window, causal,
                                            dtype):
    tdt = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _swa_inputs(bh, s, d, s + d))
    n = swa_kernel.swa_attention.launches
    got = swa_kernel.swa_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert swa_kernel.swa_attention.launches == n + 1
    want = ref.swa_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_swa_design_is_read_from_the_built_kernels(cuda, d):
    bf16 = swa_kernel.design(torch.bfloat16, d)
    assert bf16["kernel"] == "swa_attention_mma_kernel"
    # Q tile plus a K and a V tile per ring stage, rows padded to D + 8
    assert bf16["smem_bytes"] == (bf16["q_rows"] + 2 * bf16["stages"]
                                  * bf16["kv_keys"]) * (d + 8) * 2
    assert 0 < bf16["registers"] <= 255
    if d <= 128:
        assert bf16["local_bytes"] == 0
    f32 = swa_kernel.design(torch.float32, d)
    assert f32["kernel"] == "swa_attention_kernel" and f32["stages"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["rmsnorm", "swa_attention"])
def test_kernel_wrappers_refuse_grad_on_cuda(cuda, call):
    """Called directly, the wrapper refuses an input that requires grad and
    launches nothing; through kernels.ops the input goes to the autograd
    Function, which launches the kernel once (its forward runs with grad
    off) and gives a gradient."""
    x = torch.zeros(2, 64, 32, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(32, device=cuda).requires_grad_()
    if call == "swa_attention":
        x.requires_grad_()
    n = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        (rms_kernel.rmsnorm(x, w) if call == "rmsnorm"
         else swa_kernel.swa_attention(x, x, x))
    assert ops.launch_counts() == n
    out = ops.rmsnorm(x, w) if call == "rmsnorm" else ops.swa_attention(x, x, x)
    assert type(out.grad_fn).__name__ in ("_RMSNormBackward", "_SWAAttentionBackward")
    assert ops.launch_counts()[call] == n[call] + 1
    out.float().sum().backward()
    assert (w if call == "rmsnorm" else x).grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_CASES + [(3, 100)])  # width off the vector
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda, DTYPES[dtype][1])
    w = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32)
                         * 0.1).to(cuda)
    got = rms_kernel.rmsnorm(x, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(ref.rmsnorm_ref(x, w)),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_GROUPED_CASES + [(2, 1024, 48, 64), (2, 64, 128, 64)])
def test_rmsnorm_grouped_kernel_matches_plain(cuda, shape, dtype):
    """The [G, D] route at the gated norm's shapes (mamba2-780m's prefill,
    jamba's 128 heads of 64) against the plain version; one launch,
    counted as grouped."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda, DTYPES[dtype][1])
    w = torch.from_numpy(rng.standard_normal(shape[-2:], dtype=np.float32) * 0.1).to(cuda)
    n, grouped = rms_kernel.rmsnorm.launches, rms_kernel.rmsnorm.grouped_launches
    got = rms_kernel.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert (rms_kernel.rmsnorm.launches, rms_kernel.rmsnorm.grouped_launches) == (n + 1,
                                                                                 grouped + 1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(ref.rmsnorm_ref(x, w)),
                               rtol=tol, atol=tol)


def _sgd_kernel_vs_plain(views, nesterov):
    """Kernel on ``views`` (p, g, mu) against the plain version on copies."""
    p, g, mu = views
    want_p, want_mu = ref.fused_sgd_update_ref(p.clone(), g, mu.clone(), 0.1,
                                               nesterov=nesterov)
    n = sgd_kernel.fused_sgd_update.launches
    sgd_kernel.fused_sgd_update(p, g, mu, 0.1, nesterov=nesterov)
    torch.cuda.synchronize()
    assert sgd_kernel.fused_sgd_update.launches == n + 1
    for got, want in ((p, want_p), (mu, want_mu)):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("n", [1, 7, 4099, 65536, 100001, 1_727_962])
def test_fused_update_kernel_matches_plain(cuda, n, nesterov):
    views = [torch.from_numpy(a).to(cuda) for a in _sgd_inputs(n, n)]
    _sgd_kernel_vs_plain(views, nesterov)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1, 1), (1, 2, 3), (4, 4, 4)])
def test_fused_update_kernel_on_offset_views(cuda, offsets):
    """Views at a shared 4-byte offset (scalar head, vector body, scalar
    tail), at offsets that differ (all scalar) and 16-byte aligned."""
    n = 10_007
    bufs = [torch.from_numpy(a).to(cuda) for a in _sgd_inputs(n + 8, 5)]
    views = [b[o:o + n] for b, o in zip(bufs, offsets)]
    before = [b.clone() for b in bufs]
    _sgd_kernel_vs_plain(views, nesterov=False)
    for b, old, o in zip(bufs, before, offsets):
        assert torch.equal(b[:o], old[:o]) and torch.equal(b[o + n:], old[o + n:])
