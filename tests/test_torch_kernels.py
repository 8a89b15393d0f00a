"""The port's kernels module against the JAX reference: the plain PyTorch
versions (what the CPU path runs and what the CUDA kernels are held against)
match ``repro.kernels.ref`` and the Pallas kernels in interpret mode, on the
shape sweeps and tolerances of tests/test_kernels.py. The CUDA kernels
themselves are checked against the plain versions by the ``cuda`` tests
below, which run only on a machine with a GPU."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
]
RMS_CASES = [(4, 128, 512), (1, 7, 64), (300, 1024), (2, 2048)]


def _swa_inputs(bh, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d), dtype=np.float32) for _ in range(3)]


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


@pytest.mark.parametrize("call", ["rmsnorm", "swa_attention"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on CUDA tensors only; it never runs the
    plain version itself, and counts nothing when it refuses."""
    x = torch.zeros(2, 64, 32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if call == "rmsnorm":
            rms_kernel.rmsnorm(x, torch.zeros(32))
        else:
            swa_kernel.swa_attention(x, x, x)
    assert ops.launch_counts() == before


# ----------------------------------------------------------- on the GPU ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,window,causal",
                         SWA_CASES + [(2, 200, 80, None, True)])  # danube d=80
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
