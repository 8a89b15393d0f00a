"""The routes of the rmsnorm CUDA kernel (``csrc/rmsnorm.cu``) on the card:
the main paths' widths and gated-norm shapes, the edges of each route, an
unaligned view, and the design the built library reports. This file
imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_rmsnorm_routes.py``. Every
test skips without a GPU; the plain versions' parity with the reference is
tests/test_torch_kernels.py's."""
import pytest

torch = pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# every norm of the main paths: [D] at decode (4 rows) and prefill (2,048
# rows) of d_model 1536 (mamba2-780m, qwen2-vl-2b), 2048 (qwen2.5-3b,
# qwen3-moe) and 4096 (jamba); the gated norms [B, S, H, 64] of mamba2
# (48 heads) and jamba (128 heads) at prefill and decode
MAIN_PATH = ([(rows, d) for rows in (4, 2048) for d in (1536, 2048, 4096)]
             + [(2, 1024, h, 64) for h in (48, 128)] + [(4, 1, h, 64) for h in (48, 128)])
# (d, dtype, route): each side of each route's edge: 32 and 33 vectors of
# 16 bytes (small, wide), 128 and 129 (a row within a warp, across a
# block's warps), 1024 and 1025 (the widest row the wide route holds),
# and a width that is no multiple of bf16's 8-element vector
EDGES = [(256, torch.bfloat16, "small"), (264, torch.bfloat16, "wide"),
         (128, torch.float32, "small"), (132, torch.float32, "wide"),
         (1024, torch.bfloat16, "wide"), (1032, torch.bfloat16, "wide"),
         (512, torch.float32, "wide"), (516, torch.float32, "wide"),
         (8192, torch.bfloat16, "wide"), (8200, torch.bfloat16, "general"),
         (4096, torch.float32, "wide"), (4100, torch.float32, "general"),
         (100, torch.bfloat16, "general"), (100, torch.float32, "small")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _inputs(shape, w_shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal(w_shape, dtype=np.float32) * 0.1).to(device)
    return x, w


def _check(x, w):
    n = rms_kernel.rmsnorm.launches
    got = rms_kernel.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_kernel.rmsnorm.launches == n + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = TOL[x.dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MAIN_PATH)
def test_rmsnorm_kernel_at_the_main_path_shapes(cuda, shape, dtype):
    x, w = _inputs(shape, shape[-2:] if len(shape) == 4 else shape[-1:], dtype, cuda,
                   sum(shape))
    _check(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,route", EDGES)
def test_rmsnorm_kernel_on_each_side_of_a_route_edge(cuda, d, dtype, route):
    assert rms_kernel.design(d, dtype)["route"] == route
    _check(*_inputs((3, d), (d,), dtype, cuda, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,offset", [(2048, 1), (64, 3), (1536, 2)])
def test_rmsnorm_kernel_on_an_unaligned_view(cuda, d, offset, dtype):
    """x a contiguous view at an element offset into a larger buffer: no
    longer 16-byte aligned, it takes the general route, one element a
    load, and gives the same function."""
    buf, w = _inputs((4 * d + offset,), (d,), dtype, cuda, d + offset)
    x = buf[offset:offset + 4 * d].view(4, d)
    assert x.data_ptr() % 16 != 0
    design = rms_kernel.design(d, dtype, aligned=False)
    assert design["route"] == "general" and design["load_bytes"] == x.element_size()
    _check(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 1536, 2048, 4096])
def test_rmsnorm_design_is_read_from_the_built_kernels(cuda, d, dtype):
    """The gated norm's d = 64 takes the small route (a power-of-two
    segment of lanes a row, one vector a lane, several rows a warp), the
    main paths' [D] norms the wide one (several vectors a lane, the fewest
    power-of-two lanes that hold the row); none spills to local memory."""
    per_vector = 16 // torch.tensor([], dtype=dtype).element_size()
    got = rms_kernel.design(d, dtype)
    assert got["local_bytes"] == 0 and 0 < got["registers"] <= 255
    assert got["load_bytes"] == 16
    if d == 64:
        assert got["route"] == "small" and got["vectors"] == 1
        assert got["lanes"] == d // per_vector and got["rows_per_warp"] == 32 // got["lanes"]
    else:
        assert got["route"] == "wide" and got["vectors"] > 1
        assert got["lanes"] * got["vectors"] * per_vector >= d
        assert (got["lanes"] // 2) * got["vectors"] * per_vector < d
    assert got["threads"] % 32 == 0 and got["threads"] >= min(got["lanes"], 32)
    assert rms_kernel.design(d, dtype, aligned=False)["route"] == "general"
