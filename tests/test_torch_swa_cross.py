"""The swa_attention CUDA kernel (``csrc/swa_attention.cu``) on the card with
queries and keys of different lengths and queries at an offset, in both
dtype routes, against its plain version: the CPU parity cases of
tests/test_torch_kernels.py and whisper-base's shapes (its encoder's
self-attention over 1,500 frames, its decoder's cross-attention at the
448-token text context and at a decode step's one query row) and a
continuation at an offset that crosses key tiles with a window. Tolerances
are the reference's (tests/test_kernels.py): f32 2e-5, bf16 2e-2. This file
imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_swa_cross.py``. Every test
skips without a GPU."""
import pytest

torch = pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (bh, sq, sk, d, causal, window, q_offset)
CASES = [(2, 1, 1500, 64, False, None, 0), (2, 40, 1500, 64, False, None, 0),
         (1, 130, 70, 32, False, None, 0), (2, 20, 84, 64, True, None, 64),
         (2, 20, 84, 64, True, 16, 64), (1, 33, 50, 32, False, 24, 10),
         (32, 1500, 1500, 64, False, None, 0), (32, 448, 1500, 64, False, None, 0),
         (32, 1, 1500, 64, False, None, 0), (4, 100, 1124, 128, True, 300, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window,q_offset", CASES)
def test_swa_attention_cross_kernel_matches_plain(cuda, bh, sq, sk, d, causal,
                                                  window, q_offset, dtype):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32))
               .to(cuda, dtype) for n in (sq, sk, sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n = swa_kernel.swa_attention.launches
    got = swa_kernel.swa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert swa_kernel.swa_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.swa_attention_ref(q, k, v, **kw).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
