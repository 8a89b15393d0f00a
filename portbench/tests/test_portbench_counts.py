"""The frozen flop and byte counts against hand counts, train_mfu's
arithmetic, and the readers' arithmetic on a made-up trace."""
import math
import sys
import types

import pytest

from portbench import costs, harness, trace
from portbench.tests.portbench_smoke import ROOT, bench


def reader(name):
    return harness.load_module("metrics", name)


def test_dense_flops_by_hand():
    cell = harness.load_cell(bench(), "qwen2.5-3b.train", ROOT)
    # per layer: q 2048*2048, k and v 2048*256 each, o 2048*2048, three MLP
    # matrices 2048*11008; the unembedding 151936*2048 (the embedding,
    # tied, in a product)
    params = 36 * (4_194_304 + 2 * 524_288 + 4_194_304 + 3 * 22_544_384) + 311_164_928
    attention = 6 * 36 * 16 * 128 * 1024
    assert harness.flops_per_token(cell) == 6 * params + attention == 18_967_166_976


def test_ssm_flops_by_hand():
    cell = harness.load_cell(bench(), "mamba2-780m.train", ROOT)
    # H = 48 heads of 64; per layer z, x 1536*3072 each, B, C 1536*128 each,
    # dt 1536*48, out 3072*1536; unembedding 50288*1536
    params = 48 * (2 * 4_718_592 + 2 * 196_608 + 73_728 + 4_718_592) + 77_242_368
    q_pairs = 257 / 2  # chunk 256: a token sees (Q + 1) / 2 keys of its chunk
    ssd = q_pairs * 2 * 128 + q_pairs * 2 * 48 * 64 + 4 * 128 * 48 * 64
    assert harness.flops_per_token(cell) == pytest.approx(6 * params + 3 * 48 * ssd, rel=1e-12)


def test_kernel_costs_by_hand():
    rms, swa = reader("rmsnorm_roofline"), reader("swa_attention_roofline")
    ops, nbytes = rms.cost((1, 1024, 2048), (2048,), 2)
    assert (ops, nbytes) == (5 * 2_097_152, 2 * 2_097_152 * 2 + 4 * 2048)
    # causal S = 4: 1 + 2 + 3 + 4 pairs; a window of 2: 1 + 2 + 2 + 2
    assert swa.pairs(4, 4, causal=True, window=None) == 10
    assert swa.pairs(4, 4, causal=True, window=2) == 7
    ops, nbytes = swa.cost(16, 1024, 1024, 128, 2, causal=True, window=None)
    assert ops == 4 * 128 * (1024 * 1025 // 2) * 16
    assert nbytes == 2 * 16 * 2048 * 128 * 2
    t = swa.least_seconds((16, 1024, 128), 1024, 2, True, None, 0)
    assert t == max(ops / 989e12, nbytes / 3.35e12)
    assert rms.least_seconds((1, 1024, 2048), (2048,), 2) == pytest.approx(
        (2 * 2_097_152 * 2 + 8192) / 3.35e12)


def test_train_mfu_arithmetic():
    cell = harness.load_cell(bench(), "qwen2.5-3b.train", ROOT)
    r0 = {"attempted": 50, "window_s": 25.0, "window_start_wall": 130.0}
    m = harness.end_to_end(cell, r0, t_start=100.0)
    tokens = 50 * 2 * 1024
    assert m["train_tokens_per_s"]["value"] == tokens / 25.0
    assert m["train_mfu"]["value"] == pytest.approx(
        100 * 18_967_166_976 * tokens / 25.0 / 989e12)
    assert m["setup_s"]["value"] == 30.0
    assert math.isclose(costs.mfu_percent(989e12, 1.0, 1), 100.0)


def test_device_readers_by_hand():
    """Two ranks' made-up traces: busy 0.9 s over 2 traced steps, a
    window of 4 steps of 0.6 s; 1e13 flops a step; one rmsnorm call whose
    kernels took twice its least time."""
    least = reader("rmsnorm_roofline").least_seconds((4, 2048), (2048,), 2)
    t = {"busy_s": 0.9, "steps": 2, "loop_s": 2.4, "step_ms": [600.0] * 4,
         "flops_per_step": 1e13, "kernel_calls": {"rmsnorm": [[[4, 2048], [2048], 2]]},
         "kernel_ms_by_name": {"void rmsnorm_kernel<bf16>": 2e3 * least, "gemm": 5.0}}
    traces = [t, dict(t)]
    assert reader("device_idle_share").read(traces) == pytest.approx(100 * (1 - 0.45 / 0.6))
    assert reader("busy_mfu").read(traces) == pytest.approx(100 * 2e13 / 0.9 / 989e12)
    assert reader("rmsnorm_roofline").read(traces) == pytest.approx(50.0)
    assert reader("swa_attention_roofline").read(traces) is None


def test_exchange_reader_by_hand():
    """The NCCL group's time a traced step, mean over ranks; silent where
    no rank traced an NCCL kernel (one card)."""
    a, b = {"groups_ms_per_step": {"exchange": 110.0, "gemm": 5.0}}, {
        "groups_ms_per_step": {"exchange": 120.0}}
    assert reader("exchange_ms").read([a, b]) == 115.0
    assert reader("exchange_ms").read([{"groups_ms_per_step": {"gemm": 5.0}}]) is None


def test_recording_patches_what_the_readers_declare(monkeypatch):
    """The traced window records each call of a declared entry point, the
    kernel's launch counter keeps counting on the original, and the entry
    point is restored after."""
    mod = types.ModuleType("fake_kernels")

    def kernel(x, *, scale=1):
        kernel.launches += 1
        return x * scale
    kernel.launches = 0
    mod.kernel = kernel
    monkeypatch.setitem(sys.modules, "fake_kernels", mod)
    rd = types.SimpleNamespace(ENTRY=("fake_kernels", "kernel"), KERNEL="fake",
                               describe=lambda x, *, scale=1: [x, scale])
    with trace.recording([rd]) as calls:
        assert mod.kernel(3, scale=2) == 6 and mod.kernel(5) == 5
    assert calls == {"fake": [[3, 2], [5, 1]]}
    assert mod.kernel is kernel and kernel.launches == 2


def test_each_roofline_reader_declares_a_kernel_of_the_program():
    for m in bench()["per_layer"]:
        if m["name"].endswith("_roofline"):
            r = reader(m["name"])
            assert r.ENTRY[0].startswith("repro_torch.kernels.") and r.KERNEL in r.ENTRY[1]
