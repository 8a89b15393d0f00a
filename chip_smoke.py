#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

1. builds the hand-written CUDA kernels from src/repro_torch/csrc (nvcc,
   sm_90a) and prints the build seconds and the compiler's register report;
2. prints the card's name and power limit (nvidia-smi);
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at the shape sweeps of
   tests/test_kernels.py, and times kernel, plain version and the PyTorch
   library call that computes the same function (yardstick only);
4. serve phase: qwen2.5-3b at full published width, random weights from a
   seeded CUDA generator, serve(batch=4, prompt_len=128, new_tokens=32);
   the rmsnorm kernel must run exactly 73 times per decode step;
5. prefill phase: make_prefill on a [2, 1024] prompt (36 swa_attention and
   73 rmsnorm launches), logits held against the same prefill through the
   plain versions, and against step-by-step decode over the same prompt;
   two faulty-cache controls show that the decode-vs-prefill gate fails
   when the cache is wrong.

Launch counts are set to 0 just before the serve and the prefill runs and
read just after. Any failed check raises, and the script exits non-zero.
The last two lines are the kernels' JSON line and the device line. It
exits non-zero, printing no result, when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.engine.steps import make_decode_step, make_prefill  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import spec as pspec  # noqa: E402
from repro_torch.models.registry import build_model, decode_window  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20

DEVICE = "cuda"
ARCH = "qwen2.5-3b"
SERVE = dict(batch=4, prompt_len=128, new_tokens=32)
PREFILL_SHAPE = (2, 1024)
TOL = {"rmsnorm": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "swa_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2}}
# tests/test_kernels.py sweeps, plus danube's head dim 80 and a width that
# is not a multiple of the 16-byte vector.
SWA_SWEEP = [(2, 256, 64, None, True), (2, 256, 64, 128, True),
             (1, 384, 128, 96, True), (3, 128, 128, None, False),
             (1, 130, 32, 64, True), (2, 64, 256, 32, True),
             (2, 200, 80, None, True)]
RMS_SWEEP = [(4, 128, 512), (1, 7, 64), (300, 1024), (2, 2048), (3, 100)]
# Decode against prefill at full depth with random weights: the logits
# have many near-ties, so bf16 noise alone flips some argmaxes (0.948
# agreement over [2, 1024] on an H100 at 700 W; kernels against plain
# versions, 0.954). The gate sits below that noise and far above the
# faulty controls (0.016 and 0.008 on the same card), which step the
# decoder over the first CONTROL_POSITIONS prompt tokens.
DECODE_AGREE_MIN = 0.90
CONTROL_POSITIONS = 128
CONTROL_FAULTS = ("pos_lag", "no_cache")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def time_ms(fn, arg_sets, iters: int = 50) -> float:
    """Time per call between CUDA events around back-to-back calls of
    fn(*args), cycling through arg_sets so that they do not all hit the L2
    cache. Includes whatever the host adds between launches."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, n: int) -> tuple[dict[str, float], int]:
    """Device time by kernel name (us) and the number of kernels over n
    calls of fn, from torch.profiler's CUDA events (one stream, so the
    kernels' times add up)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name, n_kernels


def device_ms(fn, arg_sets, iters: int = 20) -> float | None:
    """Summed device time of the kernels of one fn(*args) call."""
    it = iter(range(iters))
    by_name, n_kernels = kernel_times(
        lambda: fn(*arg_sets[next(it) % len(arg_sets)]), iters)
    return sum(by_name.values()) / iters / 1e3 if n_kernels else None


def copies(make, nbytes: int) -> list:
    """Enough independent input sets to exceed the L2 cache four times."""
    n = max(1, min(16, math.ceil(4 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions."""
    saved = ops.rmsnorm, ops.swa_attention
    ops.rmsnorm, ops.swa_attention = ref.rmsnorm_ref, ref.swa_attention_ref
    try:
        yield
    finally:
        ops.rmsnorm, ops.swa_attention = saved


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


# ---------------------------------------------------------------- kernels --
def rms_compare(gen, shape, dtype) -> float:
    x = randn(gen, shape, dtype)
    w = randn(gen, (shape[-1],), torch.float32, 0.1)
    got = rms_kernel.rmsnorm(x, w)
    want = ref.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["rmsnorm"][dtype]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"rmsnorm {shape} {dtype}: max abs err {err}")
    return err


def swa_compare(gen, bh, s, d, window, causal, dtype) -> float:
    q, k, v = (randn(gen, (bh, s, d), dtype) for _ in range(3))
    got = swa_kernel.swa_attention(q, k, v, causal=causal, window=window)
    want = ref.swa_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["swa_attention"][dtype]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"swa_attention {(bh, s, d, window, causal)} {dtype}: max abs err {err}")
    return err


def timings(kernel, plain, library, sets) -> dict:
    """Per call: the summed device time of its kernels (``*ms``, from the
    profiler; the CUDA-event time if the profiler saw no kernel) and the
    CUDA-event time of back-to-back calls, host gaps included
    (``*host_ms``)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        host = time_ms(fn, sets)
        dev = device_ms(fn, sets)
        out[f"{key}ms"] = host if dev is None else dev
        out[f"{key}host_ms"] = host
    return out


def bound(nbytes: int, n_ops: int, dtype) -> dict:
    """Least time on the card: bytes over HBM rate vs operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rms_timing(gen, rows, d, dtype) -> dict:
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * rows * d * elt + 4 * d
    def make():
        x, w = randn(gen, (rows, d), dtype), randn(gen, (d,), torch.float32, 0.1)
        return x, w, (1 + w).to(dtype)

    sets = copies(make, nbytes)
    return {
        "shape": [rows, d], "dtype": str(dtype).removeprefix("torch."),
        **timings(kernel=lambda x, w, g: rms_kernel.rmsnorm(x, w),
                  plain=lambda x, w, g: ref.rmsnorm_ref(x, w),
                  library=lambda x, w, g: F.rms_norm(x, (d,), g, 1e-6),
                  sets=sets),
        **bound(nbytes, 5 * rows * d, dtype),  # square, sum, scale, gain, cast
    }


def swa_timing(gen, bh, s, d, dtype, heads: int) -> dict:
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * s * d * elt
    sets = copies(lambda: tuple(randn(gen, (bh, s, d), dtype) for _ in range(3)),
                  nbytes)
    pairs = s * (s + 1) // 2  # causal, no window: the pairs this work needs
    b = bh // heads

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.view(b, heads, s, d), k.view(b, heads, s, d),
            v.view(b, heads, s, d), is_causal=True)

    return {
        "shape": [bh, s, d], "dtype": str(dtype).removeprefix("torch."),
        **timings(kernel=lambda q, k, v: swa_kernel.swa_attention(q, k, v),
                  plain=lambda q, k, v: ref.swa_attention_ref(q, k, v),
                  library=library, sets=sets),
        **bound(nbytes, 4 * d * pairs * bh, dtype),  # q.k and p.v, 2 each
    }


def kernel_phase(cfg) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    b, s = PREFILL_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    # main-path shapes: decode rows (batch 4), prefill rows, prefill attention
    rms_err = max(rms_compare(gen, (SERVE["batch"], cfg.d_model), bf16),
                  rms_compare(gen, (b * s, cfg.d_model), bf16))
    swa_err = swa_compare(gen, b * cfg.n_heads, s, cfg.d_head, None, True, bf16)
    swa_compare(gen, b * cfg.n_heads, s, cfg.d_head, None, True, f32)
    for dtype in (f32, bf16):
        for shape in RMS_SWEEP:
            rms_compare(gen, shape, dtype)
        for case in SWA_SWEEP:
            swa_compare(gen, *case, dtype)
    torch.cuda.synchronize()
    print(f"kernel phase: both kernels agree with their plain versions at "
          f"{len(RMS_SWEEP) * 2 + 2} rmsnorm and {len(SWA_SWEEP) * 2 + 2} "
          f"swa_attention shapes", flush=True)
    return {
        "rmsnorm": {"max_abs_err": rms_err,
                    "prefill": rms_timing(gen, b * s, cfg.d_model, bf16),
                    "decode": rms_timing(gen, SERVE["batch"], cfg.d_model, bf16)},
        "swa_attention": {"max_abs_err": swa_err,
                          "prefill": swa_timing(gen, b * cfg.n_heads, s,
                                                cfg.d_head, bf16, cfg.n_heads)},
    }


# ------------------------------------------------------------- main path --
def serve_phase(cfg, params) -> dict:
    # warm-up at a tiny length (cuBLAS handles, allocator), not counted
    serve(cfg, batch=SERVE["batch"], prompt_len=4, new_tokens=2,
          params=params, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, seconds, last = serve(cfg, params=params, device=DEVICE,
                                  return_logits=True, **SERVE)
    counts = ops.launch_counts()
    steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
    per_step = 2 * cfg.n_layers + 1
    out = {"batch": SERVE["batch"], "prompt_len": SERVE["prompt_len"],
           "new_tokens": SERVE["new_tokens"], "decode_steps": steps,
           "seconds": seconds,
           "tokens_per_s": SERVE["batch"] * SERVE["new_tokens"] / seconds,
           "decode_steps_per_s": steps / seconds,
           "rmsnorm_launches_per_step": counts["rmsnorm"] / steps,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts, "first_row": tokens[0, :8].tolist()}
    print("serve phase: " + json.dumps(out), flush=True)
    check(tokens.shape == (SERVE["batch"], SERVE["new_tokens"]),
          f"serve tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "serve tokens in the vocabulary")
    check(tuple(last.shape) == (SERVE["batch"], 1, cfg.vocab_size),
          f"serve last-step logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last).all()), "serve last-step logits finite")
    check(counts["rmsnorm"] == per_step * steps,
          f"rmsnorm launches {counts['rmsnorm']} != {per_step} x {steps} steps")
    check(counts["swa_attention"] == 0, "no swa_attention launch in decode")
    return out


def decode_vs_prefill(decode, model, params, tokens, logits, n: int,
                      fault: str | None = None) -> dict:
    """Step the decoder over the first n prompt tokens and compare each
    step's logits with the prefill's at that position.

    fault injects a cache fault from outside the model, as a control that
    the gate must catch: "pos_lag" passes pos t-1 at step t (each token
    overwrites the previous token's slot), "no_cache" zeroes the cache
    before every step (decode sees no history).
    """
    b = tokens.shape[0]
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("d", tokens.shape[1], b, "decode")), DEVICE)
    argmax, diff, finite = [], [], []
    for t in range(n):
        pos = max(t - 1, 0) if fault == "pos_lag" else t
        if fault == "no_cache":
            for c in cache.values():
                c.zero_()
        step, cache = decode(params, cache, {
            "tokens": tokens[:, t:t + 1],
            "pos": torch.full((b,), pos, dtype=torch.int32, device=DEVICE)})
        argmax.append(step[:, 0].argmax(-1))
        diff.append((step[:, 0] - logits[:, t]).abs().amax(-1))
        finite.append(torch.isfinite(step).all())
    diff = torch.stack(diff, 1)                                # [b, n]
    agree = torch.stack(argmax, 1) == logits[:, :n].argmax(-1)

    def stats(m: int) -> dict:
        """Over the first m positions."""
        scale = float(logits[:, :m].abs().max()) + 1e-6
        return {"positions": m, "rel_err_last": float(diff[:, m - 1].max()) / scale,
                "rel_err_all": float(diff[:, :m].max()) / scale,
                "argmax_agree": float(agree[:, :m].float().mean())}

    head = {"head": stats(CONTROL_POSITIONS)} if n > CONTROL_POSITIONS else {}
    return {**stats(n), **head, "finite": bool(torch.stack(finite).all()),
            "last_shape": list(step.shape)}


def decode_gate(r: dict) -> bool:
    """The decode-vs-prefill gate: relative max error below the bf16
    contract's 0.08 at the last and at every position, and argmax agreement
    at least DECODE_AGREE_MIN."""
    return (r["rel_err_last"] < 0.08 and r["rel_err_all"] < 0.08
            and r["argmax_agree"] >= DECODE_AGREE_MIN)


def prefill_phase(cfg, model, params) -> dict:
    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    window = decode_window(cfg, s)
    prefill = make_prefill(model, window=window, device=DEVICE)
    prefill(params, {"tokens": tokens[:, :64]})  # warm-up, not counted
    ops.reset_launch_counts()
    t0 = sync_time()
    logits = prefill(params, {"tokens": tokens})
    seconds = sync_time() - t0
    counts = ops.launch_counts()
    # the same prefill through the plain versions
    with plain_versions():
        plain = prefill(params, {"tokens": tokens})
    err_plain = rel_err(logits, plain)
    agree_plain = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain

    # step-by-step decode over the same prompt, then the faulty controls
    decode = make_decode_step(model, window=window, device=DEVICE)
    sound = decode_vs_prefill(decode, model, params, tokens, logits, s)
    controls = {f: decode_vs_prefill(decode, model, params, tokens, logits,
                                     CONTROL_POSITIONS, fault=f)
                for f in CONTROL_FAULTS}

    out = {"shape": [b, s], "seconds": seconds, "tokens_per_s": b * s / seconds,
           "launches": counts, "rel_err_vs_plain": err_plain,
           "argmax_agree_vs_plain": agree_plain,
           "decode_vs_prefill": sound,
           "decode_vs_prefill_faulty_controls": controls}
    print("prefill phase: " + json.dumps(out), flush=True)
    check(counts == {"rmsnorm": 2 * cfg.n_layers + 1,
                     "swa_attention": cfg.n_layers},
          f"prefill launches {counts}")
    check(logits.shape == (b, s, cfg.vocab_size), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    check(sound["last_shape"] == [b, 1, cfg.vocab_size],
          f"decode logits {sound['last_shape']}")
    check(sound["finite"], "decode logits finite at every step")
    # bf16 serving contract of tests/test_decode_consistency.py
    check(err_plain < 0.08 and agree_plain > 0.95,
          f"kernels vs plain prefill: rel err {err_plain}, argmax {agree_plain}")
    check(decode_gate(sound) and decode_gate(sound["head"]),
          f"decode vs prefill: {sound}")
    # each half of the gate on its own must fail each faulty control
    for fault, r in controls.items():
        check(r["argmax_agree"] < DECODE_AGREE_MIN and r["rel_err_all"] >= 0.08,
              f"decode vs prefill gate passed the faulty control {fault}: {r}")
    return out


def device_profile(fn, n: int) -> dict:
    """Wall time per call of fn without the profiler, then device busy time
    and kernel time by name with it; the idle share is 1 - busy / wall."""
    fn()
    t0 = sync_time()
    for _ in range(n):
        fn()
    wall_us = 1e6 * (sync_time() - t0)
    by_name, n_kernels = kernel_times(fn, n)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": n, "wall_ms_per_call": wall_us / n / 1e3,
            "device_busy_ms_per_call": busy_us / n / 1e3 if n_kernels else None,
            "device_idle_share": 1 - busy_us / wall_us if n_kernels else None,
            "kernels_per_call": n_kernels / n,
            "top_kernels_ms_per_call": {k[:60]: v / n / 1e3 for k, v in top}}


def profile_phase(cfg, model, params) -> dict:
    """Where a decode step's and a prefill's time goes (not counted)."""
    b = SERVE["batch"]
    decode = make_decode_step(model, device=DEVICE)
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("p", SERVE["prompt_len"], b, "decode")), DEVICE)
    batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=DEVICE),
             "pos": torch.full((b,), SERVE["prompt_len"] // 2, dtype=torch.int32,
                               device=DEVICE)}
    tokens = torch.zeros(PREFILL_SHAPE, dtype=torch.int32, device=DEVICE)
    prefill = make_prefill(model, device=DEVICE)
    out = {"decode_step": device_profile(lambda: decode(params, cache, batch), 8),
           "prefill": device_profile(lambda: prefill(params, {"tokens": tokens}), 2)}
    print("profile phase: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 lm_logits in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for name in build.SOURCES:
        log = build.BUILD_DIR / f"{name}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = get_config(ARCH)
    kernels = kernel_phase(cfg)

    model = build_model(cfg)
    t0 = sync_time()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    print(f"{ARCH}: {cfg.param_count() / 1e9:.3f} B parameters drawn in "
          f"{sync_time() - t0:.1f} s", flush=True)
    served = serve_phase(cfg, params)
    prefilled = prefill_phase(cfg, model, params)
    profile_phase(cfg, model, params)

    tpu = {"rmsnorm": "src/repro/kernels/rmsnorm.py:25",
           "swa_attention": "src/repro/kernels/swa_attention.py:81"}
    entries = []
    for name, k in kernels.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": tpu[name], "tpu_counterpart": f"{tpu[name]} {name}",
            "launches": served["launches"][name] + prefilled["launches"][name],
            "launches_per_decode_step": served["launches"][name] / served["decode_steps"],
            "launches_per_prefill": prefilled["launches"][name],
            "max_abs_err": k["max_abs_err"],
            **k["prefill"], "kernel_ms": k["prefill"]["ms"],  # the issue's name
            **({"at_decode": k["decode"]} if "decode" in k else {})})
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never launched on the main path")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
