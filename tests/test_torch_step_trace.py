"""The port's step tracer (``repro_torch.core.telemetry``: ``StepTracer``,
``span``, ``count``, ``tracing``) and its spans inside the train step, on
the CPU; one test on the card holds the spans' clock to the kernels'.

* Off (no tracer installed), ``span()`` is the shared ``NULL_SPAN``, a
  train step reads no clock of the tracer, enters no profiler range and
  synchronises nothing, and an uninstalled tracer records nothing.
* Nested spans carry their parent, step and thread, with ordered times;
  a span opened on another thread takes the home thread's innermost
  span as its parent.
* One train step of the two-layer smoke configs of qwen2.5-3b and
  mamba2-780m at ``microbatches=2`` opens each ``train.*`` span as often
  as the step does the work, and each backward formula once a call, under
  ``train.backward``; tracing changes no bit of the loss, the flat
  gradient or the update.
* Under the CPU profiler a span's stamps agree with its own
  ``record_function`` range within 200 µs.
* On four gloo ranks the exchange is one span a step and its counters
  hold the flat buffer's bytes.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import threading
import time
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import telemetry
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import (init_train_state, make_train_step,
                                      value_and_flat_grad)
from repro_torch.launch.explicit_allreduce import spawn
from repro_torch.launch.mesh import init_data_group
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw

ARCHS = ("qwen2.5-3b", "mamba2-780m")
STEP_SPANS = {"train.step": 1, "train.stage": 1, "train.microbatch": 2,
              "train.forward": 2, "train.backward": 2, "train.update": 1}
WORLD, TIMEOUT_S = 4, 120.0


def _job(arch: str, seed: int = 0):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32)
    state = init_train_state(model, adamw(), torch.Generator().manual_seed(seed),
                             device="cpu")
    batch = TokenStream(cfg.vocab_size, 16, seed=1).batch(0, 4)
    return cfg, model, state, batch


def _names(snap: dict) -> Counter:
    return Counter(s["name"] for s in snap["spans"])


class _Raises:
    def __init__(self, what: str):
        self.what = what

    def __call__(self, *a, **k):
        raise AssertionError(f"{self.what} called with tracing off")

    def __getattr__(self, name):
        return _Raises(f"{self.what}.{name}")


# ------------------------------------------------------------- off path --
def test_off_path_reads_no_clock_enters_no_range_and_records_nothing(monkeypatch):
    assert telemetry._TRACER is None
    assert telemetry.span("train.step") is telemetry.NULL_SPAN
    assert telemetry.span("anything") is telemetry.span("else")
    idle = telemetry.StepTracer()  # made, never installed
    _, model, state, batch = _job("qwen2.5-3b")
    step = make_train_step(model, adamw(), microbatches=2, device="cpu")
    monkeypatch.setattr(telemetry, "time", _Raises("time"))
    monkeypatch.setattr(torch.profiler, "record_function", _Raises("record_function"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Raises("record_function"))
    monkeypatch.setattr(torch.cuda, "synchronize", _Raises("torch.cuda.synchronize"))
    with telemetry.NULL_SPAN as s:
        assert s is None
    telemetry.count("train.tokens", 5)
    state, loss = step(state, batch, 1e-3)
    assert torch.isfinite(loss)
    assert idle.snapshot()["spans"] == [] and idle.registry.counters() == {}


def test_tracing_restores_the_tracer_it_found():
    outer, inner = telemetry.StepTracer(), telemetry.StepTracer()
    with telemetry.tracing(outer):
        with telemetry.tracing(inner):
            with telemetry.span("a"):
                pass
        with telemetry.span("b"):
            pass
    assert telemetry._TRACER is None
    assert [s["name"] for s in inner.snapshot()["spans"]] == ["a"]
    assert [s["name"] for s in outer.snapshot()["spans"]] == ["b"]


# -------------------------------------------------------------- records --
def test_nested_spans_carry_parent_step_thread_and_ordered_times():
    tracer = telemetry.StepTracer()
    with telemetry.tracing(tracer):
        with telemetry.span("outside"):
            pass
        with telemetry.span("train.step") as step:
            with telemetry.span("train.microbatch") as mb:
                with telemetry.span("train.forward") as fwd:
                    telemetry.count("train.tokens", 7)
            telemetry.count("train.tokens", 3)
    snap = tracer.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    me = threading.get_native_id()
    assert snap["owner"] == me and snap["counters"] == {"train.tokens": 10}
    assert by["outside"]["parent"] is None and by["outside"]["step"] is None
    assert by["train.step"]["parent"] is None and by["train.step"]["step"] == step.id
    assert by["train.microbatch"]["parent"] == step.id
    assert by["train.forward"]["parent"] == mb.id
    assert all(s["step"] == step.id for n, s in by.items() if n != "outside")
    assert all(s["thread"] == me for s in by.values())
    assert (step.start_ns <= mb.start_ns <= fwd.start_ns <= fwd.end_ns
            <= mb.end_ns <= step.end_ns)
    assert by["outside"]["end_ns"] <= step.start_ns


def test_a_span_on_another_thread_takes_the_home_threads_innermost_parent():
    tracer = telemetry.StepTracer()
    seen = {}

    def worker():
        with telemetry.span("kernels.rmsnorm.backward") as s:
            with telemetry.span("inner") as t:
                seen.update(s=s, t=t, thread=threading.get_native_id())

    with telemetry.tracing(tracer):
        with telemetry.span("train.step") as step:
            with telemetry.span("train.backward") as bwd:
                th = threading.Thread(target=worker)
                th.start()
                th.join()
    assert seen["s"].parent == bwd.id and seen["s"].step == step.id
    assert seen["t"].parent == seen["s"].id
    assert seen["s"].thread == seen["thread"] != step.thread


def test_the_span_list_is_bounded_and_flush_starts_afresh():
    tracer = telemetry.StepTracer(max_spans=3)
    with telemetry.tracing(tracer):
        for _ in range(5):
            with telemetry.span("x"):
                telemetry.count("n")
        snap = tracer.flush()
        with telemetry.span("y"):
            pass
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2 and snap["counters"] == {"n": 5}
    again = tracer.snapshot()
    assert [s["name"] for s in again["spans"]] == ["y"] and again["counters"] == {}


def test_chrome_trace_holds_every_span_and_the_counters(tmp_path):
    import json

    tracer = telemetry.StepTracer()
    with telemetry.tracing(tracer):
        with telemetry.span("train.step"):
            with telemetry.span("train.update"):
                telemetry.count("train.tokens", 4)
    path = tmp_path / "spans.json"
    tracer.write_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    spans = {s["name"]: s for s in tracer.snapshot()["spans"]}
    events = {e["name"]: e for e in doc["traceEvents"]}
    assert set(events) == set(spans)
    for name, e in events.items():
        assert e["ph"] == "X" and e["ts"] == spans[name]["start_ns"] / 1e3
        assert e["dur"] == (spans[name]["end_ns"] - spans[name]["start_ns"]) / 1e3
    assert doc["otherData"]["counters"] == {"train.tokens": 4}


# -------------------------------------------------------- the train step --
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_opens_each_span_as_often_as_it_does_the_work(arch):
    cfg, model, state, batch = _job(arch)
    step = make_train_step(model, adamw(), microbatches=2, device="cpu")
    step(state, batch, 1e-3)  # a first step outside the tracer
    tracer = telemetry.StepTracer()
    with telemetry.tracing(tracer):
        step(state, batch, 1e-3)
    snap = tracer.snapshot()
    names = _names(snap)
    n = cfg.n_layers
    want = {**STEP_SPANS, "kernels.rmsnorm.backward": 2 * (2 * n + 1)}
    if cfg.family == "dense":
        want["kernels.swa_attention.backward"] = 2 * n
    assert dict(names) == want
    by_id = {s["id"]: s for s in snap["spans"]}
    (step_span,) = (s for s in snap["spans"] if s["name"] == "train.step")
    assert all(s["step"] == step_span["id"] for s in snap["spans"])
    for s in snap["spans"]:
        if s["name"].startswith("kernels."):
            assert by_id[s["parent"]]["name"] == "train.backward"
        for child, parent in (("train.forward", "train.microbatch"),
                              ("train.backward", "train.microbatch"),
                              ("train.microbatch", "train.step"),
                              ("train.update", "train.step")):
            if s["name"] == child:
                assert by_id[s["parent"]]["name"] == parent
    assert snap["counters"] == {"train.microbatches": 2,
                                "train.tokens": batch["tokens"].size}
    assert snap["launches"] == {"rmsnorm": 0, "swa_attention": 0, "fused_sgd_update": 0,
                                "ssd": 0, "ssd_backward": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_changes_no_bit_of_the_loss_gradient_or_update(arch):
    _, model, state, batch = _job(arch)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = state["params"]
    loss_off, grad_off = value_and_flat_grad(model, params, tbatch)
    with telemetry.tracing(telemetry.StepTracer()):
        loss_on, grad_on = value_and_flat_grad(model, params, tbatch)
    assert torch.equal(loss_on, loss_off) and torch.equal(grad_on, grad_off)

    after = {}
    for on in (False, True):
        _, model, state, batch = _job(arch)
        step = make_train_step(model, adamw(), microbatches=2, device="cpu")
        tracer = telemetry.StepTracer()
        with telemetry.tracing(tracer) if on else telemetry.NULL_SPAN:
            state, loss = step(state, batch, 1e-3)
        after[on] = (loss, state["params"].flat.clone(), state["opt"]["v"].flat.clone())
        assert bool(tracer.spans) == on
    for a, b in zip(after[False], after[True]):
        assert torch.equal(a, b)


def test_span_stamps_agree_with_their_profiler_range():
    tracer = telemetry.StepTracer()
    x = torch.randn(256, 256)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with telemetry.tracing(tracer):
        for _ in range(3):  # the first range of a profile starts late
            with telemetry.span("warm"):
                x @ x
        with telemetry.span("probe"):
            for _ in range(20):
                x = torch.tanh(x @ x)
            time.sleep(0.002)
    prof.stop()
    base = prof.profiler.kineto_results.trace_start_ns()
    (probe,) = (s for s in tracer.snapshot()["spans"] if s["name"] == "probe")
    (rng,) = (e.time_range for e in prof.events() if e.name == "probe")
    start_us, end_us = ((probe[k] - base) / 1e3 for k in ("start_ns", "end_ns"))
    assert abs(start_us - rng.start) <= 200 and abs(end_us - rng.end) <= 200, (
        start_us, rng.start, end_us, rng.end)


# --------------------------------------------------------- gloo ranks ----
def _exchange_rank(rank, world, init_method, out_dir):
    torch.set_num_threads(1)
    init_data_group(rank, world, init_method, "gloo", "cpu", timeout_s=TIMEOUT_S / 2)
    try:
        _, model, state, batch = _job("qwen2.5-3b")
        step = make_train_step(model, adamw(), grad_exchange="ring", device="cpu")
        tracer = telemetry.StepTracer()
        with telemetry.tracing(tracer):
            for _ in range(2):
                state, _ = step(state, batch, 1e-3)
        snap = tracer.snapshot()
        torch.save({"names": dict(_names(snap)), "counters": snap["counters"],
                    "numel": state["params"].flat.numel(),
                    "steps_of_exchanges": sorted(s["step"] for s in snap["spans"]
                                                 if s["name"] == "train.exchange")},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def test_the_exchange_is_one_span_a_step_and_counts_the_flat_buffers_bytes():
    for r in spawn(_exchange_rank, WORLD, (WORLD,), TIMEOUT_S):
        assert r["names"]["train.step"] == 2 and r["names"]["train.exchange"] == 2
        assert len(set(r["steps_of_exchanges"])) == 2
        assert r["counters"]["collectives.calls"] == 2
        assert r["counters"]["collectives.bytes"] == 2 * r["numel"] * 4


# ------------------------------------------------------------- the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the spans are held to CUPTI's kernel times")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_lies_inside_the_span_that_launched_it_on_the_cards_clock(cuda):
    """A span around a kernel of 5 ms or more and ``synchronize()``: the
    kernel's interval on the profiler's device timeline lies inside the
    span's host stamps, within 100 µs. Prints the offsets."""
    a = torch.randn(8192, 8192, device=cuda)
    (a @ a).sum().item()  # cuBLAS's start, outside the profile
    tracer = telemetry.StepTracer()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    with telemetry.tracing(tracer):
        for name in ("warm", "probe"):
            with telemetry.span(name):
                a @ a
                torch.cuda.synchronize()
    prof.stop()
    base = prof.profiler.kineto_results.trace_start_ns()
    (probe,) = (s for s in tracer.snapshot()["spans"] if s["name"] == "probe")
    start_us, end_us = ((probe[k] - base) / 1e3 for k in ("start_ns", "end_ns"))
    # the probe's kernel is the last one the profile holds
    k = max((e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: r.start)
    print(f"span [{start_us:.1f}, {end_us:.1f}] us, kernel [{k.start:.1f}, {k.end:.1f}] us: "
          f"kernel start - span start {k.start - start_us:.1f} us, span end - kernel end "
          f"{end_us - k.end:.1f} us, kernel {k.end - k.start:.1f} us "
          f"[{torch.cuda.get_device_name(0)}]")
    assert k.end - k.start >= 5e3
    assert k.start >= start_us - 100 and k.end <= end_us + 100
