"""The span block's arithmetic on made-up timelines, and the block itself on
a smoke-size cell on the CPU (``portbench.spans``)."""
import json

import pytest

from portbench import harness, spans, trace
from portbench.tests.portbench_smoke import cell

HOME, AUTOGRAD = 1, 2


def _span(sid, name, start, end, parent=None, thread=HOME):
    return {"id": sid, "name": name, "parent": parent, "thread": thread,
            "start": start, "end": end}


# a step on [0, 100]: forward [10, 30], backward [30, 70] on the home
# thread, a formula on autograd's thread [40, 50] under the backward, an
# update [75, 90]; all in one clock
STEP = [_span(0, "train.step", 0, 100), _span(1, "train.microbatch", 5, 72, 0),
        _span(2, "train.forward", 10, 30, 1), _span(3, "train.backward", 30, 70, 1),
        _span(4, "kernels.rmsnorm.backward", 40, 50, 3, AUTOGRAD),
        _span(5, "train.update", 75, 90, 0)]


def test_idle_intervals_are_the_window_less_the_union_of_kernels():
    kernels = [(-5, 2, "a"), (4, 8, "b"), (6, 9, "c"), (20, 25, "d"), (99, 120, "e")]
    assert spans.idle_intervals(kernels, 0, 100) == [(2, 4), (9, 20), (25, 99)]
    assert spans.idle_intervals([], 0, 10) == [(0, 10)]
    assert spans.idle_intervals([(0, 10, "x")], 0, 10) == []


def test_the_idle_split_sums_exactly_and_follows_the_rule():
    idle = [(0, 12), (25, 35), (45, 60), (68, 80), (95, 100)]
    parts, by_name = spans.split_idle(idle, STEP, HOME)
    # forward: [10, 12] and [25, 30]; backward: [30, 35], [45, 60], [68, 70]
    assert parts == {"forward": 7.0, "backward": 22.0, "other": 25.0}
    assert sum(parts.values()) == sum(b - a for a, b in idle) == 54
    # innermost: the formula (deeper than train.backward) over [45, 50]
    assert by_name == {"train.step": 5.0 + 3 + 5, "train.microbatch": 5.0 + 2,
                       "train.forward": 7.0, "train.backward": 5.0 + 10 + 2,
                       "kernels.rmsnorm.backward": 5.0, "train.update": 5.0}


def test_a_span_on_autograds_thread_counts_as_backward_wherever_the_home_thread_is():
    # the home thread is still inside train.forward's stamp while the
    # formula runs (a clock skew): backward wins
    s = [_span(1, "train.forward", 0, 50), _span(2, "train.backward", 60, 90),
         _span(3, "kernels.swa_attention.backward", 40, 70, 2, AUTOGRAD)]
    parts, _ = spans.split_idle([(0, 100)], s, HOME)
    assert parts == {"forward": 40.0, "backward": 50.0, "other": 10.0}
    # a span of another thread that is not under train.forward is not forward
    other = [_span(1, "train.forward", 0, 50, thread=AUTOGRAD)]
    assert spans.split_idle([(0, 100)], other, HOME)[0]["forward"] == 0.0


def test_a_kernel_falls_inside_its_device_side_range():
    kernels = [(1, 3, "k1"), (4, 6, "k2"), (10, 11, "k3"), (20, 22, "k4")]
    ranges = [(3.5, 12), (0, 2)]
    assert spans.kernel_us_in_ranges(kernels, ranges) == 2 + 2 + 1
    assert spans.kernel_us_in_ranges(kernels, []) == 0.0


def test_a_kernel_belongs_to_the_innermost_span_open_where_it_was_launched():
    # launches: 1 in the forward (home), 2 on autograd's thread inside the
    # formula, 3 on autograd's thread outside it (the home thread's
    # train.backward), 4 between spans, 5 after the step; kernel 6 has no
    # launch in the trace
    launches = {1: (15, HOME), 2: (45, AUTOGRAD), 3: (55, AUTOGRAD), 4: (73, HOME),
                5: (120, HOME)}
    kernels = [(2.0, 1), (3.0, 2), (4.0, 3), (5.0, 4), (6.0, 5), (7.0, 6), (1.0, 1)]
    got = spans.kernels_by_launching_span(kernels, launches, STEP, HOME)
    assert got == {"train.forward": [3.0, 2], "kernels.rmsnorm.backward": [3.0, 1],
                   "train.backward": [4.0, 1], "train.step": [5.0, 1],
                   spans.OUTSIDE: [6.0, 1], "unattributed": [7.0, 1]}


def test_chrome_launches_pairs_kernels_with_their_runtime_calls():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 4, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "tid": 42, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 20, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 4, "dur": 3, "args": {}},
        {"ph": "M", "name": "process_name", "args": {"name": "x"}}]}
    kernels, launches = spans.chrome_launches(doc)
    assert kernels == [(4, 7), (1, 8)] and launches == {7: (5, 42)}


def test_spans_are_put_on_the_profiles_clock():
    snap = {"spans": [{"name": "a", "id": 0, "parent": None, "step": None, "thread": 7,
                       "start_ns": 1_000_500_000, "end_ns": 1_002_000_000}]}
    (s,) = spans.on_timeline(snap, 1_000_000_000)
    assert (s["start"], s["end"]) == (500.0, 2000.0)


def test_read_is_a_mean_over_ranks_and_none_without_spans():
    a = {"spans": {"idle_ms_per_step_by_part": {"forward": 2.0}, "backward_formulas_ms": 4.0}}
    b = {"spans": {"idle_ms_per_step_by_part": {"forward": 4.0}, "backward_formulas_ms": None}}
    assert spans.read([a, b], "idle_ms_per_step_by_part", "forward") == 3.0
    assert spans.read([a, b], "backward_formulas_ms") == 4.0
    assert spans.read([{"step_ms": [1.0]}], "backward_formulas_ms") is None


@pytest.mark.parametrize("name", ["qwen2.5-3b.train", "mamba2-780m.train"])
def test_the_span_block_runs_on_a_smoke_cell(name, monkeypatch, tmp_path):
    """On the CPU there are no kernels: the whole window is idle, and it is
    split whole; each train span appears as often as the step runs it."""
    monkeypatch.setattr(trace, "TRACE_DIR", tmp_path)
    c = cell(name)
    result = spans.run_cell(c, 2**33 + 11, 0.05, harness.torch.device("cpu"), cost_rounds=1)
    sp = result["spans"]
    k = result["traced_steps"]
    split = sp["idle_ms_per_step_by_part"]
    assert sum(split.values()) == pytest.approx(sp["idle_ms_per_step"], rel=1e-9)
    assert sp["idle_ms_per_step"] == pytest.approx(sp["window_ms_per_step"], rel=1e-9)
    assert min(split.values()) > 0
    mb = c.traffic["microbatches"]
    assert sp["spans_per_step"]["train.step"] == 1
    assert sp["spans_per_step"]["train.forward"] == sp["spans_per_step"]["train.backward"] == mb
    n = c.model["n_layers"]
    assert sp["spans_per_step"]["kernels.rmsnorm.backward"] == mb * (2 * n + 1)
    assert sp["counters_per_step"] == {"train.microbatches": mb,
                                       "train.tokens": c.rows * c.traffic["seq"]}
    assert result["idle_forward_ms"] == split["forward"]
    assert result["backward_formulas_ms"] is None  # no device-side range on the CPU
    doc = json.loads((tmp_path / f"{name}.rank0.spans.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("pid") == "spans"}
    assert {"train.step", "train.forward", "train.backward"} <= names
    assert k >= 1
    assert set(result["host_ms_per_step_by_mode"]) == set(spans.MODES)
    assert all(len(v) == 1 and v[0] > 0 for v in result["host_ms_per_step_by_mode"].values())
    assert set(result["span_us"]) == {"off", "spans", "profiler+spans"}
