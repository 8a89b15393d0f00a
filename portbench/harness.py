"""The benchmark's run of one cell: set-up, the timed window, the traced
window and the comparison that decides ``correct``.

A cell is a configuration (``configs/<config>.json``) under a traffic mix
(``traffic/<traffic>.json``), with the limits of its comparison
(``workloads/<cell>.json``); all are found by the names in
``BENCHMARK.json``. A cell of ``ranks`` > 1 runs one process a card, each a
rank of an NCCL group over a ``file://`` rendezvous; ``run_rank`` is one
rank's whole run and ``assemble`` joins the ranks' records into the
result line.

The program is ``repro_torch``: the train step of
``engine.steps.make_train_step`` with ``optim.adamw``, f32 masters in one
flat buffer and bf16 compute, as ``launch.train`` drives it. Its weights
are the benchmark's (``weights.draw``), and its batches are drawn from the
seed by the benchmark's frozen ``TokenStream`` and staged on the device
before the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import compare, costs, weights
from portbench.reference import _common
from portbench.tokens import TokenStream

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_STEP, SPAN_OPT = "portbench.step", "portbench.optimizer"
# faults planted under the timed path by the controls and the tests, never
# by run.py: the optimizer leaves the state unchanged; half of each rank's
# rows are left out; the ranks do not exchange their gradients
FAULTS = ("unchanged", "half_batch", "no_exchange")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # workloads/<cell>.json
    end_to_end: list    # BENCHMARK.json's metrics that this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self) -> str:
        return self.model["family"]

    @property
    def rows(self) -> int:
        """A rank's rows a step."""
        return self.traffic["rows_per_microbatch"] * self.traffic["microbatches"]

    @property
    def tokens_per_step(self) -> int:
        """Tokens a step over all ranks."""
        return self.rows * self.traffic["seq"] * self.chips


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path = HERE.parent) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json), its files found by
    name under the benchmark's folder."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / "portbench"
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "workloads" / f"{name}.json").read_text())
    if traffic["ranks"] != w["chips"]:
        raise ValueError(f"{name}: traffic {w['traffic']} has {traffic['ranks']} "
                         f"ranks, the cell {w['chips']} chips")
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(cell: Cell):
    return load_module("reference", cell.family)


def flops_per_token(cell: Cell) -> float:
    return load_module("flops", cell.family).per_token(cell.model, cell.traffic["seq"])


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------- the feed --
class Feed:
    """A rank's batches, drawn from the seed before the window and staged on
    the device: ``pool_steps`` steps, used in turn. Step i's global rows
    are ``rows * ranks`` rows of the stream; rank r takes the r-th block of
    ``rows``, as ``launch.mesh.local_rows`` splits a global batch."""

    def __init__(self, cell: Cell, seed: int, rank: int, device):
        tr = cell.traffic
        self.pool, self.k = tr["pool_steps"], tr["microbatches"]
        rows, world = cell.rows, cell.chips
        b = TokenStream(cell.model["vocab_size"], tr["seq"], seed).batch(
            0, self.pool * rows * world)
        shape = (self.pool, world, rows, tr["seq"])
        self.tokens, self.labels = (
            torch.from_numpy(b[k].reshape(shape)[:, rank].copy()).to(device)
            for k in ("tokens", "labels"))

    def batch(self, i: int, rows: int | None = None) -> dict:
        j = i % self.pool
        return {"tokens": self.tokens[j, :rows], "labels": self.labels[j, :rows]}

    def micro(self, i: int) -> list:
        """Step i's microbatches as the step splits them: k consecutive
        blocks of rows."""
        b = self.batch(i)
        m = b["tokens"].shape[0] // self.k
        return [(b["tokens"][j * m:(j + 1) * m], b["labels"][j * m:(j + 1) * m])
                for j in range(self.k)]


# ------------------------------------------------------------ the program --
def _spanned(fn, name: str):
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


class Program:
    """The system under test: the model, AdamW and the train step that the
    window calls, built as ``launch.train`` builds them."""

    def __init__(self, cell: Cell, device, world: int, trace: bool = False,
                 fault: str | None = None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.engine.steps import make_train_step
        from repro_torch.models.registry import build_model
        from repro_torch.models.spec import flatten
        from repro_torch.optim import adamw

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        tr = cell.traffic
        self.cell, self.device, self.fault = cell, device, fault
        self.model = build_model(ModelConfig(**cell.model), torch.float32)
        self.layout = family_module(cell).layout(cell.model)
        specs = {p: (tuple(s.shape), s.dtype) for p, s in
                 flatten(self.model.param_specs()).items()}
        want = {p: (leaf.shape, torch.float32) for p, leaf in self.layout.items()}
        if specs != want:
            diff = sorted(set(specs.items()) ^ set(want.items()))
            raise ValueError(f"the program's parameters differ from the reference's "
                             f"layout: {diff[:6]}")
        opt = adamw(**tr["adamw"])
        if fault == "unchanged":
            opt = dataclasses.replace(opt, update=lambda g, s, p, lr: (p, s))
        if trace:
            opt = dataclasses.replace(opt, update=_spanned(opt.update, SPAN_OPT))
        self.opt = opt
        self.rows, k = cell.rows, tr["microbatches"]
        if fault == "half_batch":
            self.rows //= 2
            k = math.gcd(k, self.rows)
        exchange = tr["grad_exchange"] if world > 1 and fault != "no_exchange" else None
        self.step = make_train_step(self.model, opt, grad_exchange=exchange,
                                    microbatches=k, device=device)

    def init_state(self, seed: int) -> dict:
        from repro_torch.models.spec import flatten, views

        flat = weights.draw(self.layout, seed, self.device)
        params = views(flat, {p: self.layout[p].shape for p in weights.order(self.layout)})
        for path, a, _ in weights.offsets(self.layout):
            if flatten(params)[path].data_ptr() != flat[a:].data_ptr():
                raise ValueError(f"the program orders its flat buffer otherwise: {path}")
        return {"params": params, "opt": self.opt.init(params)}

    def __call__(self, state, feed: Feed, i: int):
        return self.step(state, feed.batch(i, self.rows), self.cell.traffic["lr"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(device, world: int) -> None:
    """Every rank's queued work done, and every rank here."""
    _sync(device)
    if world > 1:
        dist.all_reduce(torch.ones(1, device=device))
        _sync(device)


def checked_steps(prog: Program, state, feed: Feed, seed: int, hp: dict, n: int):
    """The first n steps, through the window's own call and feed, and the
    program's readings of them: each step's loss, the first gradient as
    AdamW received it (its first moment after one step over 1 - b1: each
    segment's norm, and how many rows of the leaves it reaches) and each
    segment's change after the n steps. Returns (state, readings,
    seconds of the last step, synchronised)."""
    segs = _common.segments(family_module(prog.cell), prog.cell.model, prog.layout)
    losses, grad_norms, last = [], None, 0.0
    for i in range(n):
        _sync(prog.device)
        t0 = time.perf_counter()
        state, loss = prog(state, feed, i)
        _sync(prog.device)
        last = time.perf_counter() - t0
        losses.append(loss)
        if i == 0:
            m = state["opt"]["m"].flat
            grad_norms = [x / (1.0 - hp["b1"]) for x in weights.segment_norms(m, segs)]
            rows = weights.nonzero_rows(m, prog.layout)
    change = weights.segment_norms(state["params"].flat, segs,
                                   weights.chunks(prog.layout, seed, prog.device))
    return state, {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                   "grad_rows": rows, "change_norms": change}, last


def reference_readings(cell: Cell, seed: int, feed: Feed, device,
                       master=torch.float32) -> dict:
    tr = cell.traffic
    steps = [feed.micro(i) for i in range(tr["checked_steps"])]
    return _common.train_readings(family_module(cell), cell.model,
                                  family_module(cell).layout(cell.model), seed,
                                  steps, tr["lr"], tr["adamw"], device, master=master)


@contextlib.contextmanager
def f32_activations():
    """The program's activations in f32 (its embedding keeps the table's
    f32 rows, and every weight is cast to the activations' dtype at use):
    a second witness of the program's arithmetic, which the controls run
    beside the configuration's bf16."""
    from repro_torch.models import layers

    inner = layers.embed_tokens
    layers.embed_tokens = lambda e, t, scale=None: layers.lookup(e, t).float()
    try:
        yield
    finally:
        layers.embed_tokens = inner


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------------- one rank --
def run_rank(rank: int, world: int, job: dict) -> dict:
    """One rank's run. ``job``: cell, seed, seconds, trace, device ("cuda"
    or "cpu"), backend, rdzv, t_start (the run's start, wall clock),
    fault; ``mode`` "run" (the timed run) or "readings" (``readings_job``)."""
    cell: Cell = job["cell"]
    device = torch.device("cuda", rank) if job["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        from repro_torch.launch.mesh import init_data_group
        init_data_group(rank, world, job["rdzv"], job["backend"], device)
    try:
        if job.get("mode", "run") == "readings":
            return readings_job(rank, world, job, device)
        return _run(rank, world, job, device)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _run(rank: int, world: int, job: dict, device) -> dict:
    cell, seed, trace = job["cell"], job["seed"], job["trace"]
    tr = cell.traffic
    prog = Program(cell, device, world, trace=trace, fault=job.get("fault"))
    feed = Feed(cell, seed, rank, device)
    state = prog.init_state(seed)
    state, prog_read, last_s = checked_steps(prog, state, feed, seed, tr["adamw"],
                                            tr["checked_steps"])
    n = max(2, math.ceil(job["seconds"] / last_s))
    if world > 1:  # every rank runs the same steps
        t = torch.tensor([n], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        n = int(t.item())
    first = tr["checked_steps"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"rank": rank, "steps": n}
    losses = []
    if not trace:
        _barrier(device, world)
        out["window_start_wall"] = time.time()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            state, loss = prog(state, feed, i)
            losses.append(loss)
        _barrier(device, world)
        out["window_s"] = time.perf_counter() - t0
    else:
        from portbench import trace as tracing
        state, losses, out["trace"], out["window_start_wall"] = tracing.traced_window(
            prog, state, feed, first, n, min(tr["trace_steps"], n), world)
        out["window_s"] = out["trace"]["loop_s"]
    losses = [float(x) for x in losses]
    out["attempted"], out["failed"] = n, sum(1 for x in losses if not math.isfinite(x))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    if trace:
        out["trace"].update(peak_bytes_window=out["memory_peak_bytes"],
                            flops_per_step=flops_per_token(cell) * cell.rows * tr["seq"])
    out["forbidden"] = forbidden_modules()
    del state, prog
    _free()
    t0 = time.perf_counter()
    ref = reference_readings(cell, seed, feed, device)
    out["reference_s"] = time.perf_counter() - t0
    out["gaps"] = compare.gaps(prog_read, ref)
    return out


def readings_job(rank: int, world: int, job: dict, device) -> dict:
    """The numbers compared, without a window, for each seed of
    ``job["seeds"]``: the sound program's, each fault's of ``job["faults"]``
    and the control's (the reference with bf16 masters and moments, in
    the program's place) on the first ``job["control_seeds"]`` seeds; with
    ``job["witness"]``, the program with f32 activations too. Every one is
    measured against the f32 reference of the same seed."""
    cell = job["cell"]
    tr = cell.traffic
    rows = []
    for j, seed in enumerate(job["seeds"]):
        feed = Feed(cell, seed, rank, device)
        read = {}
        variants = [(None, "program")]
        variants += [(f, f) for f in (job["faults"] if j < job["fault_seeds"] else ())]
        if job.get("witness"):
            variants.append((None, "program_f32_activations"))
        for fault, name in variants:
            with (f32_activations() if name == "program_f32_activations"
                  else contextlib.nullcontext()):
                prog = Program(cell, device, world, fault=fault)
                state = prog.init_state(seed)
                state, read[name], _ = checked_steps(
                    prog, state, feed, seed, tr["adamw"], tr["checked_steps"])
            del state, prog
            _free()
        t0 = time.perf_counter()
        ref = reference_readings(cell, seed, feed, device)
        ref_s = time.perf_counter() - t0
        if j < job["control_seeds"]:
            read["control_bf16_masters"] = reference_readings(
                cell, seed, feed, device, master=torch.bfloat16)
        rows.append({"seed": seed, "reference_s": ref_s,
                     **{k: compare.gaps(v, ref) for k, v in read.items()}})
        _free()
    return {"rank": rank, "rows": rows, "forbidden": forbidden_modules()}


# ----------------------------------------------------------- the ranks --
def _rank_entry(rank: int, world: int, job: dict, queue) -> None:
    try:
        queue.put(run_rank(rank, world, job))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def run_ranks(job: dict, world: int, deadline_s: float) -> list[dict]:
    """Run ``job`` on ``world`` ranks: in this process for one, else one
    spawned process a rank, each on its own card (or all on the CPU over
    gloo), over a ``file://`` rendezvous in a fresh directory under
    TMPDIR. Returns the ranks' records, rank 0 first; raises if a rank
    failed or the deadline passed, after every process has ended."""
    if world == 1:
        return [run_rank(0, 1, job)]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="portbench-rdzv-") as tmp:
        job = {**job, "rdzv": f"file://{tmp}/rdzv"}
        procs = [ctx.Process(target=_rank_entry, args=(r, world, job, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, error = [], None
        try:
            end = time.time() + deadline_s
            while len(out) < world:
                rec = queue.get(timeout=max(1.0, end - time.time()))
                if "error" in rec:
                    error = f"rank {rec['rank']} failed:\n{rec['error']}"
                    break
                out.append(rec)
        except Exception as e:  # the queue's timeout
            error = error or f"ranks did not finish in time: {e!r}"
        finally:
            for p in procs:
                p.join(timeout=30 if error is None else 5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if error is not None:
        raise RuntimeError(error)
    return sorted(out, key=lambda r: r["rank"])


# ------------------------------------------------------------ the result --
def end_to_end(cell: Cell, r0: dict, t_start: float) -> dict:
    """The end-to-end metrics, from rank 0's host clock: tokens of all
    ranks over the window, the model flops of those tokens as a share of
    the cards' bf16 peak, and the set-up from the process's start."""
    tokens = r0["attempted"] * cell.tokens_per_step
    values = {"train_tokens_per_s": tokens / r0["window_s"],
              "train_mfu": costs.mfu_percent(flops_per_token(cell) * tokens,
                                             r0["window_s"], cell.chips),
              "setup_s": r0["window_start_wall"] - t_start}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell: Cell, ranks: list[dict]) -> dict:
    out = {}
    traces = [r["trace"] for r in ranks]
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(traces)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def assemble(cell: Cell, ranks: list[dict], trace: bool, t_start: float,
             device_kind: str) -> dict:
    """The result line: rank 0's window and clocks, the worst rank's
    numbers compared, the fullest card's peak."""
    r0 = ranks[0]
    gaps = compare.worst([r["gaps"] for r in ranks])
    forbidden = sorted({m for r in ranks for m in r["forbidden"]} | set(forbidden_modules()))
    failed = max(r["failed"] for r in ranks)
    checks = {"window_losses_not_finite": {"value": failed, "limit": 0, "ok": failed == 0},
              **compare.checks(gaps, cell.limits)}
    correct = not forbidden and all(c["ok"] for c in checks.values())
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    result = {"correct": correct, "attempted": r0["attempted"], "failed": failed}
    if trace:
        result["metrics"] = per_layer(cell, ranks)
        device["busy_s"] = statistics.fmean(r["trace"]["busy_s"] for r in ranks)
        device["window_s"] = statistics.fmean(r["trace"]["window_s"] for r in ranks)
        result["device"] = device
        result["breakdown"] = {**r0["trace"]["breakdown"],
                               "idle_gaps": r0["trace"]["idle_gaps"]}
        result["groups_ms_per_step"] = r0["trace"]["groups_ms_per_step"]
    else:
        result["metrics"] = end_to_end(cell, r0, t_start)
        result["device"] = device
    result["readings"] = {k: v for k, v in gaps.items() if k not in checks}
    result["forbidden_modules"] = forbidden
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result
