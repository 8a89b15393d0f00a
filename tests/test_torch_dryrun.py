"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, on the tiny meshes (8 ranks): the five cases of
tests/test_dryrun_tiny.py and its gemma-2b roofline case, each held to the
reference's own record of the same case, made by its CLI with
``REPRO_DRYRUN_DEVICES=8 --skip-costs``. These must be equal:
``params_total``, ``params_active``, ``model_flops``, ``window``,
``scan_units`` and the per-device ``argument_bytes`` and
``output_bytes``. Also: under the ``dponly`` profile on a pure data mesh
of 8 ranks the collectives are the gradient all-reduce (4 bytes a
parameter) and the loss's (4 bytes);
the full-depth flops equal ``corrected_costs`` of the 1- and 2-unit
records; and experiments/make_report.py's ``roofline_table`` renders a
port record. Every run is a subprocess with a timeout; they all start at
once."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT_S = 420

CASES = [
    ("qwen2.5-3b", "train_4k", "single"),
    ("qwen3-moe-30b-a3b", "prefill_32k", "single"),
    ("mamba2-780m", "decode_32k", "multi"),
    ("jamba-v0.1-52b", "train_4k", "multi"),
    ("whisper-base", "decode_32k", "single"),
    ("gemma-2b", "train_4k", "single"),  # the roofline case: the port with costs
]
EQUAL = ("params_total", "params_active", "model_flops", "window", "scan_units")
EQUAL_MEMORY = ("argument_bytes", "output_bytes")


# gemma-2b's train_4k step under the dponly profile on the pure data mesh
# of 8 ranks (the reference's make_data_mesh): the paper's regime. (On the
# tiny 2 x 4 mesh dponly is not pure data parallelism: with "heads" mapped
# to no axis, the rules' head_dim fallback shards attention's head_dim over
# the idle "model" axis, in the reference's rules as in the port's.)
DATA_ONLY = """
import json, sys
from pathlib import Path
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import dryrun_on
from repro_torch.launch.mesh import AbstractMesh
rec = dryrun_on(get_config("gemma-2b"), SHAPES["train_4k"], AbstractMesh((8,), ("data",)),
                profile="dponly", skip_costs=True)
Path(sys.argv[-1], "rec.json").write_text(json.dumps(rec))
print("OK ")
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(package, case): record}: every run started at once, then awaited."""
    out = tmp_path_factory.mktemp("dryrun")
    runs = {}
    # one thread each: the runs work on shapes (meta tensors, XLA's
    # compile), and thirteen of them start at once beside other tests
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for case in CASES:
        arch, shape, mesh = case
        args = ["--arch", arch, "--shape", shape, "--mesh", mesh, "--tiny"]
        runs[("repro", case)] = (
            [sys.executable, "-m", "repro.launch.dryrun", *args, "--skip-costs"],
            dict(env, REPRO_DRYRUN_DEVICES="8"), out / "repro" / "_".join(case))
        costs = [] if arch == "gemma-2b" else ["--skip-costs"]
        runs[("port", case)] = ([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 *args, *costs], env, out / "port" / "_".join(case))
    runs[("port", "dponly")] = ([sys.executable, "-c", DATA_ONLY], env,
                                out / "port" / "dponly")
    procs = {}
    for key, (cmd, e, d) in runs.items():
        d.mkdir(parents=True)
        procs[key] = subprocess.Popen(cmd + ["--out", str(d)], env=e, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    recs = {}
    try:
        for key, p in procs.items():
            log, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0 and "OK " in log, (key, log[-3000:])
            (f,) = runs[key][2].iterdir()
            recs[key] = json.loads(f.read_text())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


@pytest.mark.parametrize("case", CASES, ids=["_".join(c) for c in CASES])
def test_record_equals_the_references(records, case):
    ours, theirs = records[("port", case)], records[("repro", case)]
    for key in EQUAL:
        assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    for key in EQUAL_MEMORY:
        assert ours["memory"][key] == theirs["memory"][key], (
            key, ours["memory"][key], theirs["memory"][key])
    assert ours["mesh"] == theirs["mesh"] and ours["n_devices"] == 8
    roof = ours["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert ours["memory"]["temp_bytes"] > 0
    # every layer's kernels, counted once each by the meta route
    cfg_layers = ours["scan_units"] * (8 if case[0].startswith("jamba") else 1)
    calls = ours["kernel_calls"]
    assert calls.get("swa_attention", 0) > 0 or case[0] == "mamba2-780m"
    assert calls.get("rmsnorm", 0) >= (0 if case[0] == "whisper-base" else cfg_layers)


def test_roofline_case_full_depth_flops_equal_the_corrected_unit_costs(records):
    from repro_torch.launch.dryrun import corrected_costs

    rec = records[("port", CASES[-1])]
    one, two = rec["raw_costs_scan_body_once"], rec["raw_costs_two_units"]
    corr = corrected_costs(one, two, rec["scan_units"])
    full = rec["roofline"]["flops_per_device"]
    assert abs(corr["flops"] - full) <= 1e-9 * full, (corr["flops"], full)
    assert full > 4 * one["flops"]
    assert rec["useful_flops_ratio"] is not None
    assert rec["memory"]["peak_bytes_per_device"] > 0


def test_dponly_collectives_are_the_gradient_and_loss_all_reduce(records):
    """Every parameter replicated, the batch split: the collectives are the
    f32 gradient's all-reduce, 4 bytes a parameter, and the loss's, 4."""
    rec = records[("port", "dponly")]
    assert rec["n_devices"] == 8 and rec["params_total"] == 2_506_172_416
    assert rec["roofline"]["collectives"] == {"all-reduce": 4.0 * rec["params_total"] + 4.0}


def test_make_report_renders_a_port_record(records):
    spec = importlib.util.spec_from_file_location("make_report",
                                                  ROOT / "experiments" / "make_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    rec = records[("port", CASES[-1])]
    key = (rec["arch"], rec["shape"], rec["mesh"], rec["profile"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.roofline_table({key: rec}, mesh=rec["mesh"], profile=rec["profile"])
    row = next(line for line in buf.getvalue().splitlines()
               if line.startswith(f"| {rec['arch']} | {rec['shape']} |"))
    assert "—" not in row and rec["roofline"]["dominant"] in row
