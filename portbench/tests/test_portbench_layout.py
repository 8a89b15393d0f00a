"""The harness finds every cell's files by the names in BENCHMARK.json, and
the file keeps to its schema."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.portbench_smoke import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_benchmark_json_keeps_to_its_schema():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in SOURCES and "bound" not in m
    fours = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(b["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(bench(), name, ROOT)
    assert cell.chips == cell.traffic["ranks"]
    assert harness.flops_per_token(cell) > 0
    fam = harness.family_module(cell)
    assert fam.layout(cell.model)
    assert callable(getattr(fam, "loss_and_grad", None) or fam.layer)
    assert set(cell.limits["limits"]) <= set(harness.compare.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) > 1
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_every_reader_and_file_belongs_to_the_benchmark():
    b = bench()
    here = Path(harness.__file__).parent
    metrics = {p.stem for p in (here / "metrics").glob("*.py")} - {"__init__"}
    assert metrics == {m["name"] for m in b["per_layer"]}
    traffic = {p.stem for p in (here / "traffic").glob("*.json")}
    assert traffic == {w["traffic"] for w in b["workloads"]}
    cells = {p.stem for p in (here / "workloads").glob("*.json")}
    assert cells == {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")


def test_run_fails_without_a_card(tmp_path):
    """No card: exit 3, no result line. Only BENCHMARK.json and the
    benchmark's folder: exit 2."""
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen2.5-3b.train", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 3 and run.stdout == ""
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(tmp_path)], check=True)
    bare = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "qwen2.5-3b.train", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert bare.returncode == 2 and bare.stdout == ""
