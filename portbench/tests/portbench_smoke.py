"""Smoke-size cells of the benchmark for the CPU tests: the configured
families cut to 2 layers and small widths, the traffic cut to short
sequences, with limits set for this size.

Each family's cut is a file, ``smoke/<family>.json``: ``model``, the
overrides of the configuration's model (or, for a family that no cell of
``BENCHMARK.json`` runs yet, its whole model and a ``traffic`` of the
benchmark to run it under); ``limits``, the comparison's limits at this
size; ``why``, the readings they were set from."""
from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:  # the program under test
    sys.path.insert(0, str(ROOT / "src"))

from portbench import harness  # noqa: E402

SMOKE = Path(__file__).resolve().parent / "smoke"


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def smoke(family: str) -> dict:
    return json.loads((SMOKE / f"{family}.json").read_text())


def _cut(c: harness.Cell, seq: int) -> harness.Cell:
    cut = smoke(c.family)
    c.config["model"].update(cut["model"])
    c.traffic.update(seq=seq, pool_steps=8)
    c.limits = {"limits": cut["limits"]}
    return c


def cell(name: str, seq: int = 32) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at its family's smoke size."""
    return _cut(copy.deepcopy(harness.load_cell(bench(), name, ROOT)), seq)


def family_cell(family: str, seq: int = 32) -> harness.Cell:
    """A one-card cell of ``family``, which no cell of BENCHMARK.json runs:
    its smoke file's model under its smoke file's traffic."""
    cut, b = smoke(family), bench()
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cut['traffic']}.json")
                         .read_text())
    c = harness.Cell(f"{family}.smoke", 1, {"model": {"family": family}}, traffic, {},
                     [m for m in b["end_to_end"] if "workloads" not in m], [])
    return _cut(c, seq)


def four_ranks(c: harness.Cell) -> harness.Cell:
    """``c``'s job on four ranks under the paper's ring exchange, the
    learning rate scaled by four (eq. 7)."""
    c = copy.deepcopy(c)
    c.chips = 4
    c.traffic.update(ranks=4, grad_exchange="ring", lr=4 * c.traffic["lr"])
    return c


def job(c: harness.Cell, seed: int = 2**33 + 5, trace: bool = False, fault=None,
        seconds: float = 0.5, **kw) -> dict:
    return {"cell": c, "seed": seed, "seconds": seconds, "trace": trace,
            "device": "cpu", "backend": "gloo", "t_start": time.time(),
            "fault": fault, **kw}


def run(c: harness.Cell, **kw) -> dict:
    j = job(c, **kw)
    ranks = harness.run_ranks(j, c.chips, 600)
    return harness.assemble(c, ranks, j["trace"], j["t_start"], "cpu")
