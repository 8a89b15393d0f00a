"""Smoke-size cells of the benchmark for the CPU tests: the configured
families cut to 2 layers and small widths, the traffic cut to short
sequences, with limits set for this size."""
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
SMALL = {"dense": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
                       d_ff=256, vocab_size=512),
         "ssm": dict(n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
                     ssm_headdim=16, ssm_chunk=16)}
# set from six seeds of the sound smoke runs on the CPU (grad_gap: qwen
# 1.1e-3-4.0e-3, mamba2 6.1e-3-2.1e-2; change_gap: 3.6e-3-6.8e-3 and
# 3.1e-3-1.25e-2) and the faults' and the control's readings (half a batch:
# grad_gap 0.44-0.53 and 0.48-0.73; bf16 masters: change_gap 0.09-0.10 and
# 1.35-1.73); grad_rows_gap is exact: 0 sound, 22 rows with half a batch
LIMITS = {"dense": {"limits": {"grad_rows_gap": 0, "grad_gap": 0.05, "change_gap": 0.03}},
          "ssm": {"limits": {"grad_rows_gap": 0, "grad_gap": 0.1, "change_gap": 0.05}}}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, seq: int = 32) -> harness.Cell:
    c = copy.deepcopy(harness.load_cell(bench(), name, ROOT))
    c.config["model"].update(SMALL[c.family])
    c.traffic.update(seq=seq, pool_steps=8)
    c.limits = LIMITS[c.family]
    return c


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
