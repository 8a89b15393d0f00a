"""On the card: one short run of each cell through ``run.py``, as the
benchmark's check runs it. Skips without as many cards as the cell asks.

    python3 -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.portbench_smoke import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell,cards", [("qwen2.5-3b.train", 1), ("mamba2-780m.train", 1),
                                        ("qwen2.5-3b.dp4-ring", 4)])
def test_cell_runs_correct_on_the_card(cell, cards):
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s): the benchmark does not run on the CPU")
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**33 + 1), "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
