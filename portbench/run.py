"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``src/repro_torch``. The cell, its
configuration, traffic, limits and metric readers are found by the names
in ``BENCHMARK.json``. It needs as many CUDA cards as the cell asks for
and runs one process a card; there is no CPU fallback.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks``, last, holds each number compared beside its
limit, as do the last lines of standard error. Exit codes: 0 a result
printed; 2 the checkout or the arguments are wrong; 3 too few cards; 4 a
forbidden module was loaded; 1 the run failed.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# first-run build: the kernels' nvcc output (repro_torch.kernels.build, at
# build/kernels) and any other cache stay at fixed paths in the checkout
CACHE = ROOT / "build" / "portbench" / "cache"
DEADLINE_S = 1150.0  # a cell's first run in a checkout, which compiles


def _say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e!r}"


def _plain(x):
    """``x`` with each non-finite float as a string, so that the line is
    strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        _say("portbench: --seed must be at least 0 and --seconds positive")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not (ROOT / "BENCHMARK.json").is_file():
        _say(f"portbench: {ROOT} holds no src/repro_torch (the program under test) "
             "or no BENCHMARK.json")
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload, ROOT)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        _say(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), {cards} visible; "
             "the benchmark does not run on the CPU")
        return 3
    job = {"cell": cell, "seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "device": "cuda", "backend": "nccl",
           "t_start": T_START}
    ranks = harness.run_ranks(job, cell.chips, DEADLINE_S - (time.time() - T_START))
    result = harness.assemble(cell, ranks, bool(args.trace), T_START,
                              torch.cuda.get_device_name(0))
    if result["forbidden_modules"]:
        _say(f"portbench: forbidden modules loaded: {result['forbidden_modules']}")
        return 4
    r0 = ranks[0]
    _say(f"portbench: {cell.name} seed {args.seed}: {r0['attempted']} steps in "
         f"{r0['window_s']:.3f} s; reference {max(r['reference_s'] for r in ranks):.2f} s; "
         f"card {_power_limit()}")
    _say("portbench: readings " + json.dumps(result["readings"]))
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"] and math.isfinite(c["value"])
        _say(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}")
    print(json.dumps(_plain(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
