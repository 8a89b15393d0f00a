"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size: the sound program's numbers over many seeds, each planted
fault's and the control's over a few. No window is run: each reading
takes the cell's checked steps alone. The benchmark's runs never run this.

    python3 portbench/controls.py --workload NAME --seeds 12 \\
        --faults unchanged,half_batch --fault-seeds 3 --control-seeds 3 \\
        [--first-seed N] [--out FILE]

The control is the reference put in the program's place with its
parameters and AdamW's moments kept in bf16 (the configuration states f32
masters). Prints one JSON line a seed and a summary line: for each
variant, the smallest and largest reading of each number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(rows: list[dict], numbers) -> dict:
    out = {}
    for row in rows:
        for variant, g in row.items():
            if not isinstance(g, dict):
                continue
            for k in numbers:
                lo, hi = out.setdefault(variant, {}).get(k, (g[k], g[k]))
                out[variant][k] = (min(lo, g[k]), max(hi, g[k]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_007)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-microbatch", type=int, default=None,
                    help="read at another size than the cell's (a witness)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--witness", action="store_true",
                    help="also read the program with f32 activations")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                             args.workload, ROOT)
    for key in ("rows_per_microbatch", "microbatches"):
        if getattr(args, key) is not None:
            cell.traffic[key] = getattr(args, key)
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    seeds = [args.first_seed + 7919 * j for j in range(args.seeds)]
    job = {"cell": cell, "mode": "readings", "seeds": seeds,
           "faults": [f for f in args.faults.split(",") if f],
           "fault_seeds": args.fault_seeds, "control_seeds": args.control_seeds,
           "witness": args.witness,
           "device": args.device, "backend": "nccl" if args.device == "cuda" else "gloo",
           "seed": seeds[0], "trace": False}
    t0 = time.perf_counter()
    ranks = harness.run_ranks(job, cell.chips, 3500)
    # the worst rank's number of each variant and seed
    rows = []
    for j, seed in enumerate(seeds):
        per_rank = [r["rows"][j] for r in ranks]
        row = {"seed": seed, "reference_s": max(r["reference_s"] for r in per_rank)}
        for variant in per_rank[0]:
            if isinstance(per_rank[0][variant], dict):
                row[variant] = harness.compare.worst([r[variant] for r in per_rank])
        rows.append(row)
    lines = [json.dumps(r) for r in rows]
    lines.append(json.dumps({"workload": cell.name, "traffic": cell.traffic,
                             "seconds": time.perf_counter() - t0,
                             "device": (torch.cuda.get_device_name(0)
                                        if args.device == "cuda" else "cpu"),
                             "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
                             "summary": summary(rows, harness.compare.NUMBERS)}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
