"""The comparison that decides ``correct``: the program's readings of its
first training steps against the plain reference's of the same weights and
batches.

Three numbers, each the worst over the segments (a leaf, or one layer of a
leaf stacked over the layers):
- ``loss_gap``: the largest relative gap between the program's loss and the
  reference's over the checked steps;
- ``grad_gap``: the gap between the norms of the first gradient as the
  optimizer received it and the reference's, over the reference's norm of
  that segment or of the median segment, whichever is larger;
- ``change_gap``: the same of each segment's change over the checked steps.
  Segments whose reference gradient is under a thousandth of the median
  segment's move under Adam by round-off alone (a key's bias under the
  softmax): they are left out of it by that rule.
And ``grad_rows_gap``: by how many the leaves' rows that the first
gradient reaches (``weights.nonzero_rows``) differ from the reference's.
Which tokens the step saw decides it (an embedding row that no token of
the batch names has a zero gradient), never rounding: an exact
comparison.
Beside them, steadier readings: the first step's loss gap and the median
segment's gap of each norm. A cell's ``workloads/<cell>.json`` gives the
limit of each number it compares; the others are reported.
"""
from __future__ import annotations

import math
import statistics

ZERO_GRADIENT = 1e-3  # of the median segment's reference gradient
NUMBERS = ("loss_gap", "first_loss_gap", "grad_rows_gap", "grad_gap", "change_gap",
           "grad_gap_median", "change_gap_median")


def _gaps(prog, ref, keep=None) -> list[tuple[float, int]]:
    """(gap, index) of each kept segment."""
    idx = [j for j in range(len(ref)) if keep is None or keep[j]]
    med = statistics.median(ref[j] for j in idx)
    out = []
    for j in idx:
        scale = max(ref[j], med)
        gap = abs(prog[j] - ref[j]) / scale if scale > 0 else abs(prog[j] - ref[j])
        out.append((gap if math.isfinite(gap) else math.inf, j))
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers of ``prog``'s readings against ``ref``'s (each
    {"losses", "grad_norms", "change_norms"}; ``ref`` also names the
    segments)."""
    names = ref["segments"]
    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for p, r in zip(prog["losses"], ref["losses"]))
    grad = _gaps(prog["grad_norms"], ref["grad_norms"])
    floor = ZERO_GRADIENT * statistics.median(ref["grad_norms"])
    moving = [g >= floor for g in ref["grad_norms"]]
    change = _gaps(prog["change_norms"], ref["change_norms"], moving)
    out = {"loss_gap": loss, "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0])
           / abs(ref["losses"][0]),
           "grad_rows_gap": abs(prog["grad_rows"] - ref["grad_rows"])}
    for key, g in (("grad_gap", grad), ("change_gap", change)):
        worst = max(g)
        out[key], out[key + "_at"] = worst[0], names[worst[1]]
        out[key + "_median"] = statistics.median(x for x, _ in g)
    out.update(segments_left_out=moving.count(False), segments=len(names))
    return out


def worst(per_rank: list[dict]) -> dict:
    """The worst rank's value of each number, and where it was read."""
    out = dict(per_rank[0])
    for g in per_rank[1:]:
        for key in NUMBERS:
            if not g[key] <= out[key]:
                out[key] = g[key]
                if key + "_at" in g:
                    out[key + "_at"] = g[key + "_at"]
    return out


def checks(g: dict, limits: dict) -> dict:
    """Each number the cell compares, beside its limit."""
    return {k: {"value": g[k], "limit": lim, "ok": g[k] <= lim}
            for k, lim in limits["limits"].items()}
