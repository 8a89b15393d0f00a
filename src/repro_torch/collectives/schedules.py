"""All-reduce algorithm simulators with first-principles cost counters (a
numpy copy of ``repro.collectives.schedules``, kept whole).

The paper (§2.1, §3.2) models three algorithms: *ring*, *doubling–halving*
(recursive halving/doubling, Rabenseifner) and *binary blocks* (non-power-
of-two w).  Each simulator executes the algorithm step-by-step over numpy
vectors — producing the exact all-reduce result — while counting the
latency/bandwidth/compute terms (α messages, β bytes, γ reduced bytes) that
eqs. (2)–(4) model.  ``CommStats.bytes_sent`` is what each rank sends in
one all-reduce; the executable versions are in ``collectives.dist``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass
class CommStats:
    """Per-rank worst-case counters over the whole all-reduce."""
    steps: int = 0            # sequential message rounds (α count)
    bytes_sent: float = 0.0   # per-rank bytes transferred (β count)
    bytes_reduced: float = 0.0  # per-rank bytes combined (γ count)

    def time(self, alpha: float, beta: float, gamma: float) -> float:
        return (self.steps * alpha + self.bytes_sent * beta
                + self.bytes_reduced * gamma)


def _split_sizes(n: int, w: int) -> list[int]:
    base, rem = divmod(n, w)
    return [base + (1 if i < rem else 0) for i in range(w)]


def ring_allreduce(vectors: np.ndarray, itemsize: int = 4
                   ) -> tuple[np.ndarray, CommStats]:
    """Classic ring: reduce-scatter (w-1 steps) + all-gather (w-1 steps)."""
    w, n = vectors.shape
    out = vectors.astype(np.float64).copy()
    stats = CommStats()
    if w == 1:
        return out, stats
    sizes = _split_sizes(n, w)
    bounds = np.cumsum([0] + sizes)
    seg = lambda i: slice(bounds[i % w], bounds[i % w + 1])

    # reduce-scatter: at step t, rank r sends segment (r - t) to rank r+1
    for t in range(w - 1):
        incoming = [out[(r - 1) % w, seg(r - 1 - t)].copy() for r in range(w)]
        for r in range(w):
            out[r, seg(r - 1 - t)] += incoming[r]
        stats.steps += 1
        stats.bytes_sent += max(sizes) * itemsize
        stats.bytes_reduced += max(sizes) * itemsize
    # all-gather: rank r owns segment (r+1); circulate w-1 steps
    for t in range(w - 1):
        incoming = [out[(r - 1) % w, seg(r - t)].copy() for r in range(w)]
        for r in range(w):
            out[r, seg(r - t)] = incoming[r]
        stats.steps += 1
        stats.bytes_sent += max(sizes) * itemsize
    return out, stats


def halving_doubling_allreduce(vectors: np.ndarray, itemsize: int = 4
                               ) -> tuple[np.ndarray, CommStats]:
    """Rabenseifner recursive halving (reduce-scatter) + doubling (gather).

    Only valid for w a power of two (the paper's doubling heuristic exists
    precisely to keep allocations on powers of two).
    """
    w, n = vectors.shape
    assert w & (w - 1) == 0, "halving-doubling requires power-of-two w"
    out = vectors.astype(np.float64).copy()
    stats = CommStats()
    if w == 1:
        return out, stats

    # Track each rank's owned interval [lo, hi) of the vector.
    lo = np.zeros(w, dtype=int)
    hi = np.full(w, n, dtype=int)
    steps = int(np.log2(w))
    for i in range(steps):
        dist = 2 ** i
        newlo, newhi = lo.copy(), hi.copy()
        for r in range(w):  # update owned intervals (keep half)
            mid = (lo[r] + hi[r]) // 2
            if r & dist:
                newlo[r], newhi[r] = mid, hi[r]
            else:
                newlo[r], newhi[r] = lo[r], mid
        # each rank receives its partner's sent half (the half the partner
        # does NOT keep == the half this rank keeps)
        buf = {}
        for r in range(w):
            p = r ^ dist
            a, b = newlo[r], newhi[r]
            buf[r] = (a, b, out[p, a:b].copy())
        for r in range(w):
            a, b, data = buf[r]
            out[r, a:b] += data
        lo, hi = newlo, newhi
        seg_bytes = (n / (2 ** (i + 1))) * itemsize
        stats.steps += 1
        stats.bytes_sent += seg_bytes
        stats.bytes_reduced += seg_bytes
    # doubling: reverse exchanges, each rank fills its partner's interval
    for i in reversed(range(steps)):
        dist = 2 ** i
        buf = {}
        for r in range(w):
            p = r ^ dist
            buf[r] = (lo[p], hi[p], out[p, lo[p]:hi[p]].copy())
        for r in range(w):
            a, b, data = buf[r]
            out[r, a:b] = data
            lo[r], hi[r] = min(lo[r], a), max(hi[r], b)
        stats.steps += 1
        stats.bytes_sent += (n / (2 ** (i + 1))) * itemsize
    return out, stats


def binary_blocks_allreduce(vectors: np.ndarray, itemsize: int = 4
                            ) -> tuple[np.ndarray, CommStats]:
    """Binary-blocks (Rabenseifner §4): decompose w = Σ 2^{b_i}; run
    halving-doubling inside each block, fold small blocks into larger ones,
    then redistribute.  Exact result; counters are per-rank worst case."""
    w, n = vectors.shape
    out = vectors.astype(np.float64).copy()
    stats = CommStats()
    if w == 1:
        return out, stats
    if w & (w - 1) == 0:
        return halving_doubling_allreduce(vectors, itemsize)

    # block decomposition, largest first: e.g. 11 = 8 + 2 + 1
    blocks = []
    start = 0
    rem = w
    while rem:
        b = 1 << (rem.bit_length() - 1)
        blocks.append((start, b))
        start += b
        rem -= b

    # intra-block reduce (halving-doubling result held at every block member)
    reduced = []
    worst = CommStats()
    for (s, b) in blocks:
        blk, st = halving_doubling_allreduce(out[s:s + b], itemsize)
        out[s:s + b] = blk
        reduced.append(blk[0])
        worst.steps = max(worst.steps, st.steps)
        worst.bytes_sent = max(worst.bytes_sent, st.bytes_sent)
        worst.bytes_reduced = max(worst.bytes_reduced, st.bytes_reduced)
    stats.steps += worst.steps
    stats.bytes_sent += worst.bytes_sent
    stats.bytes_reduced += worst.bytes_reduced

    # fold block partials into the big block (smallest -> next, pairwise),
    # one extra message round per extra block
    total = reduced[0].copy()
    for extra in reduced[1:]:
        total += extra
        stats.steps += 1
        stats.bytes_sent += n * itemsize
        stats.bytes_reduced += n * itemsize
    # broadcast back to all blocks (one round per extra block)
    for (s, b) in blocks:
        out[s:s + b] = total
    stats.steps += len(blocks) - 1
    stats.bytes_sent += (len(blocks) - 1) * n * itemsize
    return out, stats


ALGORITHMS = {
    "ring": ring_allreduce,
    "doubling_halving": halving_doubling_allreduce,
    "binary_blocks": binary_blocks_allreduce,
}


@functools.lru_cache(maxsize=4096)
def best_algorithm(w: int, n_bytes: float, threshold: float = 1e7) -> str:
    """Paper §2.1: doubling-halving wins for parameter sizes up to ~1e7 at
    power-of-two w; binary blocks otherwise; ring for very large tensors.

    LRU-cached: the scheduler hot path asks for the same (w, n) pairs over
    and over when building analytic speed tables.
    """
    if w & (w - 1) == 0:
        return "doubling_halving" if n_bytes <= threshold else "ring"
    return "binary_blocks"
