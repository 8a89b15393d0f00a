"""The weights both sides are given: one flat f32 buffer drawn from the
seed on the device, in fixed chunks, so that any part of it can be drawn
again later without keeping a copy.

A layout (``reference.<family>.layout``) maps each parameter path to a
``Leaf``: its shape and how it is drawn. The flat buffer holds the leaves
in the program's order (paths sorted by their components, as
``repro_torch.models.spec.flatten`` orders them). Chunk ``c`` of the buffer
is ``randn`` from a generator seeded by (seed, c); each leaf's part of it is
then scaled by the leaf's std, or set to 0 or 1.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

CHUNK = 1 << 27  # elements a draw: 512 MiB of f32


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's shape and draw: ``normal`` (N(0, std**2)), ``zeros``,
    ``ones``, ``a_log`` (log A, A ~ U[lo, hi]) or ``dt_bias`` (the inverse
    softplus of dt, log dt ~ U[log lo, log hi], dt at least 1e-4): the last
    two are Mamba-2's published initialisation of A and dt."""
    shape: tuple[int, ...]
    init: str = "normal"
    std: float = 1.0
    lo: float = 0.0
    hi: float = 1.0


def order(layout: dict) -> list[str]:
    return sorted(layout, key=lambda p: p.split("/"))


def offsets(layout: dict) -> list[tuple[str, int, int]]:
    """(path, start, end) of each leaf in the flat buffer."""
    out, off = [], 0
    for path in order(layout):
        n = math.prod(layout[path].shape)
        out.append((path, off, off + n))
        off += n
    return out


def total(layout: dict) -> int:
    return sum(math.prod(leaf.shape) for leaf in layout.values())


def segments(layout: dict, stacks: dict) -> list[tuple[str, int, int]]:
    """The leaves the comparison reads, in flat order. ``stacks`` maps a
    path prefix to a stack's depth: a leaf stacked over it (its path under
    the prefix, its first dim the depth) gives one segment a layer,
    ``path[i]``; any other leaf one segment. A decoder of one stack has
    ``{"layers/": n_layers}``."""
    out = []
    for path, a, b in offsets(layout):
        shape = layout[path].shape
        depth = next((n for prefix, n in stacks.items()
                      if path.startswith(prefix) and shape and shape[0] == n), None)
        if depth is not None:
            per = (b - a) // depth
            out += [(f"{path}[{i}]", a + i * per, a + (i + 1) * per)
                    for i in range(depth)]
        else:
            out.append((path, a, b))
    return out


def chunk_seed(seed: int, c: int) -> int:
    digest = hashlib.blake2b(f"{seed}:{c}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _fill(out: torch.Tensor, c0: int, layout: dict, gen: torch.Generator,
          seed: int, c: int) -> None:
    """Chunk c, starting at flat offset c0, drawn into ``out``."""
    gen.manual_seed(chunk_seed(seed, c))
    torch.randn(out.shape, generator=gen, out=out)
    c1 = c0 + out.numel()
    for path, a, b in offsets(layout):
        lo, hi = max(a, c0), min(b, c1)
        if lo >= hi:
            continue
        part, leaf = out[lo - c0:hi - c0], layout[path]
        if leaf.init == "zeros":
            part.zero_()
        elif leaf.init == "ones":
            part.fill_(1.0)
        elif leaf.init == "normal":
            part.mul_(leaf.std)
        else:  # uniform on (0, 1) from the normal draw
            u = 0.5 * (1.0 + torch.erf(part / math.sqrt(2.0)))
            if leaf.init == "a_log":
                part.copy_(torch.log(leaf.lo + (leaf.hi - leaf.lo) * u))
            elif leaf.init == "dt_bias":
                dt = torch.exp(math.log(leaf.lo) + u * math.log(leaf.hi / leaf.lo))
                dt.clamp_(min=1e-4)
                part.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"unknown init {leaf.init!r} of {path}")


def draw(layout: dict, seed: int, device) -> torch.Tensor:
    """The flat f32 buffer of ``layout`` drawn from ``seed`` on ``device``."""
    flat = torch.empty(total(layout), dtype=torch.float32, device=device)
    gen = torch.Generator(device=flat.device)
    for c, c0 in enumerate(range(0, flat.numel(), CHUNK)):
        _fill(flat[c0:c0 + CHUNK], c0, layout, gen, seed, c)
    return flat


def chunks(layout: dict, seed: int, device):
    """Yield (start, chunk) of ``draw(layout, seed, device)``, one chunk at a
    time, each drawn again into the same scratch buffer."""
    n = total(layout)
    buf = torch.empty(min(CHUNK, n), dtype=torch.float32, device=device)
    gen = torch.Generator(device=buf.device)
    for c, c0 in enumerate(range(0, n, CHUNK)):
        part = buf[:min(CHUNK, n - c0)]
        _fill(part, c0, layout, gen, seed, c)
        yield c0, part


def segment_norms(flat: torch.Tensor, segs, minus=None) -> list[float]:
    """The L2 norm of each segment of ``flat`` (f32 on its device), or of
    ``flat - minus`` where ``minus`` yields (start, chunk) covering the
    buffer in order (``chunks``). One host read at the end."""
    sq = torch.zeros(len(segs), dtype=torch.float64, device=flat.device)
    spans = [(0, flat)] if minus is None else minus
    for c0, chunk in spans:
        c1 = c0 + chunk.numel()
        part = flat[c0:c1] if minus is None else flat[c0:c1].float() - chunk
        for j, (_, a, b) in enumerate(segs):
            lo, hi = max(a, c0), min(b, c1)
            if lo < hi:
                sq[j] += torch.linalg.vector_norm(part[lo - c0:hi - c0]).double() ** 2
    return sq.sqrt().tolist()


def nonzero_rows(flat: torch.Tensor, layout: dict) -> int:
    """How many rows of the leaves hold an element that is not zero: a
    leaf of two or more dims has its first dim's rows, any other is one
    row. A row of a matrix is all zero by the data (an embedding row no
    token names), never by rounding alone."""
    n = 0
    for path, a, b in offsets(layout):
        shape = layout[path].shape
        rows = shape[0] if len(shape) >= 2 else 1
        n += int(torch.count_nonzero(flat[a:b].view(rows, -1).ne(0).any(dim=1)))
    return n
