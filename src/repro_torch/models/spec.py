"""Parameter specification trees (torch twin of ``repro.models.spec``).

Models declare their parameters as nested dicts of :class:`TensorSpec`.
Real tensors are drawn from an explicit ``torch.Generator``; the draws do
not reproduce ``jax.random`` (tests bridge the reference's weights in
through ``repro_torch.bridge`` instead).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (or None)
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def flatten(tree: dict, prefix: str = "") -> dict[str, object]:
    """Leaves of a nested dict keyed by ``/``-joined paths, in the order
    ``repro.checkpoint.store._flatten`` writes them (sorted keys)."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def unflatten(flat: dict[str, object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def n_params(tree: dict) -> int:
    return sum(math.prod(s.shape) for s in flatten(tree).values())


# A leaf whose f32 draw would hold more elements than this is drawn one
# slice of its leading dim at a time, with the same std: a qwen3-moe-30b-a3b
# expert leaf [48, 128, 2048, 768] would otherwise need a 38.7 GB f32
# transient beside the bf16 weights already drawn. Smaller leaves draw
# the whole leaf at once.
_MAX_DRAW = 1 << 31


def _init_one(gen: torch.Generator, s: TensorSpec, device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "embed":
        std = s.scale / math.sqrt(s.shape[-1])
    elif s.init == "normal":
        std = s.scale
    elif s.init == "fan_in":
        # fan-in = product of all dims except the last output dim; for
        # stacked-layer params ignore the leading "layers" dim.
        dims = list(s.shape)
        fan_dims = dims[1:-1] if s.axes and s.axes[0] == "layers" else dims[:-1]
        fan_in = max(1, int(np.prod(fan_dims)) if fan_dims else dims[-1])
        std = s.scale / math.sqrt(fan_in)
    else:
        raise ValueError(f"unknown init {s.init!r}")
    if math.prod(s.shape) <= _MAX_DRAW:
        x = torch.randn(s.shape, generator=gen, device=device, dtype=torch.float32)
        return (x * std).to(s.dtype)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * std)
    return out


class FlatTree(dict):
    """A nested dict of tensors whose leaves are views, in ``flatten``'s
    path order, into one contiguous 1-D buffer ``flat``: an update of
    ``flat`` is an update of every leaf, and a copy into a leaf writes
    ``flat``. The optimizer updates the whole buffer at once."""

    flat: torch.Tensor

    def shapes(self) -> dict[str, tuple[int, ...]]:
        return {p: tuple(v.shape) for p, v in flatten(self).items()}

    def zeros_like(self) -> "FlatTree":
        return views(torch.zeros_like(self.flat), self.shapes())


def views(flat: torch.Tensor, shapes: dict[str, tuple[int, ...]]) -> FlatTree:
    """A FlatTree over ``flat``: the leaf at each path of ``shapes`` (in
    ``flatten``'s order) views the next ``prod(shape)`` elements."""
    order = flatten(unflatten(dict(shapes)))
    total = sum(math.prod(s) for s in order.values())
    if flat.dim() != 1 or flat.numel() != total or not flat.is_contiguous():
        raise ValueError(f"flat buffer {tuple(flat.shape)} cannot hold "
                         f"{total} elements")
    leaves, off = {}, 0
    for path, shape in order.items():
        size = math.prod(shape)
        leaves[path] = flat[off:off + size].view(shape)
        off += size
    out = FlatTree(unflatten(leaves))
    out.flat = flat
    return out


def flat_tree(tree: dict, device=None) -> FlatTree:
    """Copy the leaves of ``tree`` into one new flat f32 buffer."""
    leaves = flatten(tree)
    first = next(iter(leaves.values()))
    flat = torch.empty(sum(t.numel() for t in leaves.values()),
                       dtype=torch.float32,
                       device=first.device if device is None else device)
    out = views(flat, {p: tuple(t.shape) for p, t in leaves.items()})
    for path, v in flatten(out).items():
        v.copy_(leaves[path])
    return out


def init_params(generator: torch.Generator, tree: dict, device) -> dict:
    """Materialize real parameters from a spec tree, one draw per leaf in
    path order. ``generator`` must live on ``device``."""
    flat = flatten(tree)
    return unflatten({p: _init_one(generator, s, device)
                      for p, s in flat.items()})


def init_flat(generator: torch.Generator, tree: dict, device) -> FlatTree:
    """``init_params``'s draws, written leaf by leaf into one flat f32
    buffer (no second full-size copy): the same values as
    ``flat_tree(init_params(...))``. Every spec must be f32."""
    specs = flatten(tree)
    if any(s.dtype != torch.float32 for s in specs.values()):
        raise TypeError("init_flat keeps f32 parameters only")
    flat = torch.empty(sum(math.prod(s.shape) for s in specs.values()),
                       dtype=torch.float32, device=device)
    out = views(flat, {p: s.shape for p, s in specs.items()})
    for path, v in flatten(out).items():
        v.copy_(_init_one(generator, specs[path], device))
    return out

