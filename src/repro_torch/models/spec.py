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


def _std(s: TensorSpec) -> float:
    """The standard deviation of a random leaf, from its spec's (global)
    shape."""
    if s.init == "embed":
        return s.scale / math.sqrt(s.shape[-1])
    if s.init == "normal":
        return s.scale
    if s.init == "fan_in":
        # fan-in = product of all dims except the last output dim; for
        # stacked-layer params ignore the leading "layers" dim.
        dims = list(s.shape)
        fan_dims = dims[1:-1] if s.axes and s.axes[0] == "layers" else dims[:-1]
        fan_in = max(1, int(np.prod(fan_dims)) if fan_dims else dims[-1])
        return s.scale / math.sqrt(fan_in)
    raise ValueError(f"unknown init {s.init!r}")


def _draw(gen: torch.Generator, s: TensorSpec, shape, device) -> torch.Tensor:
    """A leaf of ``shape`` (the spec's, or a local shard's) drawn as the
    spec ``s`` says, with the standard deviation of ``s``."""
    if s.init == "zeros":
        return torch.zeros(shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(shape, dtype=s.dtype, device=device)
    std = _std(s)
    if math.prod(shape) <= _MAX_DRAW:
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * std).to(s.dtype)
    out = torch.empty(shape, dtype=s.dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * std)
    return out


def _init_one(gen: torch.Generator, s: TensorSpec, device) -> torch.Tensor:
    return _draw(gen, s, s.shape, device)


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



# ---------------------------------------------- abstract and sharded trees --
def is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def tree_map(fn, tree):
    """``fn`` of each TensorSpec leaf of a nested dict, in the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract(tree) -> dict:
    """A tree of ``meta`` tensors of the specs' shapes and dtypes (the
    counterpart of the reference's ShapeDtypeStruct tree): no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    tree)


def cast(tree, dtype: torch.dtype) -> dict:
    """Spec tree with dtype replaced (e.g. bf16 serving params)."""
    return tree_map(lambda s: dataclasses.replace(s, dtype=dtype), tree)


def local_specs(tree, mesh, rules) -> dict:
    """The spec tree of one device's shards: each leaf's shape cut as the
    rules shard it on ``mesh`` (a DeviceMesh or an AbstractMesh)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.sharding.rules import local_shape

    m = abstract_mesh(mesh)
    return tree_map(lambda s: dataclasses.replace(
        s, shape=local_shape(rules.spec_for(s.axes, s.shape, m), s.shape, m)),
        tree)


def as_dtensors(local_tree: dict, spec_tree: dict, mesh, rules) -> dict:
    """Wrap each local shard of ``local_tree`` (a tree of tensors, or of
    tuples of per-layer tensors for a stacked leaf) as the DTensor of its
    spec's global shape and the rules' placements. No data moves."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.sharding.rules import placements

    m = abstract_mesh(mesh)
    flat_local, out = flatten(local_tree), {}
    for path, s in flatten(spec_tree).items():
        place = placements(rules.spec_for(s.axes, s.shape, m), m)
        t = flat_local[path]
        if isinstance(t, tuple):  # per-layer slices of a stacked leaf
            inner = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                          for p in place)
            if any(isinstance(p, Shard) and p.dim == 0 for p in place):
                raise ValueError(f"{path}: a sharded layers dim cannot be unbound")
            out[path] = tuple(DTensor.from_local(
                ti, mesh, inner, run_check=False, shape=torch.Size(s.shape[1:]),
                stride=_contiguous_stride(s.shape[1:])) for ti in t)
        else:
            out[path] = DTensor.from_local(
                t, mesh, place, run_check=False, shape=torch.Size(s.shape),
                stride=_contiguous_stride(s.shape))
    return unflatten(out)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distributed(tree: dict, mesh, rules, device) -> dict:
    """A spec tree as DTensors of zeros on ``mesh``: each rank holds a
    local shard of the shape the rules give, on ``device`` (``meta``, the
    dry-run's: nothing is allocated)."""
    local = local_specs(tree, mesh, rules)
    shards = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                      local)
    return as_dtensors(shards, tree, mesh, rules)


def init_local(seed: int, tree: dict, mesh, rules, device) -> dict:
    """A seeded random spec tree as DTensors on ``mesh`` (a DeviceMesh),
    each rank drawing only its own local shards: no rank ever holds a
    global leaf (dbrx-132b's are 263 GB in bf16).

    Each leaf is drawn in the local shape the rules give, with the
    standard deviation of its global spec (a fan-in read from the local
    shape would count only the local heads or experts). Its generator is
    seeded by ``seed``, the leaf's path and the global offset of the
    rank's shard, so ranks that hold the same shard (on mesh dims the
    leaf is replicated over) draw the same values, and ranks that hold
    different shards draw different ones. On ``meta`` nothing is drawn."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.sharding.rules import placements

    m = abstract_mesh(mesh)
    shards = {}
    for path, s in flatten(tree).items():
        place = placements(rules.spec_for(s.axes, s.shape, m), m)
        shape, offset = compute_local_shape_and_global_offset(s.shape, mesh, place)
        if torch.device(device).type == "meta":
            shards[path] = torch.empty(shape, dtype=s.dtype, device="meta")
            continue
        name = path.encode()
        key = np.random.SeedSequence([seed, len(name), *name, *offset])
        gen = torch.Generator(device=device).manual_seed(
            int(key.generate_state(1, np.uint64)[0]))
        shards[path] = _draw(gen, s, shape, device)
    return as_dtensors(unflatten(shards), tree, mesh, rules)
