"""Logical-axis sharding rules (torch twin of ``repro.sharding.rules``).

Models annotate every tensor dim with a logical axis name; a rule table maps
logical names to mesh axes. ``resolve_dim`` checks divisibility against the
actual mesh and falls back to replication when a dim does not divide (e.g.
40 query heads or vocab 51865 on a 16-way ``model`` axis), so one rule table
serves every architecture and mesh.

A mesh here is anything with a ``.shape`` mapping from axis name to size,
in the mesh's major-to-minor order: ``launch.mesh.AbstractMesh`` for the
rules alone, or ``launch.mesh.NamedMesh`` around a ``DeviceMesh``. A spec is
a tuple with one entry per tensor dim, each ``None``, an axis name, or a
tuple of axis names (the structure of the reference's ``PartitionSpec``).
``placements`` turns a spec into the DTensor placements of a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from torch.distributed.tensor import Replicate, Shard

from repro_torch.models import spec as pspec

# Default logical → mesh-axis rules for the production meshes.
#   batch:   data parallel (both pod and data axes when multi-pod)
#   heads / kv_heads / mlp / vocab / experts: tensor/expert parallel
#   cache_seq: context-parallel long decode (KV cache sharded along seq)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "ssm_heads": ("model",),
    "cache_seq": ("data",),
    # never sharded:
    "layers": (), "embed": (), "seq": (), "ssm_state": (), "head_dim": (),
    "conv": (), "chunks": (), "capacity": (), "patch": (), "frames": (),
}

Spec = tuple  # of None | str | tuple[str, ...], one entry per tensor dim


def _size(mesh, axes) -> int:
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Mapping[str, tuple[str, ...]]

    def mesh_axes_for(self, logical: str | None, mesh) -> tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.table.get(logical)
        if axes is None:
            return ()
        return tuple(a for a in axes if a in mesh.shape)

    def resolve_dim(self, logical: str | None, size: int, mesh,
                    used: set[str]) -> tuple[str, ...] | None:
        axes = tuple(a for a in self.mesh_axes_for(logical, mesh)
                     if a not in used)
        if not axes:
            return None
        if size % _size(mesh, axes) != 0:
            # try a prefix of the axes (e.g. drop "pod" but keep "data")
            while axes:
                axes = axes[:-1]
                if axes and size % _size(mesh, axes) == 0:
                    break
            if not axes:
                return None
        used.update(axes)
        return axes if len(axes) > 1 else (axes[0],)

    def spec_for(self, axes: Sequence[str | None], shape: Sequence[int],
                 mesh) -> Spec:
        used: set[str] = set()
        parts: list = []
        for name, size in zip(axes, shape):
            r = self.resolve_dim(name, size, mesh, used)
            if r is None:
                parts.append(None)
            elif len(r) == 1:
                parts.append(r[0])
            else:
                parts.append(r)
        # Secondary fallback: when a heads-like dim could not shard (e.g.
        # 40 q-heads or 8 kv-heads on a 16-way "model" axis), shard head_dim
        # instead so attention weights/activations never replicate fully.
        if "model" in mesh.shape and "model" not in used:
            # only when a *query/ssm* heads dim failed to shard — kv-only
            # tensors stay replicated (Megatron GQA convention) so q and kv
            # projections keep consistent layouts per architecture.
            wanted_model = any(
                n in ("heads", "ssm_heads") and parts[i] is None
                for i, n in enumerate(axes))
            if wanted_model:
                for i, (name, size) in enumerate(zip(axes, shape)):
                    if (name == "head_dim" and parts[i] is None
                            and size % mesh.shape["model"] == 0):
                        parts[i] = "model"
                        used.add("model")
                        break
        return tuple(parts)


def default_rules(overrides: Mapping[str, tuple[str, ...]] | None = None
                  ) -> ShardingRules:
    table = dict(DEFAULT_RULES)
    if overrides:
        table.update(overrides)
    return ShardingRules(table)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh axis, in
    the mesh's order. A tensor dim d over ``("pod", "data")`` is
    ``Shard(d)`` on both of those mesh dims; DTensor splits a dim sharded on
    several mesh dims in mesh order, which is the reference's major-to-minor
    order for every mesh here (pod before data before model)."""
    names = list(mesh.shape)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(spec: Spec, shape: Sequence[int], mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``
    (every sharded dim divides, as ``spec_for`` guarantees)."""
    out = []
    for part, size in zip(tuple(spec) + (None,) * (len(shape) - len(spec)),
                          shape):
        n = 1 if part is None else _size(
            mesh, part if isinstance(part, tuple) else (part,))
        if size % n:
            raise ValueError(f"dim {size} does not split {n} ways")
        out.append(size // n)
    return tuple(out)


def tree_pspecs(spec_tree, mesh, rules: ShardingRules | None = None):
    """Spec tree mirroring a TensorSpec tree."""
    rules = rules or default_rules()
    return pspec.tree_map(lambda s: rules.spec_for(s.axes, s.shape, mesh),
                          spec_tree)


def tree_placements(spec_tree, mesh, rules: ShardingRules | None = None):
    """DTensor placements tree mirroring a TensorSpec tree (the
    counterpart of the reference's ``tree_shardings``)."""
    rules = rules or default_rules()
    return pspec.tree_map(
        lambda s: placements(rules.spec_for(s.axes, s.shape, mesh), mesh),
        spec_tree)
