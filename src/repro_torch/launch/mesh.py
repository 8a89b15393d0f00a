"""Meshes and process groups (torch twin of ``repro.launch.mesh``).

The reference's pure data-parallel mesh of n devices becomes a
``torch.distributed`` group of n processes, one rank each; a global batch
is split along its leading axis as ``P("data")`` splits it
(``init_data_group``, ``local_rows``).

The production meshes are 16 x 16 ``("data", "model")`` = 256 devices, or
2 x 16 x 16 ``("pod", "data", "model")`` = 512; the tiny ones, 2 x 4 and
2 x 2 x 2 (8 devices). ``make_production_mesh`` and ``make_tiny_mesh``
build a ``DeviceMesh`` over the default process group, which must hold as
many ranks as the mesh; they are functions, so importing this module
touches no process group. ``join_fake_group`` joins a ``fake`` group of a
mesh's size in one process (collectives return at once and move
nothing): the dry-run's. ``AbstractMesh`` is a mesh's names and sizes
alone, for the sharding rules.
"""
from __future__ import annotations

import dataclasses
import datetime
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.engine.steps import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, major to minor; ``shape`` maps name to size,
    as the sharding rules read a mesh."""

    sizes: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def tiny_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """Scaled-down mesh (8 devices) for CPU tests."""
    if multi_pod:
        return AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    return AbstractMesh((2, 4), ("data", "model"))


def abstract_mesh(mesh) -> AbstractMesh:
    """The names and sizes of a DeviceMesh (or an AbstractMesh itself)."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def device_mesh(shape: AbstractMesh, device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh of ``shape`` over the default process group.
    ``device_type``: "cuda" when the group's backend is nccl, else "cpu"
    (gloo, and the fake group, whose tensors may live on meta)."""
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised default process "
                           "group (init_data_group or join_fake_group)")
    if dist.get_world_size() != shape.size:
        raise ValueError(f"a {'x'.join(map(str, shape.sizes))} mesh needs "
                         f"{shape.size} ranks, the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    return device_mesh(production_mesh_shape(multi_pod=multi_pod), device_type)


def make_tiny_mesh(*, multi_pod: bool = False,
                   device_type: str | None = None) -> DeviceMesh:
    return device_mesh(tiny_mesh_shape(multi_pod=multi_pod), device_type)


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` default group of ``world``
    ranks (a group joined before is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def init_data_group(rank: int, world: int, init_method: str, backend: str,
                    device="cuda", timeout_s: float = 300.0) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group and
    return the device its step runs on.

    ``init_method``: a rendezvous, such as ``file:///tmp/<fresh dir>/rdzv``
    or ``tcp://localhost:<port>``. ``backend``: "gloo" (host memory; a CUDA
    buffer is staged through pinned host memory by ``collectives.dist``)
    or "nccl". ``device`` is the card unless the caller asks for the CPU;
    several ranks may share one card. A collective that waits longer than
    ``timeout_s`` raises instead of hanging.
    """
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows ``[rank * m, (rank + 1) * m)`` of a global batch
    of ``m * world`` rows (numpy arrays or tensors)."""
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries differ in length: {sorted(sizes)}")
    (b,) = sizes
    if b % world:
        raise ValueError(f"a global batch of {b} rows does not split over {world} ranks")
    m = b // world
    return {k: v[rank * m:(rank + 1) * m] for k, v in batch.items()}

