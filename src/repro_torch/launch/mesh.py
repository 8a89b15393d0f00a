"""The data-parallel process group (torch twin of ``make_data_mesh`` in
``repro.launch.mesh``).

The reference's pure data-parallel mesh of n devices becomes a
``torch.distributed`` group of n processes, one rank each; a global batch
is split along its leading axis as ``P("data")`` splits it. The production
and tiny meshes (sharding over a model axis) come with the sharding slice
(see ROADMAP.md).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.engine.steps import resolve_device


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

