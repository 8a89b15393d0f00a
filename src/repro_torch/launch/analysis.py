"""Roofline terms of a dry-run step (torch twin of ``repro.launch.analysis``).

The dry-run (``launch.dryrun``) runs a step on ``meta`` DTensors over a
``fake`` process group and counts, for one device's shards:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

flops and bytes are those of each op that the step dispatches on its local
shards (``StepCounter``; a hand-written kernel counts as one op with its
own flops and bytes, ``kernels.ops.*_cost``). Collective bytes are counted
from the functional collectives the step dispatches: as the reference
counts its HLO collectives, each counts the bytes of its output, grouped
by kind.

Hardware constants: an NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core
GPU datasheet: 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3, and NVLink 4 at
900 GB/s a GPU, 450 GB/s each direction. The collective term charges
every mesh axis at NVLink speed. That is optimistic for axes that cross
nodes (InfiniBand is slower), but it is still a lower bound.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989.4e12      # bf16 dense, per H100 SXM5
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction per GPU


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: dict
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(cfg, shape, n_params_total: int, n_params_active: int
                ) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for
    inference forward (decode: D = new tokens)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * shape.global_batch  # decode: 1 token/seq


# functional collectives, by the reference's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# ops that move no data: views by another name, and new empty tensors
_NO_TRAFFIC = {"aten::_unsafe_view", "aten::lift_fresh", "aten::empty",
               "aten::empty_like", "aten::empty_strided", "aten::new_empty",
               "aten::new_empty_strided"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads of an input: its elements, but no more than
    its storage holds (an expanded view reads each stored element once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


# ops that read only the rows they gather from their source
_GATHERS = {"aten::index", "aten::embedding", "aten::gather", "aten::index_select"}


class StepCounter(TorchDispatchMode):
    """Counts the ops a step dispatches on local shards (plain tensors):
    flops by PyTorch's flop formulas, bytes as each op's inputs read and
    outputs written (views and ops that make an empty tensor move none; a
    gather reads the rows it gathers, an expanded input its storage),
    collective output bytes by kind, the peak of live intermediate
    storage, and the storages some op read. DTensor-level dispatches pass through to DTensor, which
    dispatches its local ops back here; the ops DTensor's sharding
    propagation runs on fake global tensors are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.read: set[int] = set()  # storages that some op took as input
        self._seen: set[int] = set()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(key=key, n=n):
            self._seen.discard(key)
            self.live -= n

        weakref.finalize(st, release)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        name = func._schema.name
        for a in _tensors((args, kwargs)):
            self.read.add(a.untyped_storage()._cdata)
        if name.startswith("_c10d_functional::"):
            kind = _COLLECTIVES.get(name.split("::")[1])
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0.0)
                                          + sum(map(_nbytes, _tensors(out))))
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out=out)
        outs = list(_tensors(out))
        if not (func.is_view or name in _NO_TRAFFIC):
            out_bytes = sum(map(_nbytes, outs))
            if name in _GATHERS:  # reads the rows it gathers, and the index
                read = out_bytes + sum(_read_bytes(t) for t in _tensors((args, kwargs))
                                       if not t.is_floating_point())
            else:
                read = sum(map(_read_bytes, _tensors((args, kwargs))))
            self.bytes += read + out_bytes
        for o in outs:
            self._track(o)
        return out
