"""Executable ring / halving-doubling all-reduce over ``torch.distributed``
(torch twin of ``repro.collectives.xla``).

The paper's gradient-exchange algorithms as point-to-point messages
between processes: each round posts one send and one receive with
``dist.batch_isend_irecv`` and waits for both, so no schedule deadlocks on
ranks that all send first. A process group takes the place of the
reference's mesh axis (``group=None`` is the world). The schedules, the
padding to a multiple of the world size and the order of the additions
are the reference's, so in f32 every rank ends with the bits that
``repro.collectives.xla`` computes on the same inputs.

Transport. The group's backend decides how bytes move:

- ``nccl`` takes CUDA tensors directly, one card a rank
  (``launch.mesh.init_data_group`` binds the group to the rank's card, so
  every round reuses the world communicator). A round returns once the
  current stream waits for it; the host does not block, so a host-clock
  time must follow a device synchronisation. The in-place add of a round
  stays on the current stream: the next round's send and receive wait for
  it there, which is what makes reusing the receive buffer safe. On four
  H100s of one host the rounds and ``dist.all_reduce`` move the bytes
  over NVLink (``chip_nccl.py`` prints NCCL's transport, the schedules'
  bits against gloo's on the host, and the times);
- ``gloo`` moves host memory. A CUDA buffer is copied once into a pinned
  host buffer, every round runs on the host, and the result is copied
  back once: gloo is never handed a CUDA tensor. ``transport`` names the
  route a call takes ("gloo-host" for that staging).

Binary blocks has no executable path here, as in the reference; it stays
with the numpy schedules (``collectives.schedules``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import telemetry
from repro_torch.models.spec import flatten, unflatten


def _world(group) -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "repro_torch.launch.mesh.init_data_group (or "
            "torch.distributed.init_process_group) first")
    return dist.get_world_size(group), dist.get_rank(group)


def transport(group=None, x: torch.Tensor | None = None) -> str:
    """How an all-reduce of ``x`` over ``group`` moves its bytes: "nccl"
    (device memory), "gloo" (host tensors) or "gloo-host" (a CUDA tensor
    staged through pinned host memory)."""
    _world(group)
    backend = dist.get_backend(group)
    cuda = x is not None and x.is_cuda
    if backend == "nccl":
        if x is not None and not cuda:
            raise ValueError(f"an nccl group reduces CUDA tensors, got {x.device}")
        return "nccl"
    if backend == "gloo":
        return "gloo-host" if cuda else "gloo"
    raise ValueError(f"no transport for backend {backend!r}")


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _exchange(send: torch.Tensor, recv: torch.Tensor, to: int, frm: int,
              group) -> None:
    """One round: send ``send`` to rank ``to`` while receiving ``recv`` from
    rank ``frm`` (ranks of ``group``); returns when both are done (under
    nccl: when the current stream waits for both)."""
    ops = [dist.P2POp(dist.isend, send, _peer(group, to), group),
           dist.P2POp(dist.irecv, recv, _peer(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _ring_reduce_scatter(buf: torch.Tensor, w: int, r: int, group) -> None:
    """At step t rank r sends segment (r - t) to r + 1 and adds what it
    receives into segment (r - t - 1); rank r ends owning segment r + 1."""
    segs = buf.view(w, -1)
    recv = torch.empty_like(segs[0])
    for t in range(w - 1):
        _exchange(segs[(r - t) % w], recv, (r + 1) % w, (r - 1) % w, group)
        cur = segs[(r - t - 1) % w]
        torch.add(cur, recv, out=cur)


def _ring_all_gather(buf: torch.Tensor, w: int, r: int, group) -> None:
    """Rank r owns segment (r + 1); the owned segments circulate w - 1 steps."""
    segs = buf.view(w, -1)
    for t in range(w - 1):
        _exchange(segs[(r + 1 - t) % w], segs[(r - t) % w], (r + 1) % w,
                  (r - 1) % w, group)


def _ring(buf: torch.Tensor, w: int, r: int, group) -> None:
    _ring_reduce_scatter(buf, w, r, group)
    _ring_all_gather(buf, w, r, group)


def _halving_doubling(buf: torch.Tensor, w: int, r: int, group) -> None:
    """Recursive halving (partner r ^ 2^i; keep the lower half when bit i of
    r is 0), then recursive doubling in reverse."""
    steps = w.bit_length() - 1
    lo, size = 0, buf.numel()
    recv = torch.empty(size // 2, dtype=buf.dtype, device=buf.device)
    for i in range(steps):
        partner, half = r ^ (1 << i), size // 2
        bit = (r >> i) & 1
        keep_lo, send_lo = lo + bit * half, lo + (1 - bit) * half
        _exchange(buf[send_lo:send_lo + half], recv[:half], partner, partner, group)
        kept = buf[keep_lo:keep_lo + half]
        torch.add(kept, recv[:half], out=kept)
        lo, size = keep_lo, half
    for i in reversed(range(steps)):
        partner = r ^ (1 << i)
        partner_lo = lo - size if (r >> i) & 1 else lo + size
        _exchange(buf[lo:lo + size], buf[partner_lo:partner_lo + size],
                  partner, partner, group)
        lo, size = min(lo, partner_lo), 2 * size


def _psum(buf: torch.Tensor, w: int, r: int, group) -> None:
    dist.all_reduce(buf, group=group)


_SCHEDULES = {"ring": _ring, "doubling_halving": _halving_doubling, "psum": _psum}


def allreduce_(x: torch.Tensor, group=None, algorithm: str = "ring") -> torch.Tensor:
    """Sum the 1-D contiguous tensor ``x`` over ``group``, in place; returns ``x``.

    The port's flat gradient buffer (``optim.sgd``'s fusion buffer) is
    reduced by this call. ``algorithm``: "ring", "doubling_halving" (a
    world size that is a power of two) or "psum" (``dist.all_reduce``, in
    the backend's own order). The buffer is padded with zeros to a
    multiple of the world size, as ``repro.collectives.xla._pad_to`` does.
    Under ``core.telemetry.tracing`` each call counts ``collectives.calls``
    and its payload's ``collectives.bytes`` (x's, unpadded).
    """
    if algorithm not in _SCHEDULES:
        raise ValueError(f"unknown all-reduce algorithm {algorithm!r}; "
                         f"expected one of {sorted(_SCHEDULES)}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"allreduce_ takes a 1-D contiguous tensor, got "
                         f"shape {tuple(x.shape)}")
    w, r = _world(group)
    if algorithm == "doubling_halving" and w & (w - 1):
        raise ValueError(f"halving-doubling needs a power-of-two world size, got {w}")
    n = x.numel()
    telemetry.count("collectives.calls")
    telemetry.count("collectives.bytes", n * x.element_size())
    if w == 1:
        return x
    pad = 0 if algorithm == "psum" else (-n) % w
    if transport(group, x) == "gloo-host":
        buf = torch.empty(n + pad, dtype=x.dtype, pin_memory=True)
    elif pad:
        buf = torch.empty(n + pad, dtype=x.dtype, device=x.device)
    else:
        buf = x
    if buf is not x:
        buf[:n].copy_(x)
        buf[n:].zero_()
    _SCHEDULES[algorithm](buf, w, r, group)
    if buf is not x:
        x.copy_(buf[:n])
    return x


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-reduce of a 1-D vector into a new tensor: reduce-scatter in
    w - 1 steps of ceil(n / w) elements, then all-gather in w - 1 more."""
    return allreduce_(x.clone(), group, "ring")


def halving_doubling_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rabenseifner recursive halving/doubling of a 1-D vector into a new
    tensor, over a group whose size is a power of two (ValueError otherwise)."""
    return allreduce_(x.clone(), group, "doubling_halving")


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_reduce`` of a 1-D vector into a new tensor (the backend's order)."""
    return allreduce_(x.clone(), group, "psum")


ALGORITHMS = {"ring": ring_allreduce,
              "doubling_halving": halving_doubling_allreduce,
              "psum": psum}


def exchange_tree(tree: dict, group=None, algorithm: str = "ring") -> dict:
    """Horovod-style exchange of a nested dict of tensors: the leaves, in
    sorted-key order, go into one f32 fusion buffer, which is all-reduced;
    each leaf comes back with its shape and dtype."""
    leaves = flatten(tree)
    flat = torch.cat([v.reshape(-1).float() for v in leaves.values()])
    allreduce_(flat, group, algorithm)
    out, off = {}, 0
    for path, v in leaves.items():
        out[path] = flat[off:off + v.numel()].view(v.shape).to(v.dtype)
        off += v.numel()
    return unflatten(out)
