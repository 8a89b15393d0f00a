"""Shared neural-net layers (torch twin of ``repro.models.layers``).

bf16 compute / f32 statistics, as in the reference. The two Pallas kernels
of the reference are wired in where its docstrings say they belong:
``rmsnorm`` goes to ``kernels.ops.rmsnorm`` and ``chunked_attention`` hands
the whole attention to ``kernels.ops.swa_attention``; on CUDA tensors those
launch the hand-written kernels, on CPU tensors the plain versions run.
Activations keep the reference's ``[B, S, H, D]`` layout.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.sharding.rules import ShardingRules, default_rules, placements

NEG_INF = -1e30


class Sharder:
    """Threads sharding hints through model code (the counterpart of the
    reference's ``with_sharding_constraint`` hook).

    ``mesh``: a ``DeviceMesh`` with named dims. On a DTensor, ``sh(x,
    *axes)`` redistributes ``x`` to the placements the rules give for
    ``x.shape`` and these logical axes. Without a mesh, or on a plain
    tensor, it is the identity, so the same model code serves one-device
    runs and sharded ones.
    """

    def __init__(self, mesh=None, rules: ShardingRules | None = None):
        self.mesh = mesh
        self.rules = rules or default_rules()
        if mesh is not None:
            from repro_torch.launch.mesh import abstract_mesh
            self.axes = abstract_mesh(mesh)

    def __call__(self, x, *axes):
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        want = placements(self.rules.spec_for(axes, x.shape, self.axes),
                          self.axes)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    @contextlib.contextmanager
    def context(self):
        """Where model code runs on DTensors: the tensors it makes itself
        (positions, aranges, masks) act as replicated DTensors, and DTensor
        takes its Python dispatch path (``_DTensorPythonPath``)."""
        if self.mesh is None:
            yield
            return
        with implicit_replication(), _DTensorPythonPath():
            yield


class _DTensorPythonPath(TorchDispatchMode):
    """A dispatch mode that changes nothing: DTensor ops go on to DTensor
    and plain ops run as they are. While a mode is active DTensor takes its
    Python dispatch path instead of its C++ fast path, which in torch 2.13
    hands some ops (a view, a slice's backward) the unsharded local tensor
    once a strategy shards one dim over two mesh dims."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **(kwargs or {}))


NO_SHARD = Sharder()


# ---------------------------------------------------------------- norms ----
def rmsnorm(x, w, eps=1e-6):
    return ops.rmsnorm(x, w, eps=eps)


def layernorm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(cfg, x, p, prefix=""):
    if cfg.norm == "layernorm":
        return layernorm(x, p[prefix + "scale"], p[prefix + "bias"])
    return rmsnorm(x, p[prefix + "scale"])


# ----------------------------------------------------------------- rope ----
def rope_freqs(d_half: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, d_half, dtype=np.float32) / d_half))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(d_half: int, theta: float, device: torch.device):
    # read-only, kept per device so that a decode step copies nothing
    return torch.from_numpy(rope_freqs(d_half, theta)).to(device)


def apply_rope(x, positions, theta: float,
               sections: tuple[int, ...] | None = None):
    """Rotate ``x [B, S, H, D]`` by integer ``positions``.

    positions: ``[B, S]`` for standard RoPE, or ``[B, S, 3]`` for M-RoPE
    with ``sections`` (t, h, w) splitting the half-dim (Qwen2-VL style):
    the first ``sections[0]`` frequencies turn with the t coordinate, the
    next ``sections[1]`` with h and the last ``sections[2]`` with w.
    """
    d_half = x.shape[-1] // 2
    freqs = _rope_freqs_on(d_half, theta, x.device)
    if sections is None:
        ang = positions[..., None].float() * freqs            # [B,S,d_half]
    else:
        if positions.dim() != 3 or sum(sections) != d_half:
            raise ValueError(f"M-RoPE: positions {tuple(positions.shape)} "
                             f"and sections {sections} for d_half {d_half}")
        parts, off = [], 0
        for i, sec in enumerate(sections):
            parts.append(positions[..., i, None].float() * freqs[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)                        # [B,S,d_half]
    cos = torch.cos(ang)[:, :, None, :]                       # [B,S,1,d_half]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x.float().split(d_half, dim=-1)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0):
    """softmax(QK^T/sqrt(d)) V over the whole sequence, through
    ``ops.swa_attention`` (flash-style: never an [Sq, Sk] tensor on the GPU).

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D] (KV already GQA-repeated; Sk may
    differ from Sq, as in cross-attention). ``q_offset``: the position of
    q[0] (prefill continuation, decode). Query i sits at p = q_offset + i;
    key j is visible to it iff (not causal or j <= p) and (no window or
    j > p - window). Unlike the reference's XLA path, the softmax weights
    are not rounded to bf16 before the product with V (the TPU kernel does
    not round them either); the difference is within bf16 tolerance.
    """
    if isinstance(q, DTensor):  # on the local shards, S and D whole
        return ops.on_local_shards(
            lambda *t: chunked_attention(*t, causal=causal, window=window,
                                         q_offset=q_offset),
            q, k, v, whole=(1, 3))
    b, sq, h, d = q.shape

    def to_bh(t):  # [B, S, H, D] -> [B*H, S, D], contiguous as the kernel
        # needs it (at B = 1 the reshape is a strided view of t)
        return t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], d).contiguous()

    out = ops.swa_attention(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                            window=window, q_offset=q_offset)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def write_slot(cache, new, pos) -> None:
    """``cache[b, pos[b]] = new[b]`` for every row b, in place. cache:
    [B, S, ...]; new: [B, ...]; pos: [B] int. A DTensor cache (its S
    possibly sharded, as the decode rules shard ``cache_seq``) is written on
    its local shards: each rank writes the rows whose slot lies in its part
    of S and keeps the others (static shapes: no index leaves the
    device)."""
    if not isinstance(cache, DTensor):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, place = cache.device_mesh, cache.placements
    if any(not isinstance(p, (Shard, Replicate)) for p in place):
        raise ValueError(f"cache placements {place}")
    # new [B, ...] follows the cache's dims but S; pos follows its batch
    new_place = [Replicate() if not isinstance(p, Shard) or p.dim == 1
                 else Shard(p.dim - (p.dim > 1)) for p in place]
    pos_place = [Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in place]
    new = new.redistribute(mesh, new_place).to_local()
    pos = pos.redistribute(mesh, pos_place).to_local()
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, place)
    lp = pos - offset[1]
    inside = (lp >= 0) & (lp < shape[1])
    lp = torch.clamp(lp, 0, shape[1] - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    keep = local[bidx, lp]
    mask = inside.reshape(-1, *([1] * (keep.dim() - 1)))
    local[bidx, lp] = torch.where(mask, new.to(local.dtype), keep)


def decode_attention(q, k_cache, v_cache, pos, *, window: int | None = None,
                     repeated: bool = False):
    """One-token attention against a cache (plain torch: the reference has
    no kernel here).

    q: [B, 1, H, D]; caches: [B, S, Hkv, D] (GQA-repeated already iff
    ``repeated``); pos: [B] int — number of valid tokens already in the
    cache (the new token occupies slot ``pos``). Scores and the product
    with V accumulate in f32; the softmax weights are rounded to q's dtype
    in between, as in the reference. DTensors run on their local shards:
    every op here is per (row, head), so the batch and head shards of q
    stay as they are, with S and D whole.
    """
    if isinstance(q, DTensor):
        q = ops._whole(q, (1, 3))
        place = tuple(q.placements)
        rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in place)
        places = (place, place, place, rows)
        return ops.on_local_shards_as(
            lambda *t: decode_attention(*t, window=window, repeated=repeated),
            (q, k_cache, v_cache, pos), places, places, place)
    b, s, hkv, d = k_cache.shape
    h = q.shape[2]
    if repeated:
        k, v = k_cache, v_cache
    else:
        k = repeat_kv(k_cache, h // hkv)
        v = repeat_kv(v_cache, h // hkv)
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(s, device=q.device)[None, :]             # [1,S]
    valid = kpos <= pos[:, None]
    if window is not None:
        valid &= kpos > (pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------- mlps -----
def _gelu(t):  # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(t, approximate="tanh")


def mlp(cfg, p, x):
    """Gated (silu, geglu) or plain (gelu, with biases) MLP from a layer
    param dict."""
    dt = x.dtype
    if cfg.activation in ("silu", "geglu"):
        act = F.silu if cfg.activation == "silu" else _gelu
        g = act(torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(dt)))
        u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(dt))
        return torch.einsum("bsf,fd->bsd", g * u, p["wo"].to(dt))
    if cfg.activation != "gelu":
        raise ValueError(f"unknown activation {cfg.activation!r}")
    h = _gelu(torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)) + p["wi_bias"].to(dt))
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt)) + p["wo_bias"].to(dt)


# ------------------------------------------------------------ positions ----
def sinusoidal(positions, d_model: int):
    """positions [B, S] -> [B, S, D] f32: the classic transformer sinusoid,
    sines then cosines of ``position * 10000^(-i / max(1, half - 1))``
    (the reference's divisor), in the reference's order of f32 ops."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-log_base * i / max(1, half - 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------- embeddings ----
def whole_dim(t, dim: int):
    """``t`` with dim ``dim`` whole on every rank: a DTensor sharded on it
    is gathered over that dim, anything else is returned as it is. An
    einsum over (heads, head_dim) flattens the pair, and torch 2.11's
    DTensor cannot flatten two dims when the inner one is sharded, which
    it is when the rules shard head_dim (their fallback when the model
    axis does not divide the heads)."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    place = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in t.placements]
    if place == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


def index_select(t, dim: int, index):
    """``t.index_select(dim, index)``; a DTensor runs on its local shards
    with ``dim`` whole (its backward then adds into local shards: DTensor
    has no index_add strategy in some torch versions)."""
    if isinstance(t, DTensor):
        return ops.on_local_shards(lambda x: x.index_select(dim, index), t,
                                   whole=(dim,))
    return t.index_select(dim, index)


def lookup(table, ids):
    """The rows of ``table`` at ``ids`` (an embedding). DTensors run on
    local shards. Over a mesh dim that splits the table's rows (the vocab)
    and not ``ids``, each rank looks up the ids its rows hold, zeros for
    the others, and the output is a pending sum over that dim (one
    all-reduce of the output where it is read, instead of gathering the
    table); over the other mesh dims the table is whole and the output is
    sharded as ``ids``, the table's local gradient a pending sum over the
    dims that split ``ids``."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    ids = ops._whole(ids, ())
    place = tuple(ids.placements)
    split = [isinstance(pt, Shard) and pt.dim == 0 and not isinstance(pi, Shard)
             for pt, pi in zip(table.placements, place)]
    rows = [Shard(0) if s else Replicate() for s in split]
    out = [Partial() if s else pi for s, pi in zip(split, place)]
    grad = [Shard(0) if s else Partial() if isinstance(pi, Shard) else Replicate()
            for s, pi in zip(split, place)]
    (n, _), (first, _) = compute_local_shape_and_global_offset(
        table.shape, table.device_mesh, rows)

    def local(t, i):
        j = i.long() - first
        held = (j >= 0) & (j < n)
        return t[j.clamp(0, n - 1)] * held[..., None].to(t.dtype)

    return ops.on_local_shards_as(local, (table, ids), (rows, place), (grad, place),
                                  tuple(out))


def embed_tokens(embedding, tokens, scale: float | None = None):
    x = lookup(embedding, tokens).to(torch.bfloat16)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=x.dtype)  # scale rounded to bf16 first
    return x


def lm_logits(x, out_embedding):
    """x [B,S,D] @ [V,D]^T -> [B,S,V] in f32."""
    return torch.einsum("bsd,vd->bsv", x.float(), out_embedding.float())


def _nll(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits [B,S,V] f32, labels [B,S]."""
    if isinstance(logits, DTensor):  # on the local rows, the vocab whole
        nll = ops.on_local_shards(_nll, logits, labels, whole=(-1,))
    else:
        nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = torch.as_tensor(mask, device=logits.device).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
