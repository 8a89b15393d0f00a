"""Mixture-of-Experts FFN with group-local sort-based capacity dispatch
(torch twin of ``repro.models.moe``).

GShard-style semantics: each batch row is a dispatch *group* with capacity
C = ceil(S * top_k * cf / E), rounded up to 8. Within a group the
token->expert assignments are sorted stably by expert and gathered into a
static [B, E, C, D] buffer; assignments past an expert's C slots are
dropped. Every shape is static and no index leaves the device, so a step
never waits on the host (no ``.item()``, ``.nonzero()`` or boolean-mask
indexing). The router's load-balance aux loss follows Switch Transformer.

The expert products are plain ``torch.einsum``s: the reference computes
them outside any Pallas kernel, so there is no kernel here to port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.spec import TensorSpec as TS


def moe_specs(cfg: ModelConfig, n: int, dtype: torch.dtype = torch.float32) -> dict:
    """Router and expert weights, stored in ``dtype`` (the model's
    ``param_dtype``; the reference casts all four to the activation dtype
    at use)."""
    Lx, D, F_, E = n, cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": TS((Lx, D, E), ("layers", "embed", None), dtype),
        "wi_gate": TS((Lx, E, D, F_), ("layers", "experts", "embed", "mlp"), dtype),
        "wi_up": TS((Lx, E, D, F_), ("layers", "experts", "embed", "mlp"), dtype),
        "wo": TS((Lx, E, F_, D), ("layers", "experts", "mlp", "embed"), dtype),
    }


def expert_only_specs(param_specs: dict) -> dict:
    """Subtree of per-expert weights (for active-param accounting), keyed
    by ``/``-joined path."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif "experts" in (tree.axes or ()):
            out["/".join(path)] = tree

    walk(param_specs, ())
    return out


def group_capacity(group_tokens: int, cfg: ModelConfig) -> int:
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to 8


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last dim, largest first, ties to the lower
    index, as ``jax.lax.top_k``. The router's logits are bf16 values, so
    exact ties are common; a stable sort breaks them the same way for
    every shape (``torch.topk`` promises no order among ties)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _dispatch_indices(eid: torch.Tensor, E: int, C: int):
    """Group-local sorted dispatch of top-k choices ``eid`` [B, S, K] into
    E experts of C slots -> (src_tok [B, E*C]: the token in each slot,
    valid [B, E, C]: the slot is filled, idx [B, S*K]: each assignment's
    slot in E*C, live [B, S*K]: the assignment was kept). Each batch row is
    its own group."""
    B, S, K = eid.shape
    SK = S * K
    dev = eid.device
    flat_e = eid.reshape(B, SK)
    order = torch.argsort(flat_e, dim=-1, stable=True)               # [B,SK]
    sorted_e = torch.gather(flat_e, 1, order)
    # per-group expert boundaries via batched searchsorted
    bounds = torch.searchsorted(
        sorted_e, torch.arange(E + 1, device=dev).expand(B, E + 1).contiguous(),
        side="left")                                                 # [B,E+1]
    counts = bounds[:, 1:] - bounds[:, :-1]                          # [B,E]
    offsets = bounds[:, :-1]
    cap = torch.arange(C, device=dev)
    slot = offsets[:, :, None] + cap                                 # [B,E,C]
    valid = cap < counts[:, :, None]
    slot = torch.clamp(slot, 0, SK - 1)
    src = torch.gather(order, 1, slot.reshape(B, E * C))
    src_tok = src // K                                               # [B,E*C]
    # Each assignment gathers its expert's output through the inverse of
    # the sort permutation; one past its expert's C slots was dropped.
    inv = torch.argsort(order, dim=-1)                     # rank of asgn i
    slot = inv - torch.gather(offsets, 1, flat_e)                    # [B,SK]
    live = slot < C
    slot = torch.clamp(slot, 0, C - 1)
    idx = flat_e * C + slot                                # [B,SK] into E*C
    return src_tok, valid, idx, live


def _gather_tokens(x, src_tok, valid):
    """[B, S, D] tokens into their [B, E, C, D] expert slots."""
    B, EC = src_tok.shape
    E, C = valid.shape[1:]
    D = x.shape[-1]
    gx = torch.gather(x, 1, src_tok[..., None].expand(B, EC, D))     # [B,EC,D]
    return gx.reshape(B, E, C, D) * valid[..., None].to(x.dtype)


def _combine(eo, idx, live, gate):
    """Each token's gate-weighted sum of its experts' outputs (gather-based:
    no scatter) -> [B, S, D]."""
    B, E, C, D = eo.shape
    SK = idx.shape[1]
    S, K = gate.shape[1:]
    gathered = torch.gather(eo.reshape(B, E * C, D), 1,
                            idx[..., None].expand(B, SK, D))         # [B,SK,D]
    w = (gate.reshape(B, SK) * live.float()).to(eo.dtype)
    return (gathered * w[..., None]).reshape(B, S, K, D).sum(dim=2)


def _batch_local(fn, *ts):
    """``fn`` on each rank's own batch rows: DTensors run on their local
    shards with every dim but the batch dim whole (the dispatch is
    group-local, a group being a batch row); plain tensors run as they
    are."""
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    return ops.on_local_shards(fn, *ts, whole=range(1, 8))


def moe_ffn(cfg: ModelConfig, p, x, sh):
    """x: [B, S, D] -> (out [B, S, D], aux_loss 0-d f32)."""
    dt = x.dtype
    E, K = cfg.n_experts, cfg.top_k
    C = group_capacity(x.shape[1], cfg)

    logits = torch.einsum("bsd,de->bse", x, p["router"].to(dt)).float()  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate, eid = _batch_local(lambda t: _top_k(t, K), probs)          # [B,S,K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance loss.
    experts = torch.arange(E, device=x.device)
    frac = (eid[..., 0, None] == experts).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    # ---- group-local sorted dispatch ------------------------------------
    src_tok, valid, idx, live = _batch_local(
        lambda e: _dispatch_indices(e, E, C), eid)
    gx = _batch_local(_gather_tokens, x, src_tok, valid)
    gx = sh(gx, "batch", "experts", "capacity", "embed")

    # ---- expert FFN (gated silu) ----------------------------------------
    g = F.silu(torch.einsum("becd,edf->becf", gx, p["wi_gate"].to(dt)))
    u = torch.einsum("becd,edf->becf", gx, p["wi_up"].to(dt))
    eo = torch.einsum("becf,efd->becd", g * u, p["wo"].to(dt))       # [B,E,C,D]
    eo = sh(eo, "batch", "experts", "capacity", "embed")

    # ---- combine ---------------------------------------------------------
    out = _batch_local(_combine, eo, idx, live, gate)
    return out.to(dt), aux
