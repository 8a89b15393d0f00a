"""Mamba-2 (SSD, state-space duality): torch twin of ``repro.models.mamba2``.

Training and prefill use the chunked SSD form: within a chunk of length Q
the quadratic (attention-like) branch is a batched matmul; across chunks
a Python loop (the reference's ``lax.scan``) carries the f32
``[B, H, P, N]`` state. Only one chunk's ``[B, Q, Q, H]`` score block is
live at a time. Decode is the O(1) recurrence over conv windows and the
SSM state, updated in place in the cache (the reference returns a new
state instead).

The SSD's products are plain torch ops, as they are plain ``jnp`` in the
reference; the one kernel on this path is ``rmsnorm``: the pre-norm of
each layer (weight ``[D]``) and the gated norm of the mixer's output
(``y [B, S, H, P]``, a weight per head ``[H, P]``).

Parameters follow ``models.transformer``: nested dicts of tensors stacked
on a leading ``[n_layers]`` axis, a Python loop over the layers, and
``param_dtype`` (bf16 to serve, f32 masters to train) for the weights
the reference casts to the activation dtype at use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec as TS, init_flat, init_params
from repro_torch.models.transformer import _layer_params

NEG_INF = -1e30


def mamba_specs(cfg: ModelConfig, n: int, dtype: torch.dtype = torch.float32) -> dict:
    """One mixer's parameters, stacked over ``n`` layers. The projections,
    conv taps and D skip are stored in ``dtype`` (the model's
    ``param_dtype``: the reference casts them to the activation dtype at
    use); ``A_log``, ``dt_bias`` and the norm gains stay f32, as the
    reference reads them."""
    D, H, P, N = cfg.d_model, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    K = cfg.ssm_conv
    return {
        "norm": {"scale": TS((n, D), ("layers", "embed"), init="zeros")},
        "wz": TS((n, D, H, P), ("layers", "embed", "ssm_heads", "head_dim"), dtype),
        "wx": TS((n, D, H, P), ("layers", "embed", "ssm_heads", "head_dim"), dtype),
        "wB": TS((n, D, N), ("layers", "embed", "ssm_state"), dtype),
        "wC": TS((n, D, N), ("layers", "embed", "ssm_state"), dtype),
        "wdt": TS((n, D, H), ("layers", "embed", "ssm_heads"), dtype),
        "conv_x": TS((n, K, H, P), ("layers", "conv", "ssm_heads", "head_dim"),
                     dtype, init="normal", scale=0.5),
        "conv_B": TS((n, K, N), ("layers", "conv", "ssm_state"), dtype,
                     init="normal", scale=0.5),
        "conv_C": TS((n, K, N), ("layers", "conv", "ssm_state"), dtype,
                     init="normal", scale=0.5),
        "A_log": TS((n, H), ("layers", "ssm_heads"), init="zeros"),
        "D_skip": TS((n, H), ("layers", "ssm_heads"), dtype, init="ones"),
        "dt_bias": TS((n, H), ("layers", "ssm_heads"), init="zeros"),
        "gnorm": {"scale": TS((n, H, P), ("layers", "ssm_heads", "head_dim"),
                              init="zeros")},
        "wo": TS((n, H, P, D), ("layers", "ssm_heads", "head_dim", "embed"), dtype),
    }


def mamba_cache_specs(cfg: ModelConfig, n: int, batch: int, dtype) -> dict:
    """Decode state of ``n`` stacked mixers: the last K - 1 conv inputs in
    ``dtype`` and the SSM state in f32."""
    H, P, N, K = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv_x": TS((n, batch, K - 1, H, P),
                     ("layers", "batch", "conv", "ssm_heads", "head_dim"),
                     dtype=dtype, init="zeros"),
        "conv_B": TS((n, batch, K - 1, N), ("layers", "batch", "conv", "ssm_state"),
                     dtype=dtype, init="zeros"),
        "conv_C": TS((n, batch, K - 1, N), ("layers", "batch", "conv", "ssm_state"),
                     dtype=dtype, init="zeros"),
        "ssm": TS((n, batch, H, P, N),
                  ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"),
                  dtype=torch.float32, init="zeros"),
    }


def _causal_conv(x, w):
    """Depthwise causal conv along dim 1, zero history. x: [B, S, ...];
    w: [K, ...]."""
    K, S = w.shape[0], x.shape[1]
    out = x * w[K - 1]
    for i in range(1, K):
        shifted = torch.cat([x.new_zeros((x.shape[0], min(i, S)) + x.shape[2:]),
                             x[:, :max(S - i, 0)]], dim=1)
        out = out + shifted * w[K - 1 - i]
    return out


def _project(p, x):
    dt_ = x.dtype
    z = torch.einsum("bsd,dhp->bshp", x, p["wz"].to(dt_))
    xin = torch.einsum("bsd,dhp->bshp", x, p["wx"].to(dt_))
    Bm = torch.einsum("bsd,dn->bsn", x, p["wB"].to(dt_))
    Cm = torch.einsum("bsd,dn->bsn", x, p["wC"].to(dt_))
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(dt_))
    return z, xin, Bm, Cm, dt


def _finish(p, y, xin, z):
    """D skip, gate, gated norm (a gain per head) and out projection,
    shared by the chunked and decode paths."""
    y = y + p["D_skip"].to(y.dtype)[None, None, :, None] * xin
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["gnorm"]["scale"])
    return torch.einsum("bshp,hpd->bsd", y, p["wo"].to(y.dtype))


def _ssd_chunk(h, xc, Bc, Cc, dtc, dAc, dt_):
    """One chunk of the SSD: (state after it, its output in ``dt_``).
    h: [B, H, P, N] f32; xc [B, Q, H, P], Bc/Cc [B, Q, N] in ``dt_``;
    dtc/dAc [B, Q, H] f32. The casts are the reference's: C.B in f32,
    M rounded to ``dt_`` before its product with x, the inter-chunk term
    and the state update in f32."""
    Q = xc.shape[1]
    cs = torch.cumsum(dAc, dim=1)                                   # [B,Q,H]
    CB = torch.einsum("bin,bjn->bij", Cc.float(), Bc.float())
    diff = cs[:, :, None, :] - cs[:, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(mask[None, :, :, None], diff, NEG_INF))
    M = CB[:, :, :, None] * decay * dtc[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", M.to(dt_), xc)
    # inter: [B,Q,H,P] = C[B,Q,N] . h[B,H,P,N] scaled by exp(cs)[B,Q,H]
    y_inter = torch.einsum("bin,bhpn->bihp", Cc.float(), h)
    y_inter = y_inter * torch.exp(cs)[:, :, :, None]
    # state update: h' = h*exp(cs_Q) + sum_j exp(cs_Q - cs_j) dt_j B_j x_j
    w = torch.exp(cs[:, -1:, :] - cs) * dtc                         # [B,Q,H]
    dh = torch.einsum("bjh,bjn,bjhp->bhpn", w, Bc.float(), xc.float())
    h = h * torch.exp(cs[:, -1])[:, :, None, None] + dh
    return h, (y_intra.float() + y_inter).to(dt_)


def ssd(xin, Bm, Cm, dt, dA, chunk: int):
    """The chunked SSD over a whole sequence, from a zero state: y [B, S,
    H, P] in xin's dtype for xin [B, S, H, P], Bm/Cm [B, S, N] and dt/dA
    [B, S, H] f32. Chunks of min(chunk, S) rows; the last may be short
    (the reference pads it with zero rows, which add no term to the rows
    before them)."""
    B_, S, H, P = xin.shape
    Q = min(chunk, S)
    h = xin.new_zeros((B_, H, P, Bm.shape[-1]), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, Q):
        c1 = min(S, c0 + Q)
        h, y = _ssd_chunk(h, xin[:, c0:c1], Bm[:, c0:c1], Cm[:, c0:c1],
                          dt[:, c0:c1], dA[:, c0:c1], xin.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _ssd_on_shards(xin, Bm, Cm, dt, dA, chunk: int):
    """``ssd`` of DTensors on each rank's own batch rows, heads and head
    dims (they are independent in the SSD), with S and the state dim
    whole. xin [B, S, H, P] leads; Bm/Cm [B, S, N] and dt/dA [B, S, H]
    follow its batch sharding (and dt/dA its heads'); their local
    gradients are pending sums over the mesh dims on which xin splits a
    dim they lack."""
    xin = ops._whole(xin, (1,))
    bcs, hs, gbcs, ghs = [], [], [], []
    for pl in xin.placements:
        d = pl.dim if isinstance(pl, Shard) else None
        bcs.append(Shard(0) if d == 0 else Replicate())
        hs.append(Shard(d) if d in (0, 2) else Replicate())
        gbcs.append(Shard(0) if d == 0 else Partial() if d else Replicate())
        ghs.append(Shard(d) if d in (0, 2) else Partial() if d else Replicate())
    place = tuple(xin.placements)
    return ops.on_local_shards_as(
        lambda *t: ssd(*t, chunk), (xin, Bm, Cm, dt, dA),
        (place, bcs, bcs, hs, hs), (place, gbcs, gbcs, ghs, ghs), place)


def mamba_mixer(cfg: ModelConfig, p, x, sh):
    """Chunked SSD. x: [B, S, D] -> [B, S, D]."""
    dt_ = x.dtype
    z, xin, Bm, Cm, dt = _project(p, x)
    xin = F.silu(_causal_conv(xin, p["conv_x"].to(dt_)))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"].to(dt_)))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"].to(dt_)))
    xin = sh(xin, "batch", "seq", "ssm_heads", "head_dim")

    dt = F.softplus(dt.float() + p["dt_bias"].float())                 # [B,S,H]
    a = -torch.exp(p["A_log"].float())                                 # [H]
    dA = dt * a

    if isinstance(xin, DTensor):
        y = _ssd_on_shards(xin, Bm, Cm, dt, dA, cfg.ssm_chunk)
    else:
        y = ssd(xin, Bm, Cm, dt, dA, cfg.ssm_chunk)
    return _finish(p, y, xin, z)


def _conv_step(buf, new, w):
    """One conv step. buf [B, K-1, ...] (the last K - 1 inputs, written in
    place with the window's last K - 1), new [B, 1, ...], w [K, ...]."""
    window = torch.cat([buf.to(new.dtype), new], dim=1)             # [B,K,...]
    out = torch.sum(window * w[None], dim=1, keepdim=True)
    buf.copy_(window[:, 1:])
    return out


def mamba_decode(cfg: ModelConfig, p, x, state, sh):
    """One-token recurrence. x: [B, 1, D]; ``state`` {conv_x, conv_B,
    conv_C, ssm} is updated in place (the reference returns a new state).
    Returns [B, 1, D]."""
    dt_ = x.dtype
    z, xin, Bm, Cm, dt = _project(p, x)
    xin = F.silu(_conv_step(state["conv_x"], xin, p["conv_x"].to(dt_)))
    Bm = F.silu(_conv_step(state["conv_B"], Bm, p["conv_B"].to(dt_)))
    Cm = F.silu(_conv_step(state["conv_C"], Cm, p["conv_C"].to(dt_)))

    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]          # [B,H]
    a = -torch.exp(p["A_log"].float())
    h = state["ssm"]                                                 # [B,H,P,N]
    decay = torch.exp(dt * a)[:, :, None, None]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].float(),
                       xin[:, 0].float())
    h.mul_(decay).add_(dBx)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    return _finish(p, y[:, None].to(dt_), xin, z)


def token_input_specs(shape: InputShape) -> dict:
    """Inputs of a token-only LM at ``shape``: tokens (and labels to
    train) [B, S], or one token and its cache slot to decode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": TS((B, S), ("batch", "seq"), dtype=torch.int32),
                "labels": TS((B, S), ("batch", "seq"), dtype=torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": TS((B, S), ("batch", "seq"), dtype=torch.int32)}
    return {"tokens": TS((B, 1), ("batch", "seq"), dtype=torch.int32),
            "pos": TS((B,), ("batch",), dtype=torch.int32)}


class Mamba2Model:
    """Attention-free Mamba-2 LM (the ``ssm`` family).

    ``param_dtype`` as in ``TransformerModel``: the dtype of the mixer's
    projections, conv taps and D skip (bf16 to serve; f32 to train, and
    ``init`` then returns one FlatTree). Norm gains, ``A_log``,
    ``dt_bias`` and the embedding tables are f32 either way; activations
    are bf16, fixed by ``embed_tokens``.
    """

    def __init__(self, cfg: ModelConfig, param_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.param_dtype = param_dtype

    def param_specs(self) -> dict:
        cfg = self.cfg
        n, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
        return {"embed": TS((V, D), ("vocab", "embed"), init="embed"),
                "unembed": TS((V, D), ("vocab", "embed"), init="embed"),
                "final_norm": {"scale": TS((D,), ("embed",), init="zeros")},
                "layers": mamba_specs(cfg, n, self.param_dtype)}

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters drawn from ``generator`` (on ``device``): one
        FlatTree of f32 masters when ``param_dtype`` is f32, else a nested
        dict."""
        if self.param_dtype == torch.float32:
            return init_flat(generator, self.param_specs(), device)
        return init_params(generator, self.param_specs(), device)

    def forward(self, params, batch, sh=L.NO_SHARD, *, window=None):
        """Teacher-forced logits [B, S, V] f32 and aux 0.0 (no MoE)."""
        cfg = self.cfg
        x = sh(L.embed_tokens(params["embed"], batch["tokens"]), "batch", "seq", "embed")
        for i in range(cfg.n_layers):
            p_i = _layer_params(params["layers"], i)
            h = L.rmsnorm(x, p_i["norm"]["scale"])
            x = x + mamba_mixer(cfg, p_i, h, sh)
        x = L.rmsnorm(x, params["final_norm"]["scale"])
        return L.lm_logits(x, params["unembed"]), 0.0

    def loss(self, params, batch, sh=L.NO_SHARD):
        logits, _ = self.forward(params, batch, sh)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        return L.softmax_cross_entropy(logits, labels)

    def prefill(self, params, batch, sh=L.NO_SHARD, *, window=None):
        logits, _ = self.forward(params, batch, sh)
        return logits

    def cache_specs(self, shape: InputShape, dtype=torch.bfloat16) -> dict:
        return mamba_cache_specs(self.cfg, self.cfg.n_layers, shape.global_batch, dtype)

    def decode_step(self, params, cache, batch, sh=L.NO_SHARD, *, window=None):
        """One-token decode. batch: tokens [B, 1] (and pos [B], which the
        recurrence does not read). The cache is updated in place and
        returned."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["tokens"])
        for i in range(cfg.n_layers):
            p_i = _layer_params(params["layers"], i)
            h = L.rmsnorm(x, p_i["norm"]["scale"])
            x = x + mamba_decode(cfg, p_i, h, _layer_params(cache, i), sh)
        x = L.rmsnorm(x, params["final_norm"]["scale"])
        return L.lm_logits(x, params["unembed"]), cache

    def input_specs(self, shape: InputShape) -> dict:
        return token_input_specs(shape)
