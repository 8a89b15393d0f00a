"""Decoder-only transformer family (torch twin of
``repro.models.transformer``): dense GQA (qwen2.5-*, gemma, h2o-danube),
MoE (qwen3-moe, dbrx) and the VLM backbone (qwen2-vl: M-RoPE and the
vision stub, precomputed patch embeddings written over the first
``n_frontend_tokens`` rows).

Parameters are the reference's tree as nested dicts of tensors, with the
per-layer weights stacked along a leading ``[n_layers]`` dim; the layer
loop is a Python loop over that dim (a stacked leaf may also come as a
tuple of per-layer tensors, the form in which training differentiates
it).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.spec import TensorSpec as TS, init_flat, init_params


def _norm_specs(cfg, shape, axes):
    if cfg.norm == "layernorm":
        return {"scale": TS(shape, axes, init="ones"),
                "bias": TS(shape, axes, init="zeros")}
    return {"scale": TS(shape, axes, init="zeros")}


def attn_specs(cfg: ModelConfig, n: int, dtype: torch.dtype) -> dict:
    Lx, D, H, Hk, Dh = (n, cfg.d_model, cfg.pad_heads_to or cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_head)
    s: dict = {
        "wq": TS((Lx, D, H, Dh), ("layers", "embed", "heads", "head_dim"), dtype),
        "wk": TS((Lx, D, Hk, Dh), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        "wv": TS((Lx, D, Hk, Dh), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        "wo": TS((Lx, H, Dh, D), ("layers", "heads", "head_dim", "embed"), dtype),
    }
    if cfg.qkv_bias or cfg.norm == "layernorm":
        s["bq"] = TS((Lx, H, Dh), ("layers", "heads", "head_dim"), dtype,
                     init="zeros")
        s["bk"] = TS((Lx, Hk, Dh), ("layers", "kv_heads", "head_dim"), dtype,
                     init="zeros")
        s["bv"] = TS((Lx, Hk, Dh), ("layers", "kv_heads", "head_dim"), dtype,
                     init="zeros")
    return s


def mlp_specs(cfg: ModelConfig, n: int, dtype: torch.dtype) -> dict:
    """Gated MLP weights (silu, geglu), or the plain gelu MLP's with its
    biases; all are cast to the activation dtype at use."""
    Lx, D, F = n, cfg.d_model, cfg.d_ff
    if cfg.activation in ("silu", "geglu"):
        return {"wi_gate": TS((Lx, D, F), ("layers", "embed", "mlp"), dtype),
                "wi_up": TS((Lx, D, F), ("layers", "embed", "mlp"), dtype),
                "wo": TS((Lx, F, D), ("layers", "mlp", "embed"), dtype)}
    return {"wi": TS((Lx, D, F), ("layers", "embed", "mlp"), dtype),
            "wi_bias": TS((Lx, F), ("layers", "mlp"), dtype, init="zeros"),
            "wo": TS((Lx, F, D), ("layers", "mlp", "embed"), dtype),
            "wo_bias": TS((Lx, D), ("layers", "embed"), dtype, init="zeros")}


@functools.lru_cache(maxsize=16)
def _head_map(n_heads: int, n_padded: int, n_kv_heads: int,
              device: torch.device) -> torch.Tensor:
    """KV head of each (possibly padded) Q head, as the reference maps it;
    read-only, kept per device so that a decode step copies nothing."""
    return torch.tensor([min(h, n_heads - 1) * n_kv_heads // n_heads
                         for h in range(n_padded)], dtype=torch.long,
                        device=device)


def attention(cfg: ModelConfig, p, x, positions, sh, *,
              window: int | None, cache=None, pos=None, memory=None,
              causal: bool = True):
    """Attention sub-layer: self-attention, or cross-attention over
    ``memory`` [B, Sm, D] (keys and values from it, no RoPE, no cache).

    cache: (k_cache, v_cache) [B, S, Hkv, Dh] for decode, written in place
    at slot ``pos`` [B] (the reference returns new caches instead).
    """
    dt = x.dtype
    kv_src = x if memory is None else memory
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.rope_theta and memory is None:
        sections = _mrope_sections(cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta, sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, sections)
    q = sh(q, "batch", "seq", "heads", "head_dim")
    # Padded heads (pad_heads_to) keep the real heads' q->kv mapping through
    # an explicit gather and are hard-masked to zero output.
    H_real, H_pad = cfg.n_heads, (cfg.pad_heads_to or cfg.n_heads)
    head_map = _head_map(H_real, H_pad, cfg.n_kv_heads, x.device)
    if cache is not None:
        k_cache, v_cache = cache
        L.write_slot(k_cache, k[:, 0], pos)
        L.write_slot(v_cache, v[:, 0], pos)
        attn = L.decode_attention(
            q, L.index_select(k_cache.to(dt), 2, head_map),
            L.index_select(v_cache.to(dt), 2, head_map),
            pos, window=window, repeated=True)
    else:
        attn = L.chunked_attention(q, L.index_select(k, 2, head_map),
                                   L.index_select(v, 2, head_map),
                                   causal=causal, window=window)
    if H_pad != H_real:
        mask = (torch.arange(H_pad, device=x.device) < H_real).to(dt)
        attn = attn * mask[None, None, :, None]
    attn = sh(attn, "batch", "seq", "heads", "head_dim")
    return torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(dt))


def _mrope_sections(cfg: ModelConfig) -> tuple[int, int, int] | None:
    """M-RoPE's (t, h, w) split of the half-dim: Qwen2-VL's (16, 24, 24)
    on d_half 64, scaled to other head dims as the reference scales it."""
    if not cfg.mrope:
        return None
    half = cfg.d_head // 2
    hw = (half - half // 4) // 2
    return (half - 2 * hw, hw, hw)


def _layer_params(tree: dict, i: int) -> dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


class TransformerModel:
    """dense | moe | vlm decoder-only LM.

    Two dtypes. The compute dtype is that of the activations: bf16, fixed
    by ``embed_tokens`` as in the reference; every matmul weight and bias
    is cast to it at use. ``param_dtype`` is the dtype in which the matmul
    weights (attention, MLP, MoE router and experts) and QKV biases are
    stored: bf16 for serving (cast once, so no decode step casts them
    again), f32 for training (the f32 masters the reference keeps,
    ``repro/models/spec.py``; ``init`` then returns one FlatTree). Norm
    gains and the embedding tables are f32 either way.
    """

    def __init__(self, cfg: ModelConfig, param_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.param_dtype = param_dtype

    # ------------------------------------------------------------ specs ----
    def param_specs(self) -> dict:
        cfg = self.cfg
        n, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
        layer = {"ln1": _norm_specs(cfg, (n, D), ("layers", "embed")),
                 "attn": attn_specs(cfg, n, self.param_dtype),
                 "ln2": _norm_specs(cfg, (n, D), ("layers", "embed"))}
        if cfg.is_moe:
            layer["moe"] = moe_lib.moe_specs(cfg, n, self.param_dtype)
        else:
            layer["mlp"] = mlp_specs(cfg, n, self.param_dtype)
        p = {"embed": TS((V, D), ("vocab", "embed"), init="embed"),
             "final_norm": _norm_specs(cfg, (D,), ("embed",)),
             "layers": layer}
        if not cfg.tie_embeddings:
            p["unembed"] = TS((V, D), ("vocab", "embed"), init="embed")
        return p

    def expert_param_specs(self) -> dict:
        return moe_lib.expert_only_specs(self.param_specs())

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters, drawn from ``generator`` (on ``device``): one
        FlatTree of f32 masters when ``param_dtype`` is f32, else a nested
        dict."""
        if self.param_dtype == torch.float32:
            return init_flat(generator, self.param_specs(), device)
        return init_params(generator, self.param_specs(), device)

    # --------------------------------------------------------- positions ---
    def _positions(self, batch_size: int, seq_len: int, device):
        cfg = self.cfg
        if not cfg.mrope:
            pos = torch.arange(seq_len, dtype=torch.int32, device=device)[None, :]
            return pos.expand(batch_size, seq_len)
        # M-RoPE: vision patches get (t=0, h, w) grid coords, text tokens get
        # t = h = w = running position (Qwen2-VL §2.1).
        P = min(cfg.n_frontend_tokens, seq_len)
        g = max(1, math.isqrt(P))
        i = np.arange(seq_len)
        t = np.where(i < P, 0, i - P + g)
        h = np.where(i < P, np.minimum(i, P - 1) // g, i - P + g)
        w = np.where(i < P, np.minimum(i, P - 1) % g, i - P + g)
        pos3 = torch.from_numpy(np.stack([t, h, w], axis=-1).astype(np.int32))
        return pos3.to(device)[None].expand(batch_size, seq_len, 3)

    def _decode_positions(self, pos):
        """Rotary positions of one decode step at cache slots ``pos [B]``:
        ``[B, 1]``, or ``[B, 1, 3]`` under M-RoPE, where every decode token
        is text at ``pos - P + g`` on all three axes, as in the reference."""
        cfg = self.cfg
        if not cfg.mrope:
            return pos[:, None]
        P = cfg.n_frontend_tokens
        txt = pos - P + max(1, math.isqrt(P))
        return torch.stack([txt, txt, txt], dim=-1)[:, None]

    # ----------------------------------------------------------- embed -----
    def _embed(self, params, batch):
        cfg = self.cfg
        scale = math.sqrt(cfg.d_model) if cfg.name.startswith("gemma") else None
        x = L.embed_tokens(params["embed"], batch["tokens"], scale)
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            P = min(pe.shape[1], x.shape[1])
            x = torch.cat([pe[:, :P], x[:, P:]], dim=1)
        return x

    def _unembed(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    # ---------------------------------------------------------- forward ----
    def _layer(self, params_i, x, positions, sh, window, cache_i=None,
               pos=None):
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_i["ln1"])
        x = x + attention(cfg, params_i["attn"], h, positions, sh,
                          window=window, cache=cache_i, pos=pos)
        h = L.apply_norm(cfg, x, params_i["ln2"])
        if cfg.is_moe:
            ffn_out, aux = moe_lib.moe_ffn(cfg, params_i["moe"], h, sh)
        else:
            ffn_out, aux = L.mlp(cfg, params_i["mlp"], h), 0.0
        return x + ffn_out, aux

    def forward(self, params, batch, sh=L.NO_SHARD, *, window=None):
        """Teacher-forced logits over the whole sequence. Returns (logits, aux):
        aux is the MoE load-balance loss summed over the layers (a 0-d f32
        tensor), 0.0 on the dense path. ``batch``: tokens [B, S], and for
        the VLM optionally patch_embeds [B, P, D]."""
        cfg = self.cfg
        x = sh(self._embed(params, batch), "batch", "seq", "embed")
        positions = self._positions(*batch["tokens"].shape, x.device)
        window = window if window is not None else cfg.sliding_window
        aux = 0.0
        for i in range(cfg.n_layers):
            x, aux_i = self._layer(_layer_params(params["layers"], i), x,
                                   positions, sh, window)
            aux = aux + aux_i
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.lm_logits(x, self._unembed(params))
        return sh(logits, "batch", "seq", "vocab"), aux

    def loss(self, params, batch, sh=L.NO_SHARD):
        """Mean next-token cross-entropy of ``batch`` {tokens, labels [B, S]}
        plus 0.01 x the auxiliary loss (0 on the dense path), as in the
        reference."""
        logits, aux = self.forward(params, batch, sh)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        return L.softmax_cross_entropy(logits, labels) + 0.01 * aux

    # ------------------------------------------------------------ serve ----
    def cache_specs(self, shape: InputShape, dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        kv = (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads,
              cfg.d_head)
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": TS(kv, axes, dtype=dtype, init="zeros"),
                "v": TS(kv, axes, dtype=dtype, init="zeros")}

    def prefill(self, params, batch, sh=L.NO_SHARD, *, window=None):
        """Prefill logits (the forward; the cache is built by stepping the
        decoder, as in the reference's serve loop)."""
        logits, _ = self.forward(params, batch, sh, window=window)
        return logits

    def decode_step(self, params, cache, batch, sh=L.NO_SHARD, *,
                    window=None):
        """One-token decode against a cache. batch: tokens [B,1], pos [B].

        The cache's slot ``pos`` is written in place (the reference returns
        a new cache; here the returned dict is ``cache`` itself)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        pos = batch["pos"].long()
        positions = self._decode_positions(pos)
        window = window if window is not None else cfg.sliding_window
        for i in range(cfg.n_layers):
            x, _ = self._layer(_layer_params(params["layers"], i), x,
                               positions, sh, window,
                               cache_i=(cache["k"][i], cache["v"][i]), pos=pos)
        x = L.apply_norm(cfg, x, params["final_norm"])
        logits = L.lm_logits(x, self._unembed(params))
        return logits, cache

    # ------------------------------------------------------------ inputs ---
    def input_specs(self, shape: InputShape) -> dict:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        tok = ("batch", "seq")
        if shape.kind == "train":
            d = {"tokens": TS((B, S), tok, dtype=torch.int32),
                 "labels": TS((B, S), tok, dtype=torch.int32)}
        elif shape.kind == "prefill":
            d = {"tokens": TS((B, S), tok, dtype=torch.int32)}
        else:
            d = {"tokens": TS((B, 1), tok, dtype=torch.int32),
                 "pos": TS((B,), ("batch",), dtype=torch.int32)}
        if cfg.frontend == "vision" and shape.kind != "decode":
            d["patch_embeds"] = TS((B, cfg.n_frontend_tokens, cfg.d_model),
                                   ("batch", "patch", "embed"),
                                   dtype=torch.bfloat16)
        return d
