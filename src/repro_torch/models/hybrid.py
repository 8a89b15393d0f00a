"""Jamba-style hybrid (torch twin of ``repro.models.hybrid``): Mamba and
attention interleaved 1:{attn_every-1}, with an MoE FFN every
``moe_every``-th layer (arXiv:2403.19887).

A *block* of ``attn_every`` layers is the unit that repeats: the attention
layer sits at position ``attn_every // 2`` (Jamba places the first
attention at layer 4), MoE FFNs at odd positions. Each position's
parameters are stacked over the ``[n_blocks]`` blocks, and the blocks run
in a Python loop (the reference's ``lax.scan``). Attention is
``transformer.attention`` (its KV cache written in place; no RoPE when
``rope_theta`` is 0, as for Jamba), the mixer is ``mamba2``'s and the MoE
FFN is ``moe.moe_ffn``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.spec import TensorSpec as TS, init_flat, init_params
from repro_torch.models.transformer import (_layer_params, attention, attn_specs,
                                            mlp_specs)


class JambaModel:
    """The ``hybrid`` family. ``param_dtype`` as in ``TransformerModel``:
    the dtype of every matmul weight, conv tap and D skip (bf16 to serve;
    f32 to train, and ``init`` then returns one FlatTree); norm gains,
    ``A_log``, ``dt_bias`` and the embedding tables are f32 either way."""

    def __init__(self, cfg: ModelConfig, param_dtype: torch.dtype = torch.bfloat16):
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.block_size = cfg.attn_every
        self.n_blocks = cfg.n_layers // cfg.attn_every
        self.attn_pos = cfg.attn_every // 2

    def _is_moe_pos(self, pos: int) -> bool:
        return self.cfg.is_moe and (pos % self.cfg.moe_every == 1)

    # ------------------------------------------------------------ specs ----
    def _pos_specs(self, pos: int) -> dict:
        cfg, nb, dt = self.cfg, self.n_blocks, self.param_dtype
        D = cfg.d_model
        s: dict = {}
        if pos == self.attn_pos:
            s["ln1"] = {"scale": TS((nb, D), ("layers", "embed"), init="zeros")}
            s["attn"] = attn_specs(cfg, nb, dt)
        else:
            s["mamba"] = m2.mamba_specs(cfg, nb, dt)
        s["ln2"] = {"scale": TS((nb, D), ("layers", "embed"), init="zeros")}
        if self._is_moe_pos(pos):
            s["moe"] = moe_lib.moe_specs(cfg, nb, dt)
        else:
            s["mlp"] = mlp_specs(cfg, nb, dt)
        return s

    def param_specs(self) -> dict:
        cfg = self.cfg
        V, D = cfg.vocab_size, cfg.d_model
        return {"embed": TS((V, D), ("vocab", "embed"), init="embed"),
                "unembed": TS((V, D), ("vocab", "embed"), init="embed"),
                "final_norm": {"scale": TS((D,), ("embed",), init="zeros")},
                "blocks": {f"pos{p}": self._pos_specs(p)
                           for p in range(self.block_size)}}

    def expert_param_specs(self) -> dict:
        return moe_lib.expert_only_specs(self.param_specs())

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters drawn from ``generator`` (on ``device``): one
        FlatTree of f32 masters when ``param_dtype`` is f32, else a nested
        dict."""
        if self.param_dtype == torch.float32:
            return init_flat(generator, self.param_specs(), device)
        return init_params(generator, self.param_specs(), device)

    # ---------------------------------------------------------- forward ----
    def _block(self, bp, x, positions, sh, window, caches=None, pos=None):
        """One block of ``attn_every`` layers -> (x, aux summed over its MoE
        FFNs). ``caches``: this block's cache per position, written in
        place (decode); None for the whole-sequence forward."""
        cfg = self.cfg
        aux_sum = 0.0
        for p_i in range(self.block_size):
            p = bp[f"pos{p_i}"]
            cache = None if caches is None else caches[f"pos{p_i}"]
            if p_i == self.attn_pos:
                h = L.rmsnorm(x, p["ln1"]["scale"])
                kv = None if cache is None else (cache["k"], cache["v"])
                x = x + attention(cfg, p["attn"], h, positions, sh,
                                  window=window, cache=kv, pos=pos)
            else:
                h = L.rmsnorm(x, p["mamba"]["norm"]["scale"])
                if cache is None:
                    x = x + m2.mamba_mixer(cfg, p["mamba"], h, sh)
                else:
                    x = x + m2.mamba_decode(cfg, p["mamba"], h, cache, sh)
            h = L.rmsnorm(x, p["ln2"]["scale"])
            if self._is_moe_pos(p_i):
                out, aux = moe_lib.moe_ffn(cfg, p["moe"], h, sh)
                aux_sum = aux_sum + aux
            else:
                out = L.mlp(cfg, p["mlp"], h)
            x = x + out
        return x, aux_sum

    def forward(self, params, batch, sh=L.NO_SHARD, *, window=None):
        """Teacher-forced logits [B, S, V] f32 and the MoE aux loss summed
        over every MoE FFN."""
        x = sh(L.embed_tokens(params["embed"], batch["tokens"]), "batch", "seq", "embed")
        B, S = batch["tokens"].shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        aux = 0.0
        for b in range(self.n_blocks):
            x, aux_b = self._block(_layer_params(params["blocks"], b), x, positions,
                                   sh, window)
            aux = aux + aux_b
        x = L.rmsnorm(x, params["final_norm"]["scale"])
        return L.lm_logits(x, params["unembed"]), aux

    def loss(self, params, batch, sh=L.NO_SHARD):
        logits, aux = self.forward(params, batch, sh)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        return L.softmax_cross_entropy(logits, labels) + 0.01 * aux

    def prefill(self, params, batch, sh=L.NO_SHARD, *, window=None):
        logits, _ = self.forward(params, batch, sh, window=window)
        return logits

    # ------------------------------------------------------------ serve ----
    def cache_specs(self, shape: InputShape, dtype=torch.bfloat16) -> dict:
        cfg, nb = self.cfg, self.n_blocks
        B, S = shape.global_batch, shape.seq_len
        out: dict = {}
        for p in range(self.block_size):
            if p == self.attn_pos:
                kv = (nb, B, S, cfg.n_kv_heads, cfg.d_head)
                axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
                out[f"pos{p}"] = {"k": TS(kv, axes, dtype=dtype, init="zeros"),
                                  "v": TS(kv, axes, dtype=dtype, init="zeros")}
            else:
                out[f"pos{p}"] = m2.mamba_cache_specs(cfg, nb, B, dtype)
        return out

    def decode_step(self, params, cache, batch, sh=L.NO_SHARD, *, window=None):
        """One-token decode. batch: tokens [B, 1], pos [B]. The KV caches'
        slot ``pos`` and the SSM states are written in place; the returned
        cache is ``cache`` itself."""
        x = L.embed_tokens(params["embed"], batch["tokens"])
        pos = batch["pos"].long()
        positions = pos[:, None]
        for b in range(self.n_blocks):
            x, _ = self._block(_layer_params(params["blocks"], b), x, positions, sh,
                               window, caches=_layer_params(cache, b), pos=pos)
        x = L.rmsnorm(x, params["final_norm"]["scale"])
        return L.lm_logits(x, params["unembed"]), cache

    def input_specs(self, shape: InputShape) -> dict:
        return m2.token_input_specs(shape)
