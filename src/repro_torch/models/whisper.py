"""Whisper-style encoder-decoder backbone (torch twin of
``repro.models.whisper``).

The mel-spectrogram and conv front end is a stub, as in the reference:
a batch carries precomputed frame embeddings ``frames [B, n_frames, D]``.
Positions are sinusoidal; every sub-layer is pre-norm LayerNorm (plain
torch, f32 statistics); the MLPs are gelu with biases and every
projection has a bias. The kernel on this path is ``swa_attention``: the
encoder's non-causal self-attention over the frames, the decoder's causal
self-attention, and the decoder's cross-attention over the encoder's
output (Sq != Sk; in a decode step one query row against every frame).
A decode step's self-attention reads the KV cache in plain torch
(``layers.decode_attention``), as in the other families, and its
cross-attention recomputes K and V from ``cache["enc"]`` every step, as
the reference does.

Parameters follow ``models.transformer``: nested dicts (``encoder/...``,
``decoder/...``) stacked on a leading layer axis, a Python loop over the
layers, and ``param_dtype`` (bf16 to serve, f32 masters to train) for the
matmul weights and biases that the reference casts to the activation
dtype at use; layernorm gains and biases and the embedding tables stay
f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec as TS, init_flat, init_params
from repro_torch.models.transformer import (_layer_params, attention,
                                            attn_specs, mlp_specs)


def _norm(p):
    return p["scale"], p["bias"]


class WhisperModel:
    def __init__(self, cfg: ModelConfig, param_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.param_dtype = param_dtype

    # ------------------------------------------------------------ specs ----
    def _layer_specs(self, n: int, cross: bool) -> dict:
        D = self.cfg.d_model

        def norm():
            return {"scale": TS((n, D), ("layers", "embed"), init="ones"),
                    "bias": TS((n, D), ("layers", "embed"), init="zeros")}

        s = {"ln1": norm(), "attn": attn_specs(self.cfg, n, self.param_dtype),
             "ln2": norm(), "mlp": mlp_specs(self.cfg, n, self.param_dtype)}
        if cross:
            s["lnx"] = norm()
            s["xattn"] = attn_specs(self.cfg, n, self.param_dtype)
        return s

    def param_specs(self) -> dict:
        cfg = self.cfg
        V, D = cfg.vocab_size, cfg.d_model
        return {
            "embed": TS((V, D), ("vocab", "embed"), init="embed"),
            "unembed": TS((V, D), ("vocab", "embed"), init="embed"),
            "enc_norm": {"scale": TS((D,), ("embed",), init="ones"),
                         "bias": TS((D,), ("embed",), init="zeros")},
            "dec_norm": {"scale": TS((D,), ("embed",), init="ones"),
                         "bias": TS((D,), ("embed",), init="zeros")},
            "encoder": self._layer_specs(cfg.encoder_layers, cross=False),
            "decoder": self._layer_specs(cfg.n_layers, cross=True),
        }

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters, drawn from ``generator`` (on ``device``): one
        FlatTree of f32 masters when ``param_dtype`` is f32, else a nested
        dict."""
        if self.param_dtype == torch.float32:
            return init_flat(generator, self.param_specs(), device)
        return init_params(generator, self.param_specs(), device)

    # ---------------------------------------------------------- encoder ----
    def encode(self, params, frames, sh=L.NO_SHARD):
        """frames [B, n_frames, D] -> the encoder's output [B, n_frames, D]
        in bf16."""
        cfg = self.cfg
        B, S, _ = frames.shape
        pos = torch.arange(S, device=frames.device)[None].expand(B, S)
        x = (frames.to(torch.bfloat16)
             + L.sinusoidal(pos, cfg.d_model).to(torch.bfloat16))
        x = sh(x, "batch", "frames", "embed")
        for i in range(cfg.encoder_layers):
            p_i = _layer_params(params["encoder"], i)
            h = L.layernorm(x, *_norm(p_i["ln1"]))
            x = x + attention(cfg, p_i["attn"], h, pos, sh, window=None,
                              causal=False)
            h = L.layernorm(x, *_norm(p_i["ln2"]))
            x = x + L.mlp(cfg, p_i["mlp"], h)
        return L.layernorm(x, *_norm(params["enc_norm"]))

    # ---------------------------------------------------------- decoder ----
    def _dec_layer(self, p_i, x, positions, enc, sh, cache_i=None, pos=None):
        """Causal self-attention (against ``cache_i`` at slot ``pos`` when
        decoding, written in place), cross-attention over ``enc``, MLP."""
        cfg = self.cfg
        h = L.layernorm(x, *_norm(p_i["ln1"]))
        x = x + attention(cfg, p_i["attn"], h, positions, sh, window=None,
                          cache=cache_i, pos=pos)
        h = L.layernorm(x, *_norm(p_i["lnx"]))
        x = x + attention(cfg, p_i["xattn"], h, positions, sh, window=None,
                          memory=enc, causal=False)
        h = L.layernorm(x, *_norm(p_i["ln2"]))
        return x + L.mlp(cfg, p_i["mlp"], h)

    def _embed(self, params, tokens, positions):
        x = L.embed_tokens(params["embed"], tokens)
        return x + L.sinusoidal(positions, self.cfg.d_model).to(x.dtype)

    def _logits(self, params, x):
        x = L.layernorm(x, *_norm(params["dec_norm"]))
        return L.lm_logits(x, params["unembed"])

    def forward(self, params, batch, sh=L.NO_SHARD, *, window=None):
        """Teacher-forced logits [B, S, V] f32 of ``batch`` {frames, tokens};
        returns (logits, 0.0) as the decoder-only families do."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"], sh)
        B, S = batch["tokens"].shape
        pos = torch.arange(S, device=enc.device)[None].expand(B, S)
        x = sh(self._embed(params, batch["tokens"], pos), "batch", "seq", "embed")
        for i in range(cfg.n_layers):
            x = self._dec_layer(_layer_params(params["decoder"], i), x, pos, enc, sh)
        return self._logits(params, x), 0.0

    def loss(self, params, batch, sh=L.NO_SHARD):
        logits, _ = self.forward(params, batch, sh)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        return L.softmax_cross_entropy(logits, labels)

    def prefill(self, params, batch, sh=L.NO_SHARD, *, window=None):
        logits, _ = self.forward(params, batch, sh)
        return logits

    # ------------------------------------------------------------ serve ----
    def cache_specs(self, shape: InputShape, dtype=torch.bfloat16) -> dict:
        """The decoder's KV cache and the encoder's output ``enc`` (zeros
        until the caller writes ``encode``'s output there)."""
        cfg = self.cfg
        n, B, S = cfg.n_layers, shape.global_batch, shape.seq_len
        kv = (n, B, S, cfg.n_kv_heads, cfg.d_head)
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": TS(kv, axes, dtype=dtype, init="zeros"),
                "v": TS(kv, axes, dtype=dtype, init="zeros"),
                "enc": TS((B, cfg.n_frontend_tokens, cfg.d_model),
                          ("batch", "frames", "embed"), dtype=dtype,
                          init="zeros")}

    def decode_step(self, params, cache, batch, sh=L.NO_SHARD, *, window=None):
        """One-token decode. batch: tokens [B, 1], pos [B]. The KV cache's
        slot ``pos`` is written in place and ``cache`` returned."""
        cfg = self.cfg
        pos = batch["pos"].long()
        x = self._embed(params, batch["tokens"], pos[:, None])
        enc = cache["enc"].to(x.dtype)
        for i in range(cfg.n_layers):
            x = self._dec_layer(_layer_params(params["decoder"], i), x, pos[:, None],
                                enc, sh, cache_i=(cache["k"][i], cache["v"][i]),
                                pos=pos)
        return self._logits(params, x), cache

    def input_specs(self, shape: InputShape) -> dict:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        frames = TS((B, cfg.n_frontend_tokens, cfg.d_model),
                    ("batch", "frames", "embed"), dtype=torch.bfloat16)
        tokens = TS((B, S), ("batch", "seq"), dtype=torch.int32)
        if shape.kind == "train":
            return {"frames": frames, "tokens": tokens,
                    "labels": TS((B, S), ("batch", "seq"), dtype=torch.int32)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": tokens}
        return {"tokens": TS((B, 1), ("batch", "seq"), dtype=torch.int32),
                "pos": TS((B,), ("batch",), dtype=torch.int32)}
