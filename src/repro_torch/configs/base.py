"""Architecture configuration system (the port's copy of
``repro.configs.base``).

One frozen dataclass covers every assigned family (dense / moe / ssm /
hybrid / vlm / audio).  Each ``configs/<id>.py`` exports ``CONFIG`` with the
exact published numbers (source cited) and ``smoke_config()`` returning the
reduced same-family variant used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    source: str  # citation for the numbers

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention details
    # pad_heads_to: shard-friendly padded Q-head count (> n_heads). Extra
    # heads are hard-masked to zero output, so the model is mathematically
    # identical — this exists purely so 40 or 12 heads can shard on a
    # 16-way model axis (EXPERIMENTS.md §Perf, beyond-paper optimization).
    pad_heads_to: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False                  # Qwen2-VL multimodal 3D RoPE
    sliding_window: int | None = None    # native SWA (h2o-danube)
    # long_500k fallback window for otherwise full-attention archs:
    long_context_window: int = 4096

    # MLP
    activation: str = "silu"             # silu | geglu | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1                   # apply MoE every k-th layer

    # SSM (Mamba2 / Jamba mamba layers)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0                  # hybrid: 1 attention layer per block

    # encoder/decoder + modality frontend (STUB per assignment)
    encoder_layers: int = 0              # >0 => encoder-decoder (whisper)
    frontend: str | None = None          # "audio" | "vision" | None
    n_frontend_tokens: int = 0           # stub embedding count (frames/patches)

    tie_embeddings: bool = False

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included)."""
        from repro_torch.models.registry import build_model
        from repro_torch.models import spec as pspec
        return pspec.n_params(build_model(self).param_specs())

    def active_param_count(self) -> int:
        """Params active per token (MoE counts top_k of n_experts)."""
        from repro_torch.models.registry import build_model
        from repro_torch.models import spec as pspec
        model = build_model(self)
        total = pspec.n_params(model.param_specs())
        if not self.is_moe:
            return total
        # subtract inactive expert weights
        expert = pspec.n_params(model.expert_param_specs())
        inactive = expert * (1 - self.top_k / self.n_experts)
        return int(total - inactive)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers etc.)."""
    small: dict = dict(
        n_layers=2, d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.is_moe:
        small.update(n_experts=min(cfg.n_experts, 4),
                     top_k=min(cfg.top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=min(cfg.ssm_state, 16), ssm_headdim=16,
                     ssm_chunk=16)
    if cfg.attn_every:
        small.update(attn_every=2, n_layers=4)
    if cfg.encoder_layers:
        small.update(encoder_layers=2)
    if cfg.n_frontend_tokens:
        small.update(n_frontend_tokens=16)
    if cfg.sliding_window:
        small.update(sliding_window=32)
    small["long_context_window"] = 64
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
