"""Model factory: config -> model object (torch twin of ``repro.models.registry``).

Every family of the reference builds: the decoder-only transformers
(dense, MoE and the VLM backbone), the SSM (Mamba-2), the hybrid (Jamba),
the audio encoder-decoder (whisper) and the ResNet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet110 import ResNetConfig
from repro_torch.models.hybrid import JambaModel
from repro_torch.models.mamba2 import Mamba2Model
from repro_torch.models.resnet import ResNetModel
from repro_torch.models.transformer import TransformerModel
from repro_torch.models.whisper import WhisperModel


def build_model(cfg: ModelConfig | ResNetConfig,
                dtype: torch.dtype = torch.bfloat16):
    """``dtype``: the ResNet's activation dtype (its parameters are f32);
    an LM's ``param_dtype``, the dtype in which it stores its matmul
    weights (bf16 to serve, f32 to train; its activations are bf16)."""
    if isinstance(cfg, ResNetConfig):
        return ResNetModel(cfg, dtype)
    if cfg.family == "ssm":
        return Mamba2Model(cfg, dtype)
    if cfg.family == "hybrid":
        return JambaModel(cfg, dtype)
    if cfg.family == "audio":
        return WhisperModel(cfg, dtype)
    return TransformerModel(cfg, dtype)


def decode_window(cfg: ModelConfig, seq_len: int) -> int | None:
    """Effective attention window for a given context length.

    Native SWA archs always use their window; otherwise full attention up to
    128k and the sliding-window long-context variant beyond.
    """
    if cfg.sliding_window:
        return cfg.sliding_window
    if seq_len > 131_072:
        return cfg.long_context_window
    return None
