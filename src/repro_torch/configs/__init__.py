"""Config registry of the port: ``--arch <id>`` resolution.

A copy of ``repro.configs``: the decoder-only transformers (dense, MoE
and the VLM backbone), the SSM (mamba2-780m), the hybrid (jamba-v0.1-52b)
and the audio encoder-decoder (whisper-base).
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).smoke_config()
