"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision stub). [arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    source="arXiv:2409.12191 (Qwen2-VL), 2B backbone",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, mrope=True, activation="silu",
    frontend="vision", n_frontend_tokens=256,  # stub: precomputed patch embeds
)


def smoke_config():
    return reduced(CONFIG)
