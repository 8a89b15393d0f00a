"""qwen2.5-3b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    source="hf:Qwen/Qwen2.5-0.5B (Qwen2.5 family card, 3B row)",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, activation="silu",
)


def smoke_config():
    return reduced(CONFIG)
