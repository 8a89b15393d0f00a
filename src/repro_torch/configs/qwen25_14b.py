"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    source="hf:Qwen/Qwen2.5-0.5B (Qwen2.5 family card, 14B row)",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, activation="silu",
)


def smoke_config():
    return reduced(CONFIG)
