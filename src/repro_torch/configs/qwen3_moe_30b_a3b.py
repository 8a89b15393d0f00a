"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained expert d_ff=768.
[hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab_size=151936,  # d_ff = per-expert (moe_intermediate_size)
    n_experts=128, top_k=8, rope_theta=1_000_000.0,
)


def smoke_config():
    return reduced(CONFIG)
