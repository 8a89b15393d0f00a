"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab_size=100352,  # d_ff per expert
    n_experts=16, top_k=4, rope_theta=500_000.0,
)


def smoke_config():
    return reduced(CONFIG)
