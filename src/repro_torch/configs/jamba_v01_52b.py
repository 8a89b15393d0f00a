"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    source="arXiv:2403.19887 (Jamba v0.1)",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2, rope_theta=0.0,  # no PE (Mamba provides position)
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    attn_every=8,  # one attention layer per 8-layer block (1:7)
)


def smoke_config():
    return reduced(CONFIG)
