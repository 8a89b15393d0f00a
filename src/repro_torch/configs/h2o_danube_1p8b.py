"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    source="arXiv:2401.16818 (H2O-Danube 1.8B)",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_head=80,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0, activation="silu",
)


def smoke_config():
    return reduced(CONFIG)
