"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    source="arXiv:2405.21060 (Mamba-2 780m)",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
)


def smoke_config():
    return reduced(CONFIG)
