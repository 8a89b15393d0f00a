"""whisper-base [audio] — encoder-decoder transformer backbone; the
mel-spectrogram + conv frontend is a STUB per assignment (precomputed frame
embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    source="arXiv:2212.04356 (Whisper base)",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, vocab_size=51865,
    activation="gelu", norm="layernorm", rope_theta=0.0,  # sinusoidal pos
    encoder_layers=6, frontend="audio", n_frontend_tokens=1500,
)


def smoke_config():
    return reduced(CONFIG, n_kv_heads=4)
