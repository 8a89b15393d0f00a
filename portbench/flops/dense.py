"""Model flops a trained token of the dense decoder family, frozen for
``train_mfu``: six a token for each parameter that enters a matrix product
(the attention and MLP matrices and the unembedding; not the embedding
gather, the norm gains or the biases), plus causal attention's q.k and
p.v, 6 * layers * (heads * head dim) * S a token (forward and backward,
over the (S + 1) / 2 keys a query sees on average, rounded to S / 2).
Nothing recomputed is counted."""
from __future__ import annotations


def matmul_params(m: dict) -> int:
    D, H, Hk, Dh, Fd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"], m["d_ff"]
    per_layer = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D + 3 * D * Fd
    return m["n_layers"] * per_layer + m["vocab_size"] * D


def per_token(m: dict, seq: int) -> float:
    return 6.0 * matmul_params(m) + 6.0 * m["n_layers"] * m["n_heads"] * m["d_head"] * seq
