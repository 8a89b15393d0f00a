"""Model flops a trained token of the Mamba-2 family, frozen for
``train_mfu``: six a token for each parameter that enters a matrix product
(the in projections to z, x, B, C and dt, the out projection and the
unembedding; not the embedding gather, the depthwise conv taps, the gains
or A, D, dt_bias), plus the SSD's chunk products from their shapes, times
three for forward and backward. A chunk of Q tokens with state N, H heads
of P: C.B over the (Q + 1) / 2 pairs (i, j <= i) a token sees, 2 N each;
the intra-chunk product over the same pairs, 2 H P each; the inter-chunk
read C.h and the state update, 2 N H P each. Nothing recomputed is
counted."""
from __future__ import annotations


def heads(m: dict) -> int:
    return m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]


def matmul_params(m: dict) -> int:
    D, P, N = m["d_model"], m["ssm_headdim"], m["ssm_state"]
    H = heads(m)
    per_layer = 2 * D * H * P + 2 * D * N + D * H + H * P * D
    return m["n_layers"] * per_layer + m["vocab_size"] * D


def ssd_forward_per_token(m: dict, seq: int) -> float:
    Q = min(m["ssm_chunk"], seq)
    N, P, H = m["ssm_state"], m["ssm_headdim"], heads(m)
    pairs = (Q + 1) / 2
    return pairs * 2 * N + pairs * 2 * H * P + 2 * (2 * N * H * P)


def per_token(m: dict, seq: int) -> float:
    return 6.0 * matmul_params(m) + 3.0 * m["n_layers"] * ssd_forward_per_token(m, seq)
