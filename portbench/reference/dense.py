"""Plain f32 reference of the dense decoder family (``"family": "dense"``:
qwen2.5-3b): pre-norm layers of grouped-query causal attention with RoPE
and QKV biases, then a SwiGLU MLP; RMSNorm with gain 1 + w; the
embedding doubles as the unembedding where ``tie_embeddings`` says so, as
Qwen2.5-3B's does; mean next-token cross-entropy.

Written from the architecture's equations (Qwen2.5, arXiv:2412.15115), in
plain PyTorch, for the benchmark's comparison: it imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import _common as C
from portbench.weights import Leaf


def layout(m: dict) -> dict:
    """Each parameter's path, shape and draw. Matrices are drawn with std
    1/sqrt(fan-in of their product); norm gains and biases start at 0."""
    L, D, H, Hk, Dh, Fd, V = (m["n_layers"], m["d_model"], m["n_heads"],
                              m["n_kv_heads"], m["d_head"], m["d_ff"], m["vocab_size"])
    def s(n):
        return 1 / math.sqrt(n)
    out = {"embed": Leaf((V, D), std=s(D)),
           "final_norm/scale": Leaf((D,), "zeros"),
           "layers/ln1/scale": Leaf((L, D), "zeros"),
           "layers/ln2/scale": Leaf((L, D), "zeros"),
           "layers/attn/wq": Leaf((L, D, H, Dh), std=s(D)),
           "layers/attn/wk": Leaf((L, D, Hk, Dh), std=s(D)),
           "layers/attn/wv": Leaf((L, D, Hk, Dh), std=s(D)),
           "layers/attn/wo": Leaf((L, H, Dh, D), std=s(H * Dh)),
           "layers/mlp/wi_gate": Leaf((L, D, Fd), std=s(D)),
           "layers/mlp/wi_up": Leaf((L, D, Fd), std=s(D)),
           "layers/mlp/wo": Leaf((L, Fd, D), std=s(Fd))}
    if m.get("qkv_bias"):
        out.update({"layers/attn/bq": Leaf((L, H, Dh), "zeros"),
                    "layers/attn/bk": Leaf((L, Hk, Dh), "zeros"),
                    "layers/attn/bv": Leaf((L, Hk, Dh), "zeros")})
    if not m.get("tie_embeddings"):
        out["unembed"] = Leaf((V, D), std=s(D))
    return out


def rope(x, theta: float):
    """Rotate x [B, S, H, Dh] by position: the two halves of the head dim
    as the real and imaginary parts, frequency theta**(-i / (Dh / 2))."""
    half = x.shape[-1] // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x, m: dict):
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = torch.einsum("bsd,dhk->bshk", x, p["attn/wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["attn/wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["attn/wv"])
    if "attn/bq" in p:
        q, k, v = q + p["attn/bq"], k + p["attn/bk"], v + p["attn/bv"]
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    # query head h reads key/value head h * Hk // H
    k, v = k.repeat_interleave(H // Hk, dim=2), v.repeat_interleave(H // Hk, dim=2)
    s = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return torch.einsum("bshk,hkd->bsd", o, p["attn/wo"])


def layer(p: dict, x, m: dict):
    x = x + attention(p, C.rmsnorm(x, p["ln1/scale"]), m)
    h = C.rmsnorm(x, p["ln2/scale"])
    g = F.silu(h @ p["mlp/wi_gate"]) * (h @ p["mlp/wi_up"])
    return x + g @ p["mlp/wo"]

