"""Plain f32 reference of the Mamba-2 family (``"family": "ssm"``:
mamba2-780m): pre-norm layers of the Mamba-2 mixer (arXiv:2405.21060):
projections to z, x, B, C and dt; depthwise causal convolutions of x, B and
C followed by SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD
scan, computed a chunk at a time (the quadratic form inside a chunk, the
state carried between chunks); the D skip, the SiLU gate of z, a gated
RMSNorm with a gain per head, and the output projection. No attention.

Written from the paper's equations in plain PyTorch for the benchmark's
comparison: it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import _common as C
from portbench.weights import Leaf


def layout(m: dict) -> dict:
    """Each parameter's path, shape and draw: matrices with std 1/sqrt(fan-in
    of their product), conv taps N(0, 0.5**2), the norm gains 0, D 1, and A
    and dt as Mamba-2 initialises them (A ~ U[1, 16], dt log-uniform in
    [1e-3, 1e-1] through dt_bias)."""
    L, D, V = m["n_layers"], m["d_model"], m["vocab_size"]
    P, N, K = m["ssm_headdim"], m["ssm_state"], m["ssm_conv"]
    H = m["ssm_expand"] * D // P
    def s(n):
        return 1 / math.sqrt(n)
    return {"embed": Leaf((V, D), std=s(D)), "unembed": Leaf((V, D), std=s(D)),
            "final_norm/scale": Leaf((D,), "zeros"),
            "layers/norm/scale": Leaf((L, D), "zeros"),
            "layers/wz": Leaf((L, D, H, P), std=s(D)),
            "layers/wx": Leaf((L, D, H, P), std=s(D)),
            "layers/wB": Leaf((L, D, N), std=s(D)),
            "layers/wC": Leaf((L, D, N), std=s(D)),
            "layers/wdt": Leaf((L, D, H), std=s(D)),
            "layers/conv_x": Leaf((L, K, H, P), std=0.5),
            "layers/conv_B": Leaf((L, K, N), std=0.5),
            "layers/conv_C": Leaf((L, K, N), std=0.5),
            "layers/A_log": Leaf((L, H), "a_log", lo=1.0, hi=16.0),
            "layers/D_skip": Leaf((L, H), "ones"),
            "layers/dt_bias": Leaf((L, H), "dt_bias", lo=1e-3, hi=1e-1),
            "layers/gnorm/scale": Leaf((L, H, P), "zeros"),
            "layers/wo": Leaf((L, H, P, D), std=s(H * P))}


def causal_conv(x, w):
    """y[t] = sum_k x[t - K + 1 + k] w[k] along dim 1, zeros before the
    start. x [B, S, ...], w [K, ...]."""
    K, S = w.shape[0], x.shape[1]
    pad = torch.cat([x.new_zeros((x.shape[0], K - 1) + x.shape[2:]), x], dim=1)
    return sum(pad[:, k:k + S] * w[k] for k in range(K))


def ssd(x, B, Cm, dt, dA, chunk: int):
    """y[t] = sum_{s <= t} (C[t] . B[s]) exp(sum_{s < r <= t} dA[r]) dt[s] x[s],
    a chunk at a time. x [b, S, H, P], B/C [b, S, N], dt/dA [b, S, H]."""
    b, S, H, P = x.shape
    h = x.new_zeros((b, H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        xc, Bc, Cc, dtc = x[:, c0:c1], B[:, c0:c1], Cm[:, c0:c1], dt[:, c0:c1]
        cs = torch.cumsum(dA[:, c0:c1], dim=1)                        # [b,q,H]
        q = c1 - c0
        lower = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        seg = (cs[:, :, None, :] - cs[:, None, :, :]).masked_fill(
            ~lower[None, :, :, None], float("-inf"))                  # [b,i,j,H]
        w = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * torch.exp(seg) * dtc[:, None]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.einsum("bin,bhpn->bihp", Cc, h) * torch.exp(cs)[..., None]
        ys.append(y)
        carry = torch.exp(cs[:, -1:] - cs) * dtc                      # [b,q,H]
        h = h * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "bjh,bjn,bjhp->bhpn", carry, Bc, xc)
    return torch.cat(ys, dim=1)


def mixer(p: dict, x, m: dict):
    z = torch.einsum("bsd,dhp->bshp", x, p["wz"])
    xs = torch.einsum("bsd,dhp->bshp", x, p["wx"])
    B, Cm = x @ p["wB"], x @ p["wC"]
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"])
    xs = F.silu(causal_conv(xs, p["conv_x"]))
    B, Cm = F.silu(causal_conv(B, p["conv_B"])), F.silu(causal_conv(Cm, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])
    dA = dt * -torch.exp(p["A_log"])
    y = ssd(xs, B, Cm, dt, dA, m["ssm_chunk"])
    y = (y + p["D_skip"][:, None] * xs) * F.silu(z)
    y = C.rmsnorm(y, p["gnorm/scale"])
    return torch.einsum("bshp,hpd->bsd", y, p["wo"])


def layer(p: dict, x, m: dict):
    return x + mixer(p, C.rmsnorm(x, p["norm/scale"]), m)

