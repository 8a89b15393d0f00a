"""Plain f32 reference of the Jamba-style hybrid family (``"family":
"hybrid"``, arXiv:2403.19887), for the CPU tests only: a family of two
kinds of layer and an auxiliary loss, compared through the benchmark's
hooks with no edit to the harness (a test points
``harness.family_module`` here).

A block of ``attn_every`` layers repeats ``n_layers / attn_every`` times;
each position's parameters are stacked over the blocks under
``blocks/pos{p}/``. The layer at ``attn_every // 2`` is grouped-query
causal attention without positional encoding (``rope_theta`` 0), the others
Mamba-2 mixers (``reference.ssm``'s, pre-norm under ``mamba/norm``); each
layer then has an FFN, a Switch MoE at the odd positions when the model
has experts (``moe_every`` 2), else a SwiGLU MLP. The loss is the mean
next-token cross-entropy plus 0.01 times the load-balance term summed over
the MoE layers.

The MoE, from Switch Transformer (arXiv:2101.03961) and GShard: router
probabilities p = softmax(x W_r) over E experts; each token goes to the
top_k experts (ties to the lower index), weighted by their probabilities
renormalised to sum 1; the term is E * sum_e f_e * P_e, f_e the share of
the microbatch's tokens whose first choice is e and P_e the mean of p_e.
Every token reaches its experts: the smoke size is chosen so that an
expert's capacity holds every token of a row, so nothing is dropped.

Written from those equations; it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import _common as C
from portbench.reference import dense, ssm
from portbench.weights import Leaf

AUX = 0.01  # the load-balance term's weight in the loss


def n_blocks(m: dict) -> int:
    return m["n_layers"] // m["attn_every"]


def is_moe(m: dict, pos: int) -> bool:
    return m["n_experts"] > 0 and pos % m["moe_every"] == 1


def stacks(m: dict) -> dict:
    return {"blocks/": n_blocks(m)}


def _restack(layout: dict, part: str, to: str) -> dict:
    """The leaves of ``layout`` under ``layers/<part>`` as ``<to>...``."""
    head = f"layers/{part}"
    return {to + k[len(head):]: v for k, v in layout.items() if k.startswith(head)}


def layout(m: dict) -> dict:
    """As ``dense`` and ``ssm`` draw them, stacked over the blocks."""
    nb, D, E, Fd = n_blocks(m), m["d_model"], m["n_experts"], m["d_ff"]
    per_block = {**m, "n_layers": nb}
    attn, mamba = dense.layout(per_block), ssm.layout(per_block)
    out = {"embed": Leaf((m["vocab_size"], D), std=1 / math.sqrt(D)),
           "unembed": Leaf((m["vocab_size"], D), std=1 / math.sqrt(D)),
           "final_norm/scale": Leaf((D,), "zeros")}
    for pos in range(m["attn_every"]):
        at = f"blocks/pos{pos}/"
        if pos == m["attn_every"] // 2:
            out.update(_restack(attn, "ln1/", at + "ln1/"))
            out.update(_restack(attn, "attn/", at + "attn/"))
        else:
            out.update(_restack(mamba, "", at + "mamba/"))
        out[at + "ln2/scale"] = Leaf((nb, D), "zeros")
        if is_moe(m, pos):
            out.update({at + "moe/router": Leaf((nb, D, E), std=1 / math.sqrt(D)),
                        at + "moe/wi_gate": Leaf((nb, E, D, Fd), std=1 / math.sqrt(D)),
                        at + "moe/wi_up": Leaf((nb, E, D, Fd), std=1 / math.sqrt(D)),
                        at + "moe/wo": Leaf((nb, E, Fd, D), std=1 / math.sqrt(Fd))})
        else:
            out.update(_restack(attn, "mlp/", at + "mlp/"))
    return out


def attention(p: dict, x, m: dict):
    """Causal GQA without positional encoding: query head h reads key and
    value head h * Hk // H."""
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = torch.einsum("bsd,dhk->bshk", x, p["attn/wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["attn/wk"]).repeat_interleave(H // Hk, dim=2)
    v = torch.einsum("bsd,dhk->bshk", x, p["attn/wv"]).repeat_interleave(H // Hk, dim=2)
    s = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bshk,hkd->bsd", torch.einsum("bhqk,bkhd->bqhd", w, v), p["attn/wo"])


def swiglu(x, gate, up, out):
    return (F.silu(x @ gate) * (x @ up)) @ out


def moe(p: dict, x, m: dict):
    """-> (the experts' weighted sum [B, S, D], the load-balance term)."""
    E, K = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ p["moe/router"], dim=-1)                   # [B,S,E]
    top, idx = (t[..., :K] for t in torch.sort(probs, dim=-1, descending=True,
                                                stable=True))
    gate = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    weight = torch.einsum("bsk,bske->bse", gate, F.one_hot(idx, E).to(x.dtype))
    experts = torch.einsum("bsd,edf->bsef", x, p["moe/wi_gate"])
    experts = F.silu(experts) * torch.einsum("bsd,edf->bsef", x, p["moe/wi_up"])
    out = torch.einsum("bse,bsef,efd->bsd", weight, experts, p["moe/wo"])
    first = F.one_hot(idx[..., 0], E).to(x.dtype).mean(dim=(0, 1))
    return out, E * torch.sum(first * probs.mean(dim=(0, 1)))


def block(p: dict, x, m: dict):
    """One block of ``attn_every`` layers -> (x, its load-balance terms)."""
    aux = x.new_zeros(())
    for pos in range(m["attn_every"]):
        at = f"pos{pos}/"
        q = {k[len(at):]: v for k, v in p.items() if k.startswith(at)}
        if pos == m["attn_every"] // 2:
            x = x + attention(q, C.rmsnorm(x, q["ln1/scale"]), m)
        else:
            mix = {k[len("mamba/"):]: v for k, v in q.items() if k.startswith("mamba/")}
            x = x + ssm.mixer(mix, C.rmsnorm(x, mix["norm/scale"]), m)
        h = C.rmsnorm(x, q["ln2/scale"])
        if is_moe(m, pos):
            out, a = moe(q, h, m)
            x, aux = x + out, aux + a
        else:
            x = x + swiglu(h, q["mlp/wi_gate"], q["mlp/wi_up"], q["mlp/wo"])
    return x, aux


def loss_and_grad(P: dict, G: dict, tokens, labels, m: dict):
    """One microbatch's loss, cross-entropy plus AUX times the load-balance
    terms, block by block as ``_common.loss_and_grad`` runs layers; its
    gradient is added into G."""
    x = P["embed"][tokens.long()].float()
    inputs, aux = [], 0.0
    with torch.no_grad():
        for b in range(n_blocks(m)):
            inputs.append(x)
            x, a = block({k[7:]: P[k][b].float() for k in P if k.startswith("blocks/")},
                         x, m)
            aux = aux + a
    xh = x.detach().requires_grad_()
    fin = P["final_norm/scale"].float().detach().requires_grad_()
    une = P["unembed"].float().detach().requires_grad_()
    with torch.enable_grad():
        ce = C.cross_entropy(C.rmsnorm(xh, fin), une, labels)
        ce.backward()
    G["final_norm/scale"] += fin.grad
    G["unembed"] += une.grad
    gx = xh.grad
    for b in reversed(range(n_blocks(m))):
        xi = inputs[b].detach().requires_grad_()
        lp = C.layer_params(P, b, "blocks/")
        with torch.enable_grad():
            out, a = block(lp, xi, m)
            grads = [gx] + ([a.new_tensor(AUX)] if a.requires_grad else [])
            torch.autograd.backward([out, a][:len(grads)], grads)
        C.add_layer_grads(G, lp, b, "blocks/")
        gx = xi.grad
    G["embed"].index_add_(0, tokens.reshape(-1).long(), gx.reshape(-1, gx.shape[-1]))
    return (ce + AUX * aux).detach()

