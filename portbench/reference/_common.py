"""What every family's reference shares: RMSNorm, the training steps
(gradient accumulation over microbatches, the mean over ranks, AdamW) and
the readings compared with the program's.

A family module (``reference/<family>.py``) gives ``layout(m)`` and, for a
decoder of one stack of like layers under ``layers/``, ``layer(p, x, m)``:
``loss_and_grad`` below runs it. A family of other shape gives its own
``loss_and_grad(P, G, tokens, labels, m)`` (one microbatch's loss, its
gradient added into G) and ``stacks(m)`` (path prefix to stack depth, as
``weights.segments`` takes it); the defaults are this module's.

Plain PyTorch in f32 with TF32 off. Each loss and gradient is computed
layer by layer: a forward pass keeps only each layer's input, then each
layer is run again under autograd and differentiated alone, so that a
full-width model fits beside its state. ``master`` is the dtype in which
the parameters and AdamW's moments are kept: f32, or bf16 for the
control (the step a program that halves AdamW's bytes would take).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from portbench import weights


def rmsnorm(x, w, eps: float = 1e-6):
    """x * rsqrt(mean(x**2) + eps) * (1 + w) over the last dim; w is [D], or
    [G, D] with x ending in [G, D]."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def cross_entropy(x, unembed, labels):
    """Mean next-token cross-entropy of the hidden states x [B, S, D]."""
    logits = torch.einsum("bsd,vd->bsv", x, unembed)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaves(flat: torch.Tensor, layout: dict) -> dict:
    """Views of ``flat`` by path, shaped as the layout says."""
    return {path: flat[a:b].view(layout[path].shape)
            for path, a, b in weights.offsets(layout)}


def layer_params(P: dict, i: int, prefix: str = "layers/") -> dict:
    """Layer i of every stacked leaf, as f32 leaves that require grad."""
    return {k[len(prefix):]: P[k][i].float().detach().requires_grad_()
            for k in P if k.startswith(prefix)}


def add_layer_grads(G: dict, lp: dict, i: int, prefix: str = "layers/") -> None:
    for k, t in lp.items():
        if t.grad is not None:
            G[prefix + k][i] += t.grad


def backprop_layers(layer, P: dict, G: dict, inputs: list, gx):
    """Run each layer again from its saved input, last first, and add its
    parameters' gradients into G; returns the gradient of the first
    layer's input. ``layer(lp, x)`` is one layer's forward."""
    for i in reversed(range(len(inputs))):
        x = inputs[i].detach().requires_grad_()
        lp = layer_params(P, i)
        with torch.enable_grad():
            layer(lp, x).backward(gx)
        add_layer_grads(G, lp, i)
        gx = x.grad
    return gx


def loss_and_grad(family, P: dict, G: dict, tokens, labels, m: dict):
    """The loss of one microbatch of a decoder LM whose layers are
    ``family.layer``: the embedding, the layers, a final RMSNorm, the
    unembedding (the embedding itself where the layout has no
    ``unembed``: tied) and the mean cross-entropy. Its gradient is added
    into G."""
    x = P["embed"][tokens.long()].float()
    inputs = []
    with torch.no_grad():
        for i in range(m["n_layers"]):
            inputs.append(x)
            x = family.layer({k[7:]: P[k][i].float() for k in P
                              if k.startswith("layers/")}, x, m)
    xh = x.detach().requires_grad_()
    fin = P["final_norm/scale"].float().detach().requires_grad_()
    out = "unembed" if "unembed" in P else "embed"
    une = P[out].float().detach().requires_grad_()
    with torch.enable_grad():
        loss = cross_entropy(rmsnorm(xh, fin), une, labels)
        loss.backward()
    G["final_norm/scale"] += fin.grad
    G[out] += une.grad
    gx = backprop_layers(lambda lp, xi: family.layer(lp, xi, m), P, G, inputs, xh.grad)
    G["embed"].index_add_(0, tokens.reshape(-1).long(), gx.reshape(-1, gx.shape[-1]))
    return loss.detach()


def segments(family, m: dict, layout: dict) -> list:
    """The segments both sides' readings are split into, by the family's
    stacks of layers: ``family.stacks(m)``, or the one stack ``layers/``
    of ``n_layers``."""
    stacks = family.stacks(m) if hasattr(family, "stacks") else {"layers/": m["n_layers"]}
    return weights.segments(layout, stacks)


def adamw(p, g, m, v, t: int, lr: float, hp: dict) -> None:
    """One AdamW step over flat buffers, in place: bias-corrected moments
    and decoupled weight decay, computed in f32 a chunk at a time and kept
    in the buffers' dtype."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for s in range(0, p.numel(), weights.CHUNK):
        e = s + weights.CHUNK
        gs = g[s:e]
        ms = m[s:e].float() * b1 + (1.0 - b1) * gs
        vs = v[s:e].float() * b2 + (1.0 - b2) * gs * gs
        ps = p[s:e].float()
        ps -= lr * (ms / c1 / (torch.sqrt(vs / c2) + eps) + wd * ps)
        m[s:e].copy_(ms)
        v[s:e].copy_(vs)
        p[s:e].copy_(ps)


def train_readings(family, model: dict, layout: dict, seed: int, steps: list,
                   lr: float, hp: dict, device, master=torch.float32,
                   group=None) -> dict:
    """The reference's readings of ``len(steps)`` training steps from the
    weights of ``seed``: each step's loss (this rank's, the mean over its
    microbatches), the norm of each segment of the first step's gradient
    (the mean over microbatches and ranks) and the number of the leaves'
    rows it reaches, and the norm of each segment's change after the last
    step. ``steps[i]``: this rank's microbatches of step i,
    a list of (tokens, labels) on ``device``."""
    segs = segments(family, model, layout)
    step_loss = getattr(family, "loss_and_grad", None) or (
        lambda *a: loss_and_grad(family, *a))
    with full_f32():
        p = weights.draw(layout, seed, device).to(master)
        g = torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        P, G = leaves(p, layout), leaves(g, layout)
        losses, grad_norms = [], None
        for t, micro in enumerate(steps, start=1):
            g.zero_()
            loss = sum(step_loss(P, G, tok, lab, model) for tok, lab in micro)
            g.div_(len(micro))
            if group is not None or dist.is_initialized():
                dist.all_reduce(g, group=group)
                g.div_(dist.get_world_size(group))
            losses.append(float(loss) / len(micro))
            if t == 1:
                grad_norms = weights.segment_norms(g, segs)
                rows = weights.nonzero_rows(g, layout)
            adamw(p, g, m, v, t, lr, hp)
        change = weights.segment_norms(p, segs, weights.chunks(layout, seed, device))
    return {"losses": losses, "grad_norms": grad_norms, "grad_rows": rows,
            "change_norms": change,
            "segments": [name for name, _, _ in segs]}

