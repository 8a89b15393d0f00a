"""ResNet (6n+2, non-bottleneck) for CIFAR-10 — the paper's own workload
(torch twin of ``repro.models.resnet``).

GroupNorm replaces BatchNorm so the model is stateless, as in the
reference. Public functions keep the reference's layouts: images and
activations NHWC ``[B, H, W, C]``, conv weights HWIO, the residual blocks
after each stage's first stacked along a leading dim (``stageK_rest``).
Convolutions run on ``x.permute(0, 3, 1, 2)``, a zero-copy channels-last
view, with the weight as ``w.permute(3, 2, 0, 1)``, cast at use.

``"SAME"`` padding is computed from the input size as XLA does: with
stride 2 on an even size it pads 0 before and 1 after (``padding=1``
would pad both sides and shift every window).

The reference rematerialises each stacked block in the backward pass
(``jax.checkpoint`` inside its ``lax.scan``) to bound activation memory on
a TPU. Here the blocks are a Python loop with no recomputation: the saved
activations of all 110 layers fit one 80 GB card at the batches the
trainer runs (peak memory in PERF.md), and recomputing them would add a
forward pass to every step.

Parameters are one FlatTree (``models.spec``): every leaf, f32 as the
reference declares it, views one flat buffer that the optimizer updates
in a single kernel launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.spec import TensorSpec as TS, init_flat


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME": output ceil(size / stride), padding split low-first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] NHWC, w [kh, kw, Cin, Cout] HWIO -> NHWC, "SAME"."""
    kh, kw = w.shape[:2]
    (top, bottom), (left, right) = (_same_pads(x.shape[1], kh, stride),
                                    _same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).to(x.dtype)
    if top == bottom and left == right:
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC with min(groups, C) groups; statistics and affine
    in f32, output in ``x.dtype``."""
    c = x.shape[-1]
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), min(groups, c),
                     scale.float(), bias.float(), eps)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _block_specs(n, cin, cout):
    return {
        "conv1": TS((n, 3, 3, cin, cout), ("layers", None, None, None, None)),
        "n1s": TS((n, cout), ("layers", None), init="ones"),
        "n1b": TS((n, cout), ("layers", None), init="zeros"),
        "conv2": TS((n, 3, 3, cout, cout), ("layers", None, None, None, None)),
        "n2s": TS((n, cout), ("layers", None), init="ones"),
        "n2b": TS((n, cout), ("layers", None), init="zeros"),
    }


class ResNetModel:
    """``dtype``: the activation dtype (bf16, as the reference; the tests
    run f32). Parameters stay f32 and are cast at use."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.dtype = dtype
        self.widths = [cfg.width, cfg.width * 2, cfg.width * 4]

    def param_specs(self) -> dict:
        cfg = self.cfg
        n = cfg.n
        p: dict = {"stem": TS((3, 3, 3, self.widths[0]),
                              (None, None, None, None)),
                   "stem_s": TS((self.widths[0],), (None,), init="ones"),
                   "stem_b": TS((self.widths[0],), (None,), init="zeros")}
        cin = self.widths[0]
        for si, cout in enumerate(self.widths):
            p[f"stage{si}_first"] = _block_specs(1, cin, cout)
            if n > 1:
                p[f"stage{si}_rest"] = _block_specs(n - 1, cout, cout)
            cin = cout
        p["fc"] = TS((self.widths[-1], cfg.num_classes), (None, None))
        p["fc_b"] = TS((cfg.num_classes,), (None,), init="zeros")
        return p

    def init(self, generator: torch.Generator, device):
        """Random parameters as one FlatTree; ``generator`` lives on ``device``."""
        return init_flat(generator, self.param_specs(), device)

    def _apply_block(self, p, x, stride=1):
        h = conv(x, p["conv1"], stride)
        h = torch.relu(groupnorm(h, p["n1s"], p["n1b"]))
        h = conv(h, p["conv2"], 1)
        h = groupnorm(h, p["n2s"], p["n2b"])
        if stride != 1 or x.shape[-1] != h.shape[-1]:
            x = x[:, ::stride, ::stride, :]  # identity shortcut (option A)
            x = F.pad(x, (0, h.shape[-1] - x.shape[-1]))
        return torch.relu(x + h)

    def apply(self, params, images) -> torch.Tensor:
        """images [B, 32, 32, 3] -> logits [B, classes] f32."""
        x = torch.as_tensor(images).to(self.dtype)
        x = torch.relu(groupnorm(conv(x, params["stem"]),
                                 params["stem_s"], params["stem_b"]))
        for si in range(3):
            stride = 1 if si == 0 else 2
            first = {k: v[0] for k, v in params[f"stage{si}_first"].items()}
            x = self._apply_block(first, x, stride)
            rest = params.get(f"stage{si}_rest")
            if rest is not None:
                # one unbind per stacked tensor (its gradient is one
                # stack), or the tuple of per-layer leaves that training
                # differentiates (engine.steps)
                slices = {k: v if isinstance(v, tuple) else v.unbind(0)
                          for k, v in rest.items()}
                for i in range(self.cfg.n - 1):
                    x = self._apply_block({k: s[i] for k, s in slices.items()}, x)
        x = x.mean(dim=(1, 2)).float()
        return x @ params["fc"].float() + params["fc_b"]

    def loss(self, params, batch, sh=None) -> torch.Tensor:
        logits = self.apply(params, batch["images"])
        labels = torch.as_tensor(batch["labels"], device=logits.device).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(lse - gold)

    def accuracy(self, params, batch) -> torch.Tensor:
        logits = self.apply(params, batch["images"])
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        return torch.mean((logits.argmax(-1) == labels).float())

