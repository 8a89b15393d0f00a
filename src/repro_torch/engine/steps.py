"""Step builders for serving: prefill and decode-step closures over a model
(torch twin of ``repro.engine.steps``; the train step comes with the
trainer slice).

They run on the GPU unless the caller passes ``device="cpu"``: with no GPU
and no ``device="cpu"`` they raise.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import NO_SHARD, Sharder


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run its plain versions on the CPU")
    return dev


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _check_params(params: dict, device: torch.device) -> None:
    where = params["embed"].device
    if where.type != device.type:
        raise ValueError(f"params are on {where}, the step runs on {device}")


def make_prefill(model, sh: Sharder = NO_SHARD, window: int | None = None,
                 device="cuda"):
    """(params, batch {tokens [B, S]}) -> logits [B, S, V] f32."""
    dev = resolve_device(device)

    def prefill(params, batch):
        _check_params(params, dev)
        return model.prefill(params, _on(batch, dev), sh, window=window)

    return prefill


def make_decode_step(model, sh: Sharder = NO_SHARD,
                     window: int | None = None, device="cuda"):
    """(params, cache, batch {tokens [B, 1], pos [B]}) -> (logits [B, 1, V], cache);
    the cache is updated in place."""
    dev = resolve_device(device)

    def decode_step(params, cache, batch):
        _check_params(params, dev)
        return model.decode_step(params, cache, _on(batch, dev), sh,
                                 window=window)

    return decode_step
