"""Weights from the JAX reference into the port.

The reference's parameter tree, flattened to ``/``-joined paths as
``repro.checkpoint.store._flatten`` writes them (``layers/attn/wq``,
``final_norm/scale``, ``embed``, ...), becomes the port's nested dict of
tensors with the same paths. The port never imports the store: callers
flatten the tree themselves.

The port keeps the reference's layouts, so the map is the identity, for
the transformers' ``layers/...``, Mamba-2's ``layers/...``, Jamba's
``blocks/pos{p}/...`` and whisper's ``encoder/...`` and ``decoder/...``
(with the decoder's ``lnx`` and ``xattn``, and ``enc_norm``/``dec_norm``)
alike. Where every parameter is f32 (the ResNet; an
LM stored in f32, as it trains), each array is copied into its view of
one flat parameter buffer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet110 import ResNetConfig
from repro_torch.models import spec as pspec
from repro_torch.models.registry import build_model


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ModelConfig | ResNetConfig,
                      device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Port parameters of ``cfg`` from the reference's flattened tree.

    The reference stores everything in f32 and casts the attention, MLP
    and MoE matmul weights, the QKV biases (whisper's projection and MLP
    biases), and Mamba-2's projections, conv taps and D skip to the
    activation dtype at use (``p["wq"].astype(dt)``). For an LM those are
    stored in ``dtype`` (its ``param_dtype``: bf16 to serve, so that no
    step casts them; float32 to train, or when the model runs in f32).
    Norm gains (and layernorm biases), Mamba-2's ``A_log`` and
    ``dt_bias`` stay f32 (the reference reads them in f32), and
    ``embed``/``unembed`` stay f32 (``lm_logits`` is f32; the embedding is
    gathered, then cast). Where every parameter is f32 (a ResNet, whatever
    ``dtype``; an LM with ``dtype`` float32) they come back as one
    FlatTree (``models.spec``).

    Raises KeyError if a path is missing or extra, ValueError on a shape
    that is not the config's.
    """
    specs = pspec.flatten(build_model(cfg, dtype).param_specs())
    missing, extra = specs.keys() - flat.keys(), flat.keys() - specs.keys()
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    out = {}
    for path, spec in specs.items():
        arr = np.asarray(flat[path])
        if arr.shape != spec.shape:
            raise ValueError(f"{path}: shape {arr.shape}, config wants {spec.shape}")
        out[path] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=spec.dtype)
    if all(spec.dtype == torch.float32 for spec in specs.values()):
        return pspec.flat_tree(out, device)
    return pspec.unflatten(out)
