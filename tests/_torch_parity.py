"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same numpy values handed to both packages, the f32-activation patch of
tests/test_decode_consistency.py::test_jamba_decode_exact_in_f32 applied
to both (and to whisper's encoder), the f32 patch of the reference's
ResNet, and spawned ranks that run the port's data-parallel entry points
with f32 activations."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

import repro.models.layers as JL
import repro.models.resnet as JR
import repro.models.whisper as JW
import repro_torch.models.layers as TL
import repro_torch.models.whisper as TW

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a jax array and a torch tensor of one dtype
    (both round f32 to bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _jax_embed_f32(embedding, tokens, scale=None):
    x = jnp.take(embedding, tokens, axis=0).astype(jnp.float32)
    return x * scale if scale is not None else x


def _torch_embed_f32(embedding, tokens, scale=None):
    x = embedding[tokens.long()].float()
    return x * scale if scale is not None else x


def patch_f32_embeddings(mp) -> None:
    """Make both packages' ``embed_tokens`` return f32, so every activation
    downstream is f32 (``mp`` is a pytest MonkeyPatch)."""
    mp.setattr(JL, "embed_tokens", _jax_embed_f32)
    mp.setattr(TL, "embed_tokens", _torch_embed_f32)


class _JnpWithF32Bfloat16:
    """``jax.numpy`` with ``bfloat16`` standing for ``float32``."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def patch_resnet_f32(mp) -> None:
    """Run the reference ResNet's activations in f32: its ``apply`` casts
    the images to ``jnp.bfloat16``, so the ``jnp`` name inside
    ``repro.models.resnet`` (and only there) becomes a proxy whose
    ``bfloat16`` is ``float32``. ``mp`` is a pytest MonkeyPatch."""
    mp.setattr(JR, "jnp", _JnpWithF32Bfloat16())


class _TorchWithF32Bfloat16:
    """``torch`` with ``bfloat16`` standing for ``float32``."""

    bfloat16 = torch.float32

    def __getattr__(self, name):
        return getattr(torch, name)


def patch_whisper_f32(mp) -> None:
    """Every whisper activation in f32 in both packages: the embeddings
    (``patch_f32_embeddings``) and the encoder's input, which both
    packages cast to bf16 by name (``jnp.bfloat16``, ``torch.bfloat16``)
    inside their whisper module only."""
    patch_f32_embeddings(mp)
    mp.setattr(JW, "jnp", _JnpWithF32Bfloat16())
    mp.setattr(TW, "torch", _TorchWithF32Bfloat16())


def f32_train_rank(rank, world, argvs, init_method, out_dir):
    """A spawned rank (``launch.explicit_allreduce.spawn``) that runs
    ``repro_torch.launch.train.main(argv)`` for each of ``argvs`` in turn,
    with f32 activations on the CPU; saves the list of their (first, last)
    losses."""
    from repro_torch.launch import mesh, train
    TL.embed_tokens = _torch_embed_f32
    torch.set_num_threads(1)
    mesh.init_data_group(rank, world, init_method, "gloo", "cpu", 60.0)
    try:
        torch.save([train.main(argv) for argv in argvs], Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def f32_dp_rank(rank, run, init_method, out_dir):
    """``launch.explicit_allreduce.train_rank`` with f32 activations."""
    from repro_torch.launch import explicit_allreduce
    TL.embed_tokens = _torch_embed_f32
    explicit_allreduce.train_rank(rank, run, init_method, out_dir)
