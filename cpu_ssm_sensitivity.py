#!/usr/bin/env python3
"""How far rounding moves mamba2-780m on the CPU, at full width, in the
port and in the JAX reference.

  JAX_PLATFORMS=cpu PYTHONPATH=src python3 cpu_ssm_sensitivity.py

The readings that chip_smoke.py's ssm and hybrid gates were set from.
For each depth in DEPTHS, the reference draws mamba2-780m at full width
(its own init from PRNGKey(0); then again with A_log and dt_bias set to
Mamba-2's published init, A ~ U[1, 16], dt ~ logU[1e-3, 0.1]), and the
same weights go into the port through repro_torch.bridge. One TokenStream
prompt of SEQ tokens then runs through

  * the reference in bf16 and with f32 activations (embed_tokens patched
    to f32, as tests/test_decode_consistency.py does),
  * the port in bf16 (weights stored in bf16, as it serves), in bf16
    with a 1-ulp change of a random 1e-5 of every rmsnorm output (about
    what a kernel that sums in another order gives), and with f32
    activations and f32 weights,

and the script prints the relative max error and the argmax agreement of
each pair that says how far rounding moves the answer: the reference's
bf16 against its f32, the port's bf16 against its f32, the port's
flipped bf16 against its bf16, the port's bf16 against the reference's
bf16, and the port's f32 against the reference's f32. Then, at
GRAD_DEPTH layers and 8 x 128 tokens, the port's flat train gradient (f32
masters) in bf16 against the same gradient with f32 activations, and
against the bf16 gradient with the rmsnorm changes, as relative L2
errors; and at smoke size the reference's own bf16 gradient against its
f32 gradient for mamba2 and jamba. Prints one JSON line per reading;
checks nothing. About 2 minutes on 8 CPU cores.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.layers as JL
from repro.checkpoint.store import _flatten
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import value_and_flat_grad
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model

ARCH = "mamba2-780m"
DEPTHS = (4, 8, 12, 24)
SEQ = 256
GRAD_DEPTH = 4
FLIP_SHARE = 1e-5


class Flips:
    """Replaces the port's plain rmsnorm with one that moves a random
    FLIP_SHARE of its outputs up by one ulp, from a seeded generator."""

    def __init__(self, seed: int = 5):
        self.gen = torch.Generator().manual_seed(seed)
        self.inner = ref.rmsnorm_ref

    def __call__(self, x, w, *, eps=1e-6):
        y = self.inner(x, w, eps=eps)
        flip = torch.rand(y.shape, generator=self.gen) < FLIP_SHARE
        return torch.where(flip, torch.nextafter(y, torch.full_like(y, math.inf)), y)

    def __enter__(self):
        ref.rmsnorm_ref = self
        return self

    def __exit__(self, *exc):
        ref.rmsnorm_ref = self.inner


@contextlib.contextmanager
def f32_activations():
    """Both packages' activations in f32: embed_tokens keeps the f32 rows."""
    inner_t, inner_j = L.embed_tokens, JL.embed_tokens
    L.embed_tokens = lambda e, t, scale=None: e[t.long()].float()
    JL.embed_tokens = lambda e, t, scale=None: jnp.take(e, t, axis=0).astype(jnp.float32)
    try:
        yield
    finally:
        L.embed_tokens, JL.embed_tokens = inner_t, inner_j


def published_init(flat: dict, cfg, seed: int = 1) -> dict:
    """``flat`` with A_log and dt_bias drawn as Mamba-2's published init."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_ssm_heads)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), shape))
    return dict(flat, **{"layers/A_log": np.log(rng.uniform(1, 16, shape)).astype(np.float32),
                         "layers/dt_bias": (dt + np.log(-np.expm1(-dt))).astype(np.float32)})


def agreement(got, want) -> dict:
    got, want = (a.float() if isinstance(a, torch.Tensor) else torch.tensor(a)
                 for a in (got, want))
    return {"rel_err": float((got - want).abs().max() / want.abs().max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean())}


def forward_readings(depth: int) -> list[dict]:
    jcfg = dataclasses.replace(jax_config(ARCH), n_layers=depth)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=depth)
    jmodel, model, model32 = jax_build_model(jcfg), build_model(cfg), build_model(cfg, torch.float32)
    drawn = {k: np.asarray(v) for k, v in _flatten(jmodel.init(jax.random.PRNGKey(0))).items()}
    tokens = TokenStream(cfg.vocab_size, SEQ, seed=5).batch(0, 1)["tokens"]
    jforward = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])
    out = []
    for init, flat in (("model", drawn), ("published", published_init(drawn, cfg))):
        jp = _unflatten({k: jnp.asarray(v) for k, v in flat.items()})
        params = params_from_numpy(flat, cfg, "cpu")
        params32 = params_from_numpy(flat, cfg, "cpu", torch.float32)
        t = torch.from_numpy(tokens)
        ref_bf16 = np.asarray(jforward(jp, jnp.asarray(tokens)), np.float32)
        with torch.no_grad():
            port_bf16 = model.forward(params, {"tokens": t})[0]
            with Flips():
                flipped = model.forward(params, {"tokens": t})[0]
            with f32_activations():
                jforward_f32 = jax.jit(lambda p, x: jmodel.forward(p, {"tokens": x})[0])
                ref_f32 = np.asarray(jforward_f32(jp, jnp.asarray(tokens)), np.float32)
                port_f32 = model32.forward(params32, {"tokens": t})[0]
        out.append({"depth": depth, "seq": SEQ, "init": init,
                    "reference_bf16_vs_reference_f32": agreement(ref_bf16, ref_f32),
                    "port_bf16_vs_port_f32": agreement(port_bf16, port_f32),
                    "port_flips_vs_port_bf16": agreement(flipped, port_bf16),
                    "port_bf16_vs_reference_bf16": agreement(port_bf16, ref_bf16),
                    "port_f32_vs_reference_f32": agreement(port_f32, ref_f32)})
        del jp, params, params32
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def gradient_readings() -> dict:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=GRAD_DEPTH)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(cfg.vocab_size, 128, seed=0).batch(0, 8).items()}
    _, bf16 = value_and_flat_grad(model, params, batch)
    with f32_activations():
        _, f32 = value_and_flat_grad(model, params, batch)
    with Flips():
        _, flipped = value_and_flat_grad(model, params, batch)
    return {"depth": GRAD_DEPTH, "tokens": 1024, "bf16_vs_f32": rel_l2(bf16, f32),
            "flips_vs_bf16": rel_l2(flipped, bf16)}


def reference_gradient_readings() -> list[dict]:
    """The reference's bf16 gradient against its f32 gradient, smoke size."""
    out = []
    for arch in (ARCH, "jamba-v0.1-52b"):
        model = jax_build_model(jax_smoke_config(arch))
        params = model.init(jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        batch = {k: jnp.asarray(v) for k, v in
                 TokenStream(cfg.vocab_size, 64, seed=1).batch(0, 4).items()}

        def flat_grad():
            g = jax.grad(lambda p: model.loss(p, batch))(params)
            return np.concatenate([np.asarray(v, np.float64).reshape(-1)
                                   for v in _flatten(g).values()])

        bf16 = flat_grad()
        with f32_activations():
            f32 = flat_grad()
        out.append({"reference": arch, "smoke": True,
                    "bf16_vs_f32": float(np.linalg.norm(bf16 - f32) / np.linalg.norm(f32))})
    return out


def main() -> None:
    for depth in DEPTHS:
        for r in forward_readings(depth):
            print(json.dumps({"forward": r}), flush=True)
    print(json.dumps({"gradient": gradient_readings()}), flush=True)
    for r in reference_gradient_readings():
        print(json.dumps({"gradient": r}), flush=True)


if __name__ == "__main__":
    main()
