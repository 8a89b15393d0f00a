"""Batched serving driver: prefill a prompt batch, then greedy-decode
(torch twin of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --prompt-len 128 --new-tokens 32

Any ported LM ``--arch``: dense, MoE (qwen3-moe-30b-a3b, whose bf16
weights take 62.3 GB), the VLM backbone (qwen2-vl-2b, served on text
tokens: like the reference's loop, this one passes no patch embeddings),
the SSM (mamba2-780m, whose decode carries conv windows and an f32 SSM
state in place of a KV cache) or the hybrid (jamba-v0.1-52b: its 103 GB
of bf16 weights need more than one 80 GB card at full depth; ``--smoke``
runs it anywhere) or whisper-base (its decoder over a cache whose encoder
output ``enc`` stays at zeros: like the reference's loop, this one passes
no audio frames; every step's cross-attention reads all 1,500 frames).
Runs on the GPU; ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.steps import make_decode_step, resolve_device
from repro_torch.models import spec as pspec
from repro_torch.models.layers import NO_SHARD, Sharder
from repro_torch.models.registry import build_model, decode_window


def serve(cfg, *, batch: int, prompt_len: int, new_tokens: int,
          params=None, greedy: bool = True, log: bool = True, device="cuda",
          generator: torch.Generator | None = None, return_logits: bool = False,
          sh: Sharder = NO_SHARD):
    """Greedy-decode ``new_tokens`` after TokenStream(seed=3) prompts.

    params: the port's parameter tree on ``device``, or None for random
    weights drawn from ``generator`` (default: seed 0 on ``device``).
    ``sh``: a Sharder with a mesh serves on it: ``params`` are DTensors
    (``models.spec.init_local``), the cache is sharded by the rules, and
    every rank of the mesh gathers each step's logits and takes the same
    tokens.
    ``greedy`` and ``log`` are the reference's: decoding always takes the
    argmax, as in the reference, whatever ``greedy`` says; ``log`` prints
    the ``generated ... tok/s`` line.
    Returns (tokens [batch, new_tokens] int32 numpy, seconds), and with
    ``return_logits`` also the last decode step's logits [batch, 1, vocab].
    """
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        if sh.mesh is not None:
            raise ValueError("serve on a mesh takes its params as DTensors")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = model.init(generator, dev)
    cache_len = prompt_len + new_tokens
    shape = InputShape("serve", cache_len, batch, "decode")
    if sh.mesh is None:
        cache = pspec.init_params(generator, model.cache_specs(shape), dev)
    else:
        cache = pspec.distributed(model.cache_specs(shape), sh.mesh, sh.rules, dev)
    window = decode_window(cfg, cache_len)

    data = TokenStream(cfg.vocab_size, prompt_len, seed=3)
    prompts = torch.as_tensor(data.batch(0, batch)["tokens"], device=dev)

    decode = make_decode_step(model, sh, window=window, device=dev)

    # prefill by stepping the decoder over the prompt (cache-building path;
    # the whole-sequence prefill is make_prefill)
    t0 = time.perf_counter()
    tok = prompts[:, 0:1]
    out_tokens = [tok]
    for t in range(cache_len - 1):
        batch_t = {"tokens": tok,
                   "pos": torch.full((batch,), t, dtype=torch.int32, device=dev)}
        logits, cache = decode(params, cache, batch_t)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        if t + 1 < prompt_len:
            tok = prompts[:, t + 1:t + 2]       # teacher-forced prompt
        else:
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
            out_tokens.append(tok)
        if len(out_tokens) - 1 >= new_tokens:
            break
    gen = torch.cat(out_tokens[1:], dim=1).cpu().numpy()
    seconds = time.perf_counter() - t0
    if log:
        print(f"generated {gen.shape} in {seconds:.2f}s "
              f"({batch * new_tokens / seconds:.1f} tok/s)")
    return (gen, seconds, logits) if return_logits else (gen, seconds)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen, dt = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    new_tokens=args.new_tokens, device=args.device)
    print("sample:", gen[0][:16])


if __name__ == "__main__":
    main()
