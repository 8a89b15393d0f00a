"""The port's serving loop (repro_torch.launch.serve) against
repro.launch.serve at smoke size, from the same bridged weights. With f32
activations in both packages the greedy tokens are identical."""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import jax
import numpy as np
import torch

from repro.checkpoint.store import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.launch.serve import serve as jax_serve
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.serve import main, serve
from _torch_parity import patch_f32_embeddings


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b", "h2o-danube-1.8b",
                                  "qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_serve_tokens_identical_in_f32(monkeypatch, arch):
    patch_f32_embeddings(monkeypatch)
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), cfg, "cpu", torch.float32)
    kw = dict(batch=3, prompt_len=12, new_tokens=10)
    want, _ = jax_serve(jcfg, params=jparams, log=False, **kw)
    got, seconds = serve(cfg, params=tparams, device="cpu", **kw)
    assert got.shape == (3, 10) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert seconds > 0


def test_serve_random_weights_bf16():
    """Default path: random weights from a seeded generator, bf16."""
    cfg = get_smoke_config("qwen2.5-3b")
    gen = torch.Generator().manual_seed(7)
    a, _ = serve(cfg, batch=2, prompt_len=8, new_tokens=4, device="cpu",
                 generator=gen)
    b, _ = serve(cfg, batch=2, prompt_len=8, new_tokens=4, device="cpu",
                 generator=torch.Generator().manual_seed(7))
    assert a.shape == (2, 4)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)


def test_serve_returns_last_step_logits():
    """return_logits gives the logits the last generated token came from."""
    cfg = get_smoke_config("gemma-2b")
    tokens, _, logits = serve(cfg, batch=2, prompt_len=6, new_tokens=3,
                              device="cpu", return_logits=True)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    np.testing.assert_array_equal(logits[:, 0].argmax(-1).numpy(), tokens[:, -1])


def test_serve_cli_on_cpu(capsys):
    main(["--arch", "gemma-2b", "--smoke", "--batch", "2", "--prompt-len", "6",
          "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 3)") == 1  # printed by serve, once


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_serve_cli_on_cpu_moe_and_vlm(capsys, arch):
    main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
          "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 3)") == 1 and "sample:" in out


def test_serve_takes_the_reference_keywords(capsys):
    """greedy and log as in repro.launch.serve.serve: log=False prints
    nothing, log=True prints the reference's line, and greedy=True (the
    reference's only mode) leaves the tokens as they are."""
    cfg = get_smoke_config("qwen2.5-3b")
    kw = dict(batch=2, prompt_len=6, new_tokens=3, device="cpu")
    want, _ = serve(cfg, **kw)
    capsys.readouterr()
    quiet, _ = serve(cfg, log=False, **kw)
    assert capsys.readouterr().out == ""
    loud, seconds = serve(cfg, greedy=True, log=True, **kw)
    line = capsys.readouterr().out
    assert line.startswith("generated (2, 3) in ") and line.endswith(" tok/s)\n")
    assert line == (f"generated (2, 3) in {seconds:.2f}s "
                    f"({2 * 3 / seconds:.1f} tok/s)\n")
    for got in (quiet, loud):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("vocab,seq,seed", [(512, 12, 3), (151936, 128, 3),
                                            (1000, 7, 0)])
def test_token_stream_matches_reference(vocab, seq, seed, step):
    got = TokenStream(vocab, seq, seed=seed).batch(step, 4)
    want = JaxTokenStream(vocab, seq, seed=seed).batch(step, 4)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
