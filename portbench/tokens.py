"""Frozen copy of the port's ``TokenStream``
(``src/repro_torch/data/synthetic.py`` as of the port's first benchmark,
itself a copy of ``repro.data.synthetic.TokenStream``), so that a later
change to the program's data generator cannot move the benchmark's inputs.

Every batch is a pure function of (seed, step); ``seed`` may be any
non-negative integer, however large.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Zipf-ish synthetic LM tokens with a learnable structure: token t+1 is
    a noisy function of token t."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 noise: float = 0.1):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size)  # hidden transition table

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch_size, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        flip = rng.random((batch_size, self.seq)) < self.noise
        rand = rng.integers(0, self.vocab, (batch_size, self.seq))
        for t in range(self.seq):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
