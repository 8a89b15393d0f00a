"""Deterministic synthetic data: copies of ``repro.data.synthetic``'s
``TokenStream`` and ``CifarLike``.

Every batch is a pure function of (seed, step), so the port and the JAX
package draw the same prompts and images from the same seed, and elastic
restarts resume the stream exactly.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Zipf-ish synthetic LM tokens with a learnable structure: token t+1 is
    a noisy function of token t, so models actually reduce loss."""

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


class CifarLike:
    """Synthetic CIFAR-10-like dataset: ``size`` images whose class signal
    is a fixed per-class template + noise (linearly separable-ish, so the
    ResNet's loss curve has the O(1/k) shape eq. (1) models)."""

    def __init__(self, size: int = 50_000, image: int = 32, classes: int = 10,
                 seed: int = 0):
        self.size = size
        self.image = image
        self.classes = classes
        rng = np.random.default_rng(seed)
        self.templates = rng.normal(size=(classes, image, image, 3)
                                    ).astype(np.float32)
        self.labels_all = rng.integers(0, classes, size).astype(np.int32)
        self.seed = seed

    def batch(self, step: int, batch_size: int) -> dict:
        idx = (np.arange(batch_size) + step * batch_size) % self.size
        labels = self.labels_all[idx]
        rng = np.random.default_rng((self.seed, step, 7))
        noise = rng.normal(scale=1.0, size=(batch_size, self.image,
                                            self.image, 3)).astype(np.float32)
        images = 0.6 * self.templates[labels] + noise
        return {"images": images, "labels": labels}

    def steps_per_epoch(self, batch_size: int) -> float:
        return self.size / batch_size
