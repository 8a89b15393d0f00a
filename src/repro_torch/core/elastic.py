"""Elastic checkpoint–stop–restart trainer (paper §5–6; torch twin of
``repro.core.elastic``).

Drives any model exposing ``loss(params, batch)`` through training segments
at varying worker counts w.  Per-worker minibatch m stays fixed (global
batch = m*w, §5), the LR rescales linearly on resize (eq. 7), and LR decay
boundaries stay pinned to *epochs* so they shift in step-space with the
batch size, exactly as the paper describes.  Stop and restart costs are
measured, not assumed.

As in the reference, the w workers are one process: a segment at w trains
on a global batch of m*w on one device, with no collective. Training with
w processes that exchange gradients through the paper's all-reduce is
``launch.explicit_allreduce``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.engine.steps import make_train_step, resolve_device
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.schedule import rescale_lr


@dataclasses.dataclass
class SegmentRecord:
    w: int
    steps: int
    epochs: float
    losses: list           # (global_step, cumulative_epoch, loss)
    seconds: float
    restore_seconds: float
    save_seconds: float


class ElasticTrainer:
    def __init__(self, model, optimizer: Optimizer, data,
                 ckpt: CheckpointStore, *, base_lr_1w: float,
                 m_per_worker: int = 128,
                 decay_epochs: tuple = (100, 150), decay_factor: float = 0.1,
                 dataset_size: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.opt = optimizer
        self.data = data
        self.ckpt = ckpt
        self.base_lr_1w = base_lr_1w
        self.m = m_per_worker
        self.decay_epochs = decay_epochs
        self.decay_factor = decay_factor
        self.dataset = dataset_size or getattr(data, "size", 50_000)
        self._step = make_train_step(model, optimizer, device=self.device)

    # ------------------------------------------------------------ state ----
    def fresh_state(self, generator: torch.Generator | None = None) -> dict:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.model.init(generator, self.device)
        return {"params": params, "opt": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32),
                "epoch": torch.zeros((), dtype=torch.float32)}

    def _lr(self, w: int, epoch: float) -> float:
        # linear scaling (eq. 7 relative to the 1-worker base) + epoch-pinned
        # step decay
        lr = rescale_lr(self.base_lr_1w, w, 1)
        for b in self.decay_epochs:
            if epoch >= b:
                lr *= self.decay_factor
        return lr

    # ---------------------------------------------------------- segments ---
    def train_segment(self, w: int, n_steps: int, *, resume: bool = True,
                      log_every: int = 10) -> SegmentRecord:
        restore_s = 0.0
        if resume and self.ckpt.latest_step() is not None:
            template = self.fresh_state()
            state, meta, restore_s = self.ckpt.restore(template)
        else:
            state = self.fresh_state()

        global_batch = self.m * w
        epochs_per_step = global_batch / self.dataset
        losses = []
        t0 = time.perf_counter()
        step0 = int(state["step"])
        epoch = float(state["epoch"])
        train_state = {"params": state["params"], "opt": state["opt"]}
        for i in range(n_steps):
            gstep = step0 + i
            batch = self.data.batch(gstep, global_batch)
            lr = self._lr(w, epoch)
            train_state, loss = self._step(train_state, batch, lr)
            epoch += epochs_per_step
            if i % log_every == 0 or i == n_steps - 1:
                losses.append((gstep, epoch, float(loss)))
        seconds = time.perf_counter() - t0

        state = {**train_state,
                 "step": torch.tensor(step0 + n_steps, dtype=torch.int32),
                 "epoch": torch.tensor(epoch, dtype=torch.float32)}
        save_s = self.ckpt.save(step0 + n_steps, state,
                                meta={"w": w, "epoch": epoch})
        return SegmentRecord(w=w, steps=n_steps, epochs=epoch,
                             losses=losses, seconds=seconds,
                             restore_seconds=restore_s, save_seconds=save_s)
