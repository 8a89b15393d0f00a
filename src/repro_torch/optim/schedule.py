"""Learning-rate schedules + the paper's elastic rescale rule (a copy of
``repro.optim.schedule``, which is pure Python: ``repro.optim`` loads jax,
so the port keeps its own).

Eq. (7):  lr_new = (#GPUs_new / #GPUs_last) * lr_last  — linear scaling on
resize (Goyal et al.).  ``step_decay`` is the paper's ResNet schedule
(divide by 10 at epochs 100 and 150); decay *epoch* boundaries are held
fixed, so the step boundaries shift with global batch size exactly as §5
describes.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def rescale_lr(lr_last: float, gpus_new: int, gpus_last: int) -> float:
    """Paper eq. (7)."""
    return lr_last * (gpus_new / gpus_last)


def step_decay(base_lr: float, steps_per_epoch: float,
               boundaries_epochs=(100, 150), factor: float = 0.1) -> Schedule:
    def lr(step: int) -> float:
        epoch = step / max(steps_per_epoch, 1e-9)
        out = base_lr
        for b in boundaries_epochs:
            if epoch >= b:
                out *= factor
        return out
    return lr


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Schedule:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1) / warmup
        t = min(1.0, (step - warmup) / max(1, total - warmup))
        return base_lr * (min_frac + (1 - min_frac)
                          * 0.5 * (1 + math.cos(math.pi * t)))
    return lr
