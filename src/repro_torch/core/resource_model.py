"""Resource-to-speed model — paper §3.2, eq. (5).

    f(w) = (theta0 * m/w + theta1 * (w-1) + theta2 * (w-1) * n/w
            + theta3)^{-1}        [epochs/second]

theta >= 0 fitted by NNLS from observed (w, speed) points.  The same f
covers all three all-reduce algorithms (the thetas absorb the different
coefficients of eqs. 2-4).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.convergence import nnls


def _features(w: np.ndarray, m: float, n: float) -> np.ndarray:
    """Feature matrix [m/w, w-1, (w-1)n/w, 1] for a batch of worker counts.

    Written as four slice assignments into one preallocated array (rather
    than ``np.stack`` of four temporaries): this is the scheduler's hot
    constructor and the temporaries dominated the seed profile.
    """
    w = np.asarray(w, float)
    out = np.empty((w.shape[0], 4))
    out[:, 0] = m / w
    out[:, 1] = w - 1.0
    out[:, 2] = out[:, 1] * n / w
    out[:, 3] = 1.0
    return out


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    theta: np.ndarray          # [4], non-negative
    m: float                   # per-worker minibatch (paper keeps it fixed)
    n: float                   # model/gradient size

    def seconds_per_epoch(self, w) -> np.ndarray:
        w = np.asarray(w, float)
        return _features(w, self.m, self.n) @ self.theta

    def f(self, w) -> np.ndarray:
        """Training speed in epochs/second (eq. 5)."""
        t = self.seconds_per_epoch(w)
        return 1.0 / np.maximum(t, 1e-12)

    def f_pointwise(self, w) -> np.ndarray:
        """Batch f(w) that is bit-identical to per-scalar ``f`` calls.

        The one-shot matmul in ``f`` lets BLAS pick a different kernel for
        tall feature matrices, which perturbs the last ulp relative to the
        (1, 4) @ (4,) matvec the scalar path issues.  Speed *tables* must
        reproduce the scalar path exactly (the simulator promises
        bit-identical completion times), so this evaluates the batch with
        one vectorized ``_features`` call followed by per-row ``np.dot`` —
        the same BLAS trajectory as N scalar calls, minus the N array
        constructions that dominated the seed profile.
        """
        feats = _features(np.asarray(w, float), self.m, self.n)
        t = np.empty(feats.shape[0])
        theta = self.theta
        for i in range(feats.shape[0]):
            t[i] = np.dot(feats[i], theta)
        return 1.0 / np.maximum(t, 1e-12)


def fit_resource_model(ws: np.ndarray, speeds: np.ndarray, m: float,
                       n: float) -> ResourceModel:
    """speeds: measured epochs/second at worker counts ws."""
    ws = np.asarray(ws, float)
    speeds = np.asarray(speeds, float)
    y = 1.0 / np.maximum(speeds, 1e-12)        # seconds per epoch
    theta = nnls(_features(ws, m, n), y)
    return ResourceModel(theta=theta, m=m, n=n)


def profile_to_speeds(step_times: dict[int, float], steps_per_epoch_1w: float
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Convert per-step wall times at each w into epochs/sec observations.

    With per-GPU minibatch fixed (paper §5), w workers take
    steps_per_epoch_1w / w steps per epoch.
    """
    ws = np.array(sorted(step_times), float)
    secs_per_epoch = np.array(
        [step_times[int(w)] * steps_per_epoch_1w / w for w in ws])
    return ws, 1.0 / secs_per_epoch
