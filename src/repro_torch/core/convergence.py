"""Online convergence modelling — paper §3.1, eq. (1).

SGD converges at O(1/k), so loss is fitted as

    l = 1 / (beta0 * k + beta1) + beta2,   beta0 > 0

by NNLS: for a grid of beta2 candidates, 1/(l - beta2) = beta0*k + beta1 is
linear, solved with non-negative least squares (own Lawson–Hanson-style
projected solver; scipy.optimize.nnls is only used as a cross-check in
tests).  The fitted curve predicts the step/epoch at which the loss reaches
the convergence target, i.e. the remaining epochs Q_j the scheduler needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def nnls(A: np.ndarray, b: np.ndarray, iters: int = 3000,
         tol: float = 1e-12) -> np.ndarray:
    """Projected-gradient NNLS: min ||Ax - b||^2 s.t. x >= 0."""
    A = np.asarray(A, float)
    b = np.asarray(b, float)
    AtA = A.T @ A
    Atb = A.T @ b
    lip = np.linalg.norm(AtA, 2) + 1e-12
    x = np.maximum(0.0, np.linalg.lstsq(A, b, rcond=None)[0])
    step = 1.0 / lip
    for _ in range(iters):
        g = AtA @ x - Atb
        x_new = np.maximum(0.0, x - step * g)
        if np.max(np.abs(x_new - x)) < tol:
            x = x_new
            break
        x = x_new
    return x


@dataclasses.dataclass(frozen=True)
class ConvergenceModel:
    beta0: float
    beta1: float
    beta2: float

    def loss_at(self, k):
        k = np.asarray(k, float)
        return 1.0 / (self.beta0 * k + self.beta1) + self.beta2

    def steps_to_loss(self, target: float) -> float:
        """Smallest k with predicted loss <= target (inf if unreachable)."""
        if target <= self.beta2 or self.beta0 <= 0:
            return np.inf
        return max(0.0, (1.0 / (target - self.beta2) - self.beta1)
                   / self.beta0)


def fit_convergence(steps: np.ndarray, losses: np.ndarray,
                    n_beta2: int = 64) -> ConvergenceModel:
    """Fit eq. (1) by NNLS over a beta2 grid (the transform trick)."""
    steps = np.asarray(steps, float)
    losses = np.asarray(losses, float)
    assert steps.shape == losses.shape and steps.size >= 3
    lmin = float(losses.min())
    best, best_err = None, np.inf
    for beta2 in np.linspace(0.0, max(0.0, lmin - 1e-3), n_beta2):
        y = 1.0 / np.maximum(losses - beta2, 1e-9)
        A = np.stack([steps, np.ones_like(steps)], axis=1)
        coef = nnls(A, y)
        model = ConvergenceModel(float(coef[0]), float(coef[1]), float(beta2))
        err = float(np.mean((model.loss_at(steps) - losses) ** 2))
        if err < best_err and coef[0] > 0:
            best, best_err = model, err
    if best is None:  # degenerate (flat loss): fall back to tiny slope
        best = ConvergenceModel(1e-9, 1.0 / max(losses.mean(), 1e-9), 0.0)
    return best
