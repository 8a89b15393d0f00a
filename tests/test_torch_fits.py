"""The port's eq. 1 and eq. 5 fits are the reference's, on the CPU.

``nnls``, ``fit_convergence`` (with ``loss_at`` and ``steps_to_loss``),
``fit_resource_model`` (``f``, ``f_pointwise``, ``seconds_per_epoch``)
and ``profile_to_speeds`` on the same numpy-seeded inputs, compared
exactly (``np.array_equal``, ``float.hex``): the copies run the same
numpy operations. The cases include the curve on which the reference's
own ``test_fit_recovers_synthetic_curve`` fails (b0 = 0.00390625,
b1 = 0.25, b2 = 0.5): the port must give the same fit, so that fault is
the reference's, carried over, and not a difference between the two.
"""
import pytest

pytest.importorskip("torch")  # the CI lane without torch skips the port

import numpy as np

from repro.core import convergence as jconv
from repro.core import jobs as jjobs
from repro.core import resource_model as jrm
from repro_torch.core import convergence as tconv
from repro_torch.core import jobs as tjobs
from repro_torch.core import resource_model as trm

# (b0, b1, b2) of eq. 1; the first is the reference's failing example
CURVES = [(0.00390625, 0.25, 0.5), (1e-3, 1.0, 0.1), (2e-3, 0.5, 0.3),
          (1e-4, 2.0, 0.0), (1e-2, 0.1, 0.45)]


def hexes(a) -> list[str]:
    return [float(x).hex() for x in np.ravel(a)]


@pytest.mark.parametrize("seed", range(10))
def test_nnls_equals_reference(seed):
    rng = np.random.default_rng([seed, 1])
    rows, cols = int(rng.integers(3, 40)), int(rng.integers(1, 6))
    A = rng.normal(size=(rows, cols))
    b = rng.normal(size=rows)
    got, want = tconv.nnls(A, b), jconv.nnls(A, b)
    assert hexes(got) == hexes(want)
    assert np.all(got >= 0.0)


@pytest.mark.parametrize("noise", [0.0, 0.03])
@pytest.mark.parametrize("curve", CURVES)
def test_fit_convergence_equals_reference(curve, noise):
    k = np.linspace(1, 2000, 60)
    l = jconv.ConvergenceModel(*curve).loss_at(k)
    if noise:
        l = l * (1 + np.random.default_rng(0).normal(scale=noise, size=k.size))
    got, want = tconv.fit_convergence(k, l), jconv.fit_convergence(k, l)
    assert hexes([got.beta0, got.beta1, got.beta2]) == hexes(
        [want.beta0, want.beta1, want.beta2])
    assert hexes(got.loss_at(k)) == hexes(want.loss_at(k))
    for target in (curve[2] + 0.05, curve[2] + 0.5, curve[2] - 0.01):
        assert float(got.steps_to_loss(target)).hex() == float(
            want.steps_to_loss(target)).hex()


def test_the_references_failing_curve_fails_in_both():
    """The reference's test tolerance (rtol 0.08, atol 0.02) is missed by
    the same fit in both packages."""
    k = np.linspace(1, 2000, 60)
    l = jconv.ConvergenceModel(*CURVES[0]).loss_at(k)
    for conv in (jconv, tconv):
        fit = conv.fit_convergence(k, l)
        assert not np.allclose(fit.loss_at(k), l, rtol=0.08, atol=0.02)


def test_fit_convergence_degenerate_curve_equals_reference():
    k = np.arange(5, dtype=float)
    flat = np.full(5, 2.0)
    got, want = tconv.fit_convergence(k, flat), jconv.fit_convergence(k, flat)
    assert (got.beta0, got.beta1, got.beta2) == (want.beta0, want.beta1, want.beta2)


@pytest.mark.parametrize("seed", range(8))
def test_resource_model_equals_reference(seed):
    rng = np.random.default_rng([seed, 5])
    ws = np.array([1, 2, 4, 8] + ([3, 6] if seed % 2 else []), float)
    step = {int(w): float(rng.uniform(0.03, 0.5)) + 1e-3 * w for w in ws}
    spe = float(rng.uniform(100, 500))
    m, n = float(rng.choice([32, 128])), float(rng.choice([6.9e6, 4 * 1_727_962, 3.1e9]))
    (tw, ts), (jw, js) = trm.profile_to_speeds(step, spe), jrm.profile_to_speeds(step, spe)
    assert hexes(tw) == hexes(jw) and hexes(ts) == hexes(js)
    got, want = trm.fit_resource_model(tw, ts, m=m, n=n), jrm.fit_resource_model(
        jw, js, m=m, n=n)
    assert hexes(got.theta) == hexes(want.theta) and (got.m, got.n) == (want.m, want.n)
    grid = np.arange(1, 65, dtype=float)
    for fn in ("f", "f_pointwise", "seconds_per_epoch"):
        assert hexes(getattr(got, fn)(grid)) == hexes(getattr(want, fn)(grid)), fn


def test_table2_model_equals_reference():
    """The paper's Table 2 calibration that the §7 simulation runs on."""
    got, want = tjobs._table2_model(), jjobs._table2_model()
    assert hexes(got.theta) == hexes(want.theta)
    assert tjobs.TABLE2_RUNS == jjobs.TABLE2_RUNS
