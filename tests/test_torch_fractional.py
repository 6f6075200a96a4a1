"""The port's projections against repro.jaxcache.fractional and the float64 oracle.

Both sides project the same y = f + eta * counts (float32, made with numpy
from a seed): the JAX functions take y, the port takes (f, counts, eta) as
its kernels do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.projection import capped_simplex_tau, project_capped_simplex
from repro.jaxcache import fractional as jfr
from repro_torch.jaxcache import fractional as tfr


def _step(n, b, seed, eta):
    """Feasible f, the counts of b uniform ids, C, eta, and y in float32."""
    rng = np.random.default_rng(seed)
    c = max(2, n // 20)
    f = project_capped_simplex(rng.random(n) * (2 * c / n), c).astype(np.float32)
    counts = np.bincount(rng.integers(0, n, size=b), minlength=n).astype(np.float32)
    eta = np.float32(eta)
    return f, counts, c, eta, f + eta * counts


def _t(x):
    return torch.from_numpy(np.asarray(x))


CASES = [(500, 50, 0.05), (2000, 100, 0.01), (4000, 1000, 0.002), (3000, 200, 0.2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,b,eta", CASES)
def test_cold_bisection_matches_reference(n, b, eta, seed):
    f, counts, c, eta, y = _step(n, b, seed, eta)
    got_f, got_tau = tfr.capped_simplex_project(_t(f), _t(counts), float(eta), float(c))
    want_f, want_tau = jfr.capped_simplex_project(jnp.asarray(y), float(c))
    assert abs(float(got_tau) - float(want_tau)) <= 1e-6
    assert abs(float(got_tau) - capped_simplex_tau(y, c)) <= 1e-6
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    assert abs(float(got_f.double().sum()) - c) <= 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,b,eta", CASES)
def test_warm_newton_matches_reference(n, b, eta, seed):
    f, counts, c, eta, y = _step(n, b, seed, eta)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(b)))
    # the previous step's tau, a little off this step's root, as in a replay
    tau0 = 1.2 * capped_simplex_tau(y, c)
    got_f, got_tau = tfr.capped_simplex_project_warm(
        _t(f), _t(counts), float(eta), float(c), 0.0, hi, tau0
    )
    want_f, want_tau = jfr.capped_simplex_project_warm(
        jnp.asarray(y), float(c), 0.0, hi, tau0
    )
    assert abs(float(got_tau) - float(want_tau)) <= 1e-6
    assert abs(float(got_tau) - capped_simplex_tau(y, c)) <= 1e-6
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    # feasible: in the box and on the simplex
    assert float(got_f.min()) >= 0.0 and float(got_f.max()) <= 1.0
    assert abs(float(got_f.double().sum()) - c) <= 1e-3


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0])
def test_one_warm_sweep_matches_reference_sweep(frac):
    # one sweep is one mass pass at K=1 plus the safeguarded Newton update
    f, counts, c, eta, y = _step(3000, 300, 4, 0.05)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(300)))
    _, got = tfr.capped_simplex_project_warm(
        _t(f), _t(counts), float(eta), float(c), 0.0, hi, frac * hi, sweeps=1
    )
    _, want = jfr.capped_simplex_project_warm(
        jnp.asarray(y), float(c), 0.0, hi, frac * hi, sweeps=1
    )
    assert abs(float(got) - float(want)) <= 1e-6


def test_warm_shares_the_reference_safeguard_on_its_cycling_instance():
    # The instance pinned in .hypothesis: the Newton point alternates
    # between the bracket ends and the reference stops at tau=0, which is
    # infeasible.  The port keeps the reference's safeguard, so it stops at
    # the same point; cold bisection finds the float64 oracle's tau.
    y = np.array([1.0, 0.5, 1.5, 0.0], np.float32)
    zeros = np.zeros(4, np.float32)
    _, got = tfr.capped_simplex_project_warm(_t(y), _t(zeros), 0.5, 2.0, 0.0, 1.0, 0.5, 25)
    _, want = jfr.capped_simplex_project_warm(jnp.asarray(y), 2.0, 0.0, 1.0, 0.5, 25)
    assert float(got) == float(want)
    _, cold = tfr.capped_simplex_project(_t(y), _t(zeros), 0.5, 2.0)
    assert abs(float(cold) - capped_simplex_tau(y, 2.0)) <= 1e-6


def test_request_counts_and_poisson_sample():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 300, size=700).astype(np.int32)
    np.testing.assert_array_equal(
        tfr.request_counts(_t(ids), 300).numpy(),
        np.asarray(jfr.request_counts(jnp.asarray(ids), 300)),
    )
    f = rng.random(300).astype(np.float32)
    p = rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(
        tfr.poisson_sample(_t(f), _t(p)).numpy(),
        np.asarray(jfr.poisson_sample(jnp.asarray(f), jnp.asarray(p), 30)),
    )


def test_permanent_random_numbers_are_uniform_and_seeded():
    p = tfr.permanent_random_numbers(7, 200_000, torch.device("cpu"))
    assert p.dtype == torch.float32 and p.shape == (200_000,)
    assert float(p.min()) >= 0.0 and float(p.max()) < 1.0
    assert abs(float(p.double().mean()) - 0.5) < 0.005
    assert torch.equal(p, tfr.permanent_random_numbers(7, 200_000, torch.device("cpu")))
    assert not torch.equal(p, tfr.permanent_random_numbers(8, 200_000, torch.device("cpu")))
