"""The port's kernel modules against the JAX package's, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version, so
these tests hold that arithmetic against the Pallas kernels (in interpret
mode, as the JAX package's own tests run them) and against float64 numpy.
The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.projection import project_capped_simplex
from repro.kernels.capped_simplex.kernel import LANES, _grid_apply, _grid_masses
from repro.kernels.capped_simplex.ops import fused_ogb_update as jax_fused_ogb_update
from repro.kernels.capped_simplex.ref import fused_ogb_update_ref
from repro.kernels.scatter_counts.ops import scatter_counts
from repro.kernels.scatter_counts.ref import scatter_counts_ref
from repro_torch.kernels.capped_simplex.ops import apply, fused_ogb_update, masses
from repro_torch.kernels.scatter_counts.ops import histogram

BLOCK_ROWS = 8  # Pallas block of 8 x 128 catalog slots


def _catalog(n, b, seed, eta=0.01):
    """A feasible f (float32), the counts of b zipf-ish ids, C and eta."""
    rng = np.random.default_rng(seed)
    c = max(1, n // 10)
    f = project_capped_simplex(rng.random(n) * (2 * c / n), c).astype(np.float32)
    ids = np.minimum(rng.zipf(1.3, size=b) - 1, n - 1)
    counts = np.bincount(ids, minlength=n).astype(np.float32)
    return f, counts, c, np.float32(eta)


def _padded(x):
    pad = (-x.shape[0]) % (BLOCK_ROWS * LANES)
    return jnp.asarray(np.pad(x, (0, pad)).reshape(-1, LANES))


def _taus(k, eta, b, seed):
    rng = np.random.default_rng(seed + 100)
    return np.sort(rng.random(k).astype(np.float32) * np.float32(eta * b))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,b", [(1000, 300), (4096, 1000), (5000, 17)])
def test_histogram_matches_pallas_and_ref(n, b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, n + 50, size=b).astype(np.int32)  # pads and ids >= N
    ids[: b // 3] = ids[b // 3 : 2 * (b // 3)]  # duplicates
    got = histogram(torch.from_numpy(ids), n).numpy()
    pallas = np.asarray(scatter_counts(jnp.asarray(ids), n, interpret=True))
    ref = np.asarray(scatter_counts_ref(jnp.asarray(ids), n))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == np.count_nonzero((ids >= 0) & (ids < n))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [8, 64])
def test_masses_match_pallas_at_multiples_of_8(k, seed):
    n, b = 3000, 500
    f, counts, _c, eta = _catalog(n, b, seed)
    taus = _taus(k, eta, b, seed)
    mass, cnt = masses(
        torch.from_numpy(f), torch.from_numpy(counts), float(eta), torch.from_numpy(taus)
    )
    pm, pc = _grid_masses(
        _padded(f), _padded(counts), jnp.asarray(taus), float(eta), BLOCK_ROWS, True
    )
    # counts are integers: exact; masses differ by float32 summation order
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc))
    np.testing.assert_allclose(mass.numpy(), np.asarray(pm), rtol=0, atol=1e-6 * n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 12])
def test_masses_match_float64_at_any_k(k, seed):
    # the Pallas kernel does not trace at K=1 and zeroes the last K mod 8
    # results, so these K are held against numpy only
    n, b = 3000, 500
    f, counts, _c, eta = _catalog(n, b, seed)
    taus = _taus(k, eta, b, seed)
    mass, cnt = masses(
        torch.from_numpy(f), torch.from_numpy(counts), torch.tensor(eta),
        torch.from_numpy(taus),
    )
    z = (f + eta * counts)[None, :] - taus[:, None]  # float32, as the kernels round
    want_mass = np.clip(z.astype(np.float64), 0.0, 1.0).sum(axis=1)
    want_cnt = ((z > 0) & (z < 1)).sum(axis=1)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt.astype(np.float32))
    np.testing.assert_allclose(mass.numpy(), want_mass, rtol=0, atol=1e-6 * n)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1000, 4096])
def test_apply_matches_pallas(n, seed):
    f, counts, _c, eta = _catalog(n, 4000, seed)
    tau = np.float32(0.3 * eta)
    got = apply(torch.from_numpy(f), torch.from_numpy(counts), float(eta), float(tau))
    pallas = _grid_apply(
        _padded(f), _padded(counts), jnp.asarray(tau), float(eta), BLOCK_ROWS, True
    )
    got, pallas = got.numpy(), np.asarray(pallas).reshape(-1)[:n]
    # The port rounds eta * c and then the sum, as its CUDA kernel does; XLA
    # on the CPU fuses the Pallas kernel's f + eta * c into one multiply-add.
    # Where eta * c is exact in float32 the two agree bit for bit, elsewhere
    # within one ulp of y.
    exact = np.float64(eta) * counts == (eta * counts).astype(np.float64)
    assert exact.sum() > n // 2
    np.testing.assert_array_equal(got[exact], pallas[exact])
    y = f + eta * counts
    assert np.all(np.abs(got - pallas) <= np.spacing(y))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,passes,k", [(5000, 3, 64), (20000, 2, 64), (3000, 4, 16)])
def test_fused_ogb_update_matches_reference(n, passes, k, seed):
    f, counts, c, eta = _catalog(n, 512, seed, eta=0.02)
    got = fused_ogb_update(
        torch.from_numpy(f), torch.from_numpy(counts), float(eta), float(c), passes, k
    ).numpy()
    pallas = jax_fused_ogb_update(
        jnp.asarray(f), jnp.asarray(counts), float(eta), float(c), passes=passes, k=k,
        block_rows=BLOCK_ROWS, interpret=True,
    )
    ref = fused_ogb_update_ref(jnp.asarray(f), jnp.asarray(counts), float(eta), float(c))
    # same bracketing as the Pallas driver; only the mass summation order differs
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)
    # the 64-step bisection reference, at the JAX package's own tolerance
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-4)
    assert abs(float(got.sum(dtype=np.float64)) - c) < 1e-3 * c


def test_fused_ogb_update_warm_bracket_returns_tau():
    n = 4000
    f, counts, c, eta = _catalog(n, 512, 5, eta=0.02)
    got, tau = fused_ogb_update(
        torch.from_numpy(f), torch.from_numpy(counts), float(eta), float(c), passes=2,
        tau0=0.0, return_tau=True,
    )
    want, want_tau = jax_fused_ogb_update(
        jnp.asarray(f), jnp.asarray(counts), float(eta), float(c), passes=2,
        block_rows=BLOCK_ROWS, interpret=True, tau0=jnp.float32(0.0), return_tau=True,
    )
    assert abs(float(tau) - float(want_tau)) <= 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["histogram", "masses", "apply"])
def test_wrappers_refuse_devices_they_have_no_kernel_for(kernel):
    f = torch.zeros(16, device="meta")
    calls = {
        "histogram": lambda: histogram(torch.zeros(4, dtype=torch.int32, device="meta"), 16),
        "masses": lambda: masses(f, f, torch.zeros((), device="meta"), torch.zeros(1, device="meta")),
        "apply": lambda: apply(f, f, torch.zeros((), device="meta"), torch.zeros((), device="meta")),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel]()
