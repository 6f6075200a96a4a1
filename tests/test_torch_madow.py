"""Madow sampling (``madow`` and ``madow_tree``) in the port against repro's.

The port's per-chunk offsets come from its own counter-mode hash
(``api._chunk_u``); JAX's threefry offsets cannot be reproduced, so these
tests drive the port's raw OGB step with the reference's own ``u`` for
every chunk, from the reference's initial carry.  Tolerances: occupancy is
exactly C in every chunk (a systematic sample holds C items); hit ratio
within 2e-3 of the reference's, the reference's own bound between its two
Madow modes (test_tree_policies.py::test_madow_tree_sampling_matches_dense_madow),
since a float32 cumsum or tree sum in another order moves a threshold
across an item boundary now and then.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.cachesim import api as japi
from repro.jaxcache.fractional import madow_sample_jax
from repro.kernels.prefix_tree import ref as jref
import repro_torch
from repro_torch.cachesim.api import _chunk_u
from repro_torch.cachesim.replay import _make_ogb_step
from repro_torch.cachesim.traces import zipf
from repro_torch.core.ogb import theoretical_eta
from repro_torch.jaxcache.fractional import madow_sample

N, C, T, W = 1000, 60, 20_000, 200


@pytest.fixture(scope="module")
def trace():
    return zipf(N, T, alpha=0.9, seed=11)


@pytest.mark.parametrize("sample", ["madow", "madow_tree"])
def test_raw_step_with_reference_offsets_matches_reference(trace, sample):
    eta = theoretical_eta(C, N, T, 1)
    pd = japi.policy_def("ogb", sample=sample, madow_capacity=C)
    carry = pd.init(N, C, seed=2, eta=eta, horizon=T)
    m = T // W
    us = np.array([float(japi._chunk_u(sample, carry.u_key, jnp.int32(t))) for t in range(m)],
                  np.float32)
    want = japi.run(pd, trace, capacity=C, window=W, carry=carry)

    raw = _make_ogb_step(sample, "warm", 5, 50, madow_capacity=C)
    f = torch.full((N,), C / N, dtype=torch.float32)
    tau = torch.zeros(())
    eta_t, cap = torch.tensor(eta, dtype=torch.float32), torch.tensor(float(C))
    p = torch.zeros(0)
    hits, occ = [], []
    for t in range(m):
        ids = torch.from_numpy(trace[t * W:(t + 1) * W].astype(np.int32))
        f, tau, (_r, h, _tau, o) = raw(eta_t, p, cap, f, tau, ids, torch.tensor(us[t]))
        hits.append(int(h))
        occ.append(float(o))
    np.testing.assert_array_equal(occ, C)
    np.testing.assert_array_equal(want.occupancy, C)
    assert abs(sum(hits) / (m * W) - want.hit_ratio) <= 2e-3


def _dyadic_f(n, cap, seed):
    """A feasible f on a grid of 2^-10 that sums to C exactly, with some
    items at the cap: every prefix sum is exact in float32."""
    rng = np.random.default_rng(seed)
    units = rng.integers(0, 2 * cap * 1024 // n, size=n)
    units[: max(1, n // 50)] = 1024  # items at the cap take exactly one threshold
    while units.sum() != cap * 1024:
        step = 1 if units.sum() < cap * 1024 else -1
        room = np.flatnonzero((units + step >= 0) & (units + step <= 1024))
        pick = rng.choice(room, size=min(len(room), abs(int(units.sum()) - cap * 1024)),
                          replace=False)
        units[pick] += step
    return (units / 1024).astype(np.float32)


@pytest.mark.parametrize("n,cap,seed", [(100, 10, 0), (1000, 60, 1), (5000, 400, 2)])
def test_madow_sample_matches_reference_on_exact_sums(n, cap, seed):
    f = _dyadic_f(n, cap, seed)
    assert f.sum(dtype=np.float64) == cap
    u_off_grid = float(np.float32(np.random.default_rng(seed).random()))
    for u in (0.0, 0.25, u_off_grid):  # thresholds on item boundaries, and not
        got = madow_sample(torch.from_numpy(f), torch.tensor(u, dtype=torch.float32), cap).numpy()
        want = np.asarray(madow_sample_jax(jnp.asarray(f), jnp.float32(u), cap))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == cap
    # the float64 oracle breaks ties on a boundary the other way: compare off it
    np.testing.assert_array_equal(np.flatnonzero(got), jref.madow_sample_ref(f, u_off_grid, cap))


def test_chunk_u_is_counter_mode_and_uniform():
    key = torch.tensor(12345, dtype=torch.int64)
    us = torch.stack([_chunk_u(key, torch.tensor(t, dtype=torch.int32)) for t in range(4000)])
    again = _chunk_u(key, torch.tensor(1234, dtype=torch.int32))
    assert float(again) == float(us[1234])
    assert float(us.min()) >= 0.0 and float(us.max()) < 1.0
    assert abs(float(us.mean()) - 0.5) < 0.02 and len(set(us.tolist())) > 3990
    other = _chunk_u(torch.tensor(12346, dtype=torch.int64), torch.tensor(0, dtype=torch.int32))
    assert float(other) != float(us[0])


def _splitmix_u(seed, t):
    mask = (1 << 64) - 1
    z = (seed + (t + 1) * 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return ((z ^ (z >> 31)) >> 40) / 2**24


@pytest.mark.parametrize("seed", [0, 7, -3, 2**62 + 5])
def test_chunk_u_is_splitmix64(seed):
    for t in (0, 1, 99, 2**31 - 1):
        got = float(_chunk_u(torch.tensor(seed, dtype=torch.int64),
                             torch.tensor(t, dtype=torch.int32)))
        assert got == _splitmix_u(seed % 2**64, t)


@pytest.mark.parametrize("sample", ["madow", "madow_tree"])
def test_run_holds_capacity_and_resumes_bit_for_bit(trace, sample):
    pd = repro_torch.policy_def("ogb", sample=sample, madow_capacity=C)
    whole = repro_torch.run(pd, trace, N, C, window=W, seed=4, device="cpu")
    np.testing.assert_array_equal(whole.occupancy, C)
    assert 0.0 < whole.hit_ratio < 1.0
    cut = 40 * W
    first = repro_torch.run(pd, trace[:cut], N, C, window=W, seed=4, horizon=T,
                            eta=whole.extras["eta"], device="cpu")
    second = repro_torch.run(pd, trace[cut:], capacity=C, window=W, carry=first.carry,
                             device="cpu")
    np.testing.assert_array_equal(np.concatenate([first.hits, second.hits]), whole.hits)
    for a, b in zip(second.carry, whole.carry):
        assert torch.equal(a, b)


def test_madow_modes_agree_and_need_the_capacity(trace):
    runs = {
        s: repro_torch.run(repro_torch.policy_def("ogb", sample=s, madow_capacity=C), trace, N,
                           C, window=W, seed=2, device="cpu")
        for s in ("madow", "madow_tree")
    }
    assert abs(runs["madow"].hit_ratio - runs["madow_tree"].hit_ratio) <= 2e-3
    np.testing.assert_array_equal(runs["madow"].reward, runs["madow_tree"].reward)
    with pytest.raises(ValueError, match="static capacity"):
        repro_torch.policy_def("ogb", sample="madow")
    with pytest.raises(ValueError, match="static capacity"):
        repro_torch.run(repro_torch.policy_def("ogb", sample="madow", madow_capacity=C + 1),
                        trace, N, C, window=W, device="cpu")


def test_carry_from_numpy_packs_the_reference_key():
    carry = japi.policy_def("ogb", sample="madow", madow_capacity=C).init(N, C, seed=5, eta=0.1)
    leaves = {k: np.asarray(v) for k, v in carry._asdict().items()}
    port = repro_torch.carry_from_numpy(leaves, "cpu")
    words = leaves["u_key"].astype(np.uint64)
    packed = int((words[0] << np.uint64(32)) | words[1])
    assert int(port.u_key) % 2**64 == packed
    assert jax.random.key_data(jax.random.key(5)).shape == (2,)
