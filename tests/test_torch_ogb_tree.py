"""The lazy bucketized OGB: repro_torch's policy_def("ogb_tree") against repro's.

Both replay the same trace from the same carry: the JAX package's initial
``OGBTreeCarry`` (its Poisson p from JAX's threefry stream) is carried
across with carry_from_numpy.  The port runs on the CPU here, through its
kernels' plain versions.  Tolerances:

* hits equal in at least 99.9% of chunks: Poisson hits flip only where
  f_i ~ p_i under another rounding of rho;
* total fractional reward within 1e-5 relative;
* per-chunk threshold step dtau within 1e-5 in at least 98% of chunks, and
  within 1e-4 in all.  The port's K-way solve evaluates the bucket mass by
  one float32 sum over the leaves; the reference's bisection by prefix-sum
  differences, which cancel.  Where the two differ by more than 1e-5 it is
  the reference that is off: test_solve_finds_the_float64_root holds the
  port's solve to the float64 root at the worst such chunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.cachesim import api as japi
from repro.cachesim import tree_engines as jtree
from repro.core.ogb import theoretical_eta as j_theoretical_eta
import repro_torch
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.cachesim.traces import zipf

V = ttree.OGB_TREE_BUCKETS


def _zipf_trace(rng, n, t, a=1.2):
    """The trace of tests/cachesim/test_tree_policies.py."""
    ranks = rng.zipf(a, size=t * 3) - 1
    ranks = ranks[ranks < n][:t]
    return rng.permutation(n)[ranks].astype(np.int64)


# (n, C, T, window, trace seed, zipf a, eta or None for Theorem 3.1, options)
CONFIGS = {
    # test_tree_policies.py:109, test_ogb_tree_tracks_dense_ogb
    "tracks_dense": (1500, 75, 40000, 200, 9, 1.2, None, {}),
    # test_tree_policies.py:127, test_ogb_tree_reanchor_path: rho stays below
    # its trigger there, so no re-anchor fires, but the host checks every chunk
    "reanchor_path": (800, 50, 30000, 100, 10, 1.3, 0.01, {"batch_hint": 1}),
    # the same, at etas where the trigger is met once, and in every chunk
    "reanchor_once": (800, 50, 30000, 100, 10, 1.3, 0.12, {"batch_hint": 1}),
    "reanchor_always": (800, 50, 30000, 100, 10, 1.3, 0.2, {"batch_hint": 1}),
}
REANCHORS = {"tracks_dense": 0, "reanchor_path": 0, "reanchor_once": 1, "reanchor_always": 300}


def _setup(name, sample="poisson"):
    n, c, t, w, seed, a, eta, opts = CONFIGS[name]
    trace = _zipf_trace(np.random.default_rng(seed), n, t, a)
    if eta is None:
        eta = j_theoretical_eta(c, n, t, 1)
    pd = japi.policy_def("ogb_tree", sample=sample, **opts)
    carry = pd.init(n, c, seed=3, eta=eta, horizon=t)
    leaves = {k: np.asarray(v) for k, v in carry._asdict().items()}
    return trace, pd, carry, leaves, (n, c, w, eta, opts)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    trace, pd, carry, leaves, (n, c, w, eta, opts) = _setup(request.param)
    want = japi.run(pd, trace, capacity=c, window=w, carry=carry)
    got = repro_torch.run(
        repro_torch.policy_def("ogb_tree", **opts), trace, capacity=c, window=w,
        carry=repro_torch.carry_from_numpy(leaves, "cpu"), device="cpu",
    )
    return request.param, want, got


def test_replay_matches_reference(pair):
    name, want, got = pair
    assert got.T == want.T
    assert np.mean(got.hits == want.hits) >= 0.999
    assert abs(got.reward.sum() - want.reward.sum()) <= 1e-5 * want.reward.sum()
    dtau = np.abs(got.aux - want.aux)
    assert np.mean(dtau <= 1e-5) >= 0.98 and dtau.max() <= 1e-4
    np.testing.assert_allclose(got.occupancy, want.occupancy, rtol=0, atol=1)
    assert got.extras["reanchors"] == REANCHORS[name]
    np.testing.assert_allclose(got.carry.y.numpy(), np.asarray(want.carry.y), rtol=0, atol=1e-4)
    assert abs(float(got.carry.rho) - float(want.carry.rho)) <= 1e-4
    for leaf in ("ycnt", "dcnt"):  # integer-valued count trees: exact
        same = np.mean(getattr(got.carry, leaf).numpy() == np.asarray(getattr(want.carry, leaf)))
        assert same >= 0.999, leaf


def test_host_reads_only_near_the_trigger(pair):
    name, _want, got = pair
    m = len(got.hits)
    syncs, reanchors = got.extras["host_syncs"], got.extras["reanchors"]
    assert reanchors <= syncs <= m
    if name == "tracks_dense":
        assert syncs == 0  # the grid's headroom is never approached
    if name == "reanchor_always":
        assert syncs == reanchors == m


def test_solve_finds_the_float64_root():
    """At the chunk where port and reference differ most in tracks_dense
    (chunk 99), both step from the reference's own carry: the port's
    K-way solve lands within 1e-6 of the float64 root of the bucket mass."""
    trace, pd, carry, _leaves, (n, c, w, eta, _opts) = _setup("tracks_dense")
    k = 99
    ref = japi.run(pd, trace[: k * w], capacity=c, window=w, carry=carry).carry
    leaves = {name: np.asarray(v) for name, v in ref._asdict().items()}
    port = repro_torch.carry_from_numpy(leaves, "cpu")
    chunk = ttree.make_ogb_tree_chunk(V, ttree.OGB_TREE_RADIX, "poisson")
    after, (_r, _h, dtau, _o) = chunk(port, torch.from_numpy(trace[k * w:(k + 1) * w]))
    cnt = after.ycnt[:V].double().numpy()
    tot = after.ysum[:V].double().numpy()
    mean = np.where(cnt > 0, tot / np.maximum(cnt, 1.0), 0.0)
    rho = float(leaves["rho"])
    lo, hi = rho, rho + max(np.float32(eta) * w, 4.0 * float(leaves["w"]))
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if (cnt * np.clip(mean - mid, 0, 1)).sum() >= c else (lo, mid)
    assert abs(float(dtau) - (lo - rho)) <= 1e-6


@pytest.mark.parametrize("sample", ["poisson", "none"])
def test_ogb_tree_tracks_dense_ogb(sample):
    """The reference's own bound between the lazy and the dense policy."""
    n, c, t, w, seed, a, _eta, _opts = CONFIGS["tracks_dense"]
    trace = _zipf_trace(np.random.default_rng(seed), n, t, a)
    dense = repro_torch.run(repro_torch.policy_def("ogb", sample=sample), trace, n, c,
                            window=w, seed=3, device="cpu")
    lazy = repro_torch.run(repro_torch.policy_def("ogb_tree", sample=sample), trace, n, c,
                           window=w, seed=3, device="cpu")
    assert float(lazy.reward.sum()) == pytest.approx(float(dense.reward.sum()), rel=1e-2)
    if sample == "poisson":
        assert abs(lazy.hit_ratio - dense.hit_ratio) <= 5e-3
        assert abs(np.mean(lazy.occupancy) - c) < 0.2 * c
    else:
        assert lazy.hits.sum() == 0
        np.testing.assert_array_equal(lazy.occupancy, c)


@pytest.mark.parametrize("name", ["tracks_dense", "reanchor_once"])
def test_two_chunked_runs_equal_one_run_bit_for_bit(name):
    n, c, t, w, seed, a, eta, opts = CONFIGS[name]
    trace = _zipf_trace(np.random.default_rng(seed), n, t, a)
    pd = repro_torch.policy_def("ogb_tree", **opts)
    kw = {} if eta is None else {"eta": eta}
    whole = repro_torch.run(pd, trace, n, c, window=w, device="cpu", **kw)
    cut = 110 * w
    first = repro_torch.run(pd, trace[:cut], n, c, window=w, horizon=t,
                            eta=whole.extras["eta"], device="cpu")
    first_y = first.carry.y.clone()
    second = repro_torch.run(pd, trace[cut:], capacity=c, window=w, carry=first.carry,
                             device="cpu")
    assert torch.equal(first.carry.y, first_y)  # the carry passed in is not modified
    for name_ in ("reward", "hits", "aux", "occupancy"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, name_), getattr(second, name_)]),
            getattr(whole, name_),
        )
    for x, y in zip(second.carry.tensors(), whole.carry.tensors()):
        assert torch.equal(x, y)
    assert first.extras["reanchors"] + second.extras["reanchors"] == whole.extras["reanchors"]


def test_init_matches_reference_leaf_for_leaf():
    n, c, eta = 1000, 50, 0.05
    want = jtree.init_ogb_tree_carry(n, c, eta=eta, seed=1, batch_hint=64)
    got = ttree.init_ogb_tree_carry(n, c, eta=eta, seed=1, batch_hint=64, device="cpu")
    for leaf in ("y", "rho", "eta", "cap", "w", "scratch", "ycnt", "ysum"):
        np.testing.assert_array_equal(getattr(got, leaf).numpy(), np.asarray(getattr(want, leaf)))
    # the d-tree counts y0 - p over the port's own p (a torch stream)
    assert float(got.dcnt[:V].sum()) == n and got.dcnt.shape == want.dcnt.shape
    assert got.host.rho_hi == 0.0 and got.host.w == float(got.w)


def test_ogb_tree_rejects_madow_and_bad_options():
    for sample in ("madow", "madow_tree"):
        with pytest.raises(ValueError, match="madow"):
            repro_torch.policy_def("ogb_tree", sample=sample)
    with pytest.raises(ValueError, match="radix"):
        repro_torch.run(repro_torch.policy_def("ogb_tree", radix=48), np.zeros(100, int),
                        10, 2, window=50, device="cpu")


def test_bucket_of_matches_reference():
    x = np.array([-1.0, -0.99, 0.0, 0.3, 1.0, 7.5, 1e6], np.float32)
    got = ttree._ogb_bucket(torch.from_numpy(x), torch.tensor(0.01), 512).numpy()
    want = np.asarray(jtree._ogb_bucket(jnp.asarray(x), jnp.float32(0.01), 512))
    np.testing.assert_array_equal(got, want)


def test_chip_smoke_holds_the_reference_fractional_hit_ratio():
    """chip_smoke.py holds the card's full-size ogb_tree replay to the JAX
    reference's fractional hit ratio (zipf(0.8), N = 1e6, T = 1e7,
    C = 50 000, window 1000, Theorem 3.1 eta); this is where its constant
    comes from.  The fractional dynamics do not read the Poisson p, so the
    port's own p does not move it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    trace = zipf(smoke.N, smoke.T, alpha=smoke.ALPHA, seed=0)
    res = japi.run(japi.policy_def("ogb_tree"), trace, smoke.N, smoke.C, window=smoke.W,
                   track_opt=False, keep_carry=False)
    assert res.extras["eta"] == j_theoretical_eta(smoke.C, smoke.N, smoke.T, 1)
    assert res.frac_hit_ratio == pytest.approx(smoke.REF_TREE_FRAC_HIT_RATIO, abs=5e-8)
