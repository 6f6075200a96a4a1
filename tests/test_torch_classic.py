"""The classic host baselines and the fractional data-plane step, against
the reference.

``repro_torch.core.projection`` (the float64 oracle), ``core.ogb_classic``
(``OGBClassic``, ``madow_sample``), ``core.omd`` (``OMDClassic``,
``project_capped_simplex_kl``), ``cachesim.simulator.compare`` and the
``ogb_cl`` / ``omd_cl`` registry entries are copies of ``repro``'s: on the
same numpy inputs and seeds they give the same numbers.  Footnote 3 of the
paper: the port's lazy ``OGB`` at B = 1 keeps the fractional state of its
eager ``OGBClassic``.  ``jaxcache.fractional``'s ``ogb_batch_update(_warm)``
and ``fractional_hit_ratio`` agree with ``repro``'s within the fractional
tests' tolerances (tau 1e-6, f 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.cachesim.simulator import compare as jax_compare
from repro.core import ogb_classic as j_classic
from repro.core import omd as j_omd
from repro.core import projection as j_proj
from repro.core.policies import make_policy as jax_make_policy
from repro.jaxcache import fractional as jfr
from repro_torch.cachesim.simulator import compare
from repro_torch.cachesim.traces import zipf
from repro_torch.core import ogb_classic, omd, projection
from repro_torch.core.ogb import OGB
from repro_torch.core.policies import POLICY_REGISTRY, make_policy
from repro_torch.jaxcache import fractional as tfr

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,c,seed", [(10, 3, 0), (200, 50, 1), (1000, 999, 2), (64, 1, 3)])
def test_projection_oracle_equals_the_reference(n, c, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(0.4, 0.7, size=n)
    y[: n // 5] += 2.0  # saturated coordinates
    assert projection.capped_simplex_tau(y, c) == j_proj.capped_simplex_tau(y, c)
    np.testing.assert_array_equal(projection.project_capped_simplex(y, c),
                                  j_proj.project_capped_simplex(y, c))
    assert projection.capped_simplex_tau_bisect(y, c, 60) == \
        j_proj.capped_simplex_tau_bisect(y, c, 60)
    with pytest.raises(ValueError, match="0 < C <= N"):
        projection.capped_simplex_tau(y, n + 1)


@pytest.mark.parametrize("c,seed", [(5, 0), (40, 1)])
def test_madow_sample_equals_the_reference(c, seed):
    rng = np.random.default_rng(seed)
    f = np.clip(rng.random(300) * (2 * c / 300), 0.0, 1.0)
    f *= c / f.sum()
    got = ogb_classic.madow_sample(f, c, np.random.default_rng(seed + 10))
    want = j_classic.madow_sample(f, c, np.random.default_rng(seed + 10))
    assert got == want and len(got) == c


def _drive(pol, trace):
    hits = [pol.request(int(i)) for i in trace]
    return hits, pol


@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("batch", [1, 7])
def test_ogb_classic_equals_the_reference(integral, batch):
    trace = zipf(150, 600, alpha=0.9, seed=batch)
    kw = dict(horizon=600, batch_size=batch, integral=integral, seed=3)
    got_hits, got = _drive(ogb_classic.OGBClassic(150, 20, **kw), trace)
    want_hits, want = _drive(j_classic.OGBClassic(150, 20, **kw), trace)
    assert got.eta == want.eta and got_hits == want_hits
    np.testing.assert_array_equal(got.f, want.f)
    assert got.cached == want.cached and got.replacements == want.replacements
    assert got.fractional_reward == want.fractional_reward
    assert got.occupancy() == want.occupancy()


@pytest.mark.parametrize("c", [1, 7, 30])
def test_project_capped_simplex_kl_equals_the_reference(c):
    rng = np.random.default_rng(c)
    w = rng.normal(0.0, 2.0, size=60)
    f, lam = omd.project_capped_simplex_kl(w, c, return_lam=True)
    jf, jlam = j_omd.project_capped_simplex_kl(w, c, return_lam=True)
    np.testing.assert_array_equal(f, jf)
    assert lam == jlam and abs(f.sum() - c) < 1e-9
    np.testing.assert_array_equal(omd.project_capped_simplex_kl(w, c),
                                  j_omd.project_capped_simplex_kl(w, c))


@pytest.mark.parametrize("integral", [True, False])
def test_omd_classic_equals_the_reference(integral):
    trace = zipf(120, 500, alpha=0.8, seed=4)
    kw = dict(horizon=500, batch_size=10, integral=integral, seed=5)
    got_hits, got = _drive(omd.OMDClassic(120, 15, **kw), trace)
    want_hits, want = _drive(j_omd.OMDClassic(120, 15, **kw), trace)
    assert got.eta == want.eta and got_hits == want_hits
    np.testing.assert_array_equal(got.f, want.f)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.cached == want.cached and got.fractional_reward == want.fractional_reward


def test_make_policy_builds_the_classic_baselines():
    cl = make_policy("ogb_cl", 100, 10, eta=0.01)
    md = make_policy("OMD_cl", 100, 10, eta=0.01)
    assert isinstance(cl, ogb_classic.OGBClassic) and isinstance(md, omd.OMDClassic)
    assert {"ogb_cl", "omd_cl"} <= set(POLICY_REGISTRY)
    for pol, ref in ((cl, jax_make_policy("ogb_cl", 100, 10, eta=0.01)),
                     (md, jax_make_policy("omd_cl", 100, 10, eta=0.01))):
        assert [pol.request(i % 13) for i in range(50)] == [ref.request(i % 13) for i in range(50)]


def test_compare_equals_the_reference():
    trace = zipf(200, 3000, alpha=0.9, seed=6)
    kinds = ["lru", "fifo", "lfu", "arc", "ogb_cl", "omd_cl"]
    kw = {"ogb_cl": {"horizon": 3000, "seed": 1}, "omd_cl": {"horizon": 3000, "seed": 1}}
    got = compare(kinds, trace, window=500, catalog_size=200, capacity=25, policy_kw=kw)
    want = jax_compare(kinds, trace, window=500, catalog_size=200, capacity=25, policy_kw=kw)
    assert list(got) == list(want)
    for name in got:
        assert got[name].hits == want[name].hits, name
        np.testing.assert_array_equal(got[name].windowed, want[name].windowed)
    pols = {"mine": make_policy("lru", 200, 25)}
    assert compare(pols, trace, window=500)["mine"].hits == got["LRU"].hits
    with pytest.raises(ValueError, match="catalog_size and capacity"):
        compare(["lru"], trace)


@pytest.mark.parametrize("n,c,eta,seed", [(12, 4, 0.3, 0), (40, 9, 0.05, 1), (25, 20, 1.5, 2)])
def test_footnote_3_ogb_equals_ogb_classic_at_b1(n, c, eta, seed):
    """Paper footnote 3: at B = 1 the lazy O(log N) OGB and the eager OGB_cl
    keep the same fractional state after every request."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1) ** 1.1
    reqs = rng.choice(n, size=80, p=w / w.sum())
    lazy = OGB(n, c, eta=eta, batch_size=1, lazy_init=False)
    eager = ogb_classic.OGBClassic(n, c, eta=eta, batch_size=1, integral=False)
    for j in reqs:
        lazy.update_probabilities(int(j))
        eager.request(int(j))
        np.testing.assert_allclose(lazy.fractional_vector(), eager.f, atol=1e-9)


def _ids(n, b, seed):
    return np.random.default_rng(seed).integers(0, n, size=b).astype(np.int32)


@pytest.mark.parametrize("n,c,b,eta", [(128, 16, 32, 0.05), (2000, 300, 200, 0.02)])
def test_ogb_batch_update_matches_the_reference(n, c, b, eta):
    state = tfr.FractionalState.create(n, c, device="cpu")
    jstate = jfr.FractionalState.create(n, c)
    assert state.f.dtype == torch.float32 and int(state.step) == 0
    for step in range(5):
        ids = _ids(n, b, step)
        state, reward = tfr.ogb_batch_update(state, torch.from_numpy(ids), eta, c)
        jstate, jreward = jfr.ogb_batch_update(jstate, jnp.asarray(ids), jnp.float32(eta), c)
        np.testing.assert_allclose(state.f.numpy(), np.asarray(jstate.f), rtol=0, atol=1e-5)
        assert abs(float(reward) - float(jreward)) <= 1e-5 * max(1.0, abs(float(jreward)))
    assert int(state.step) == 5 and abs(float(state.f.double().sum()) - c) <= 1e-3


@pytest.mark.parametrize("n,c,b,eta", [(128, 16, 32, 0.05), (2000, 300, 200, 0.02)])
def test_ogb_batch_update_warm_matches_the_reference(n, c, b, eta):
    state = tfr.FractionalState.create(n, c, device="cpu")
    jstate = jfr.FractionalState.create(n, c)
    tau, jtau = torch.zeros(()), jnp.float32(0.0)
    for step in range(5):
        ids = _ids(n, b, 10 + step)
        state, reward, tau = tfr.ogb_batch_update_warm(state, torch.from_numpy(ids), eta, c, tau)
        jstate, jreward, jtau = jfr.ogb_batch_update_warm(jstate, jnp.asarray(ids),
                                                          jnp.float32(eta), c, jtau)
        assert abs(float(tau) - float(jtau)) <= 1e-6
        np.testing.assert_allclose(state.f.numpy(), np.asarray(jstate.f), rtol=0, atol=1e-5)
        assert abs(float(reward) - float(jreward)) <= 1e-5 * max(1.0, abs(float(jreward)))
    ids = _ids(n, b, 99)
    got = tfr.fractional_hit_ratio(state, torch.from_numpy(ids))
    want = jfr.fractional_hit_ratio(jstate, jnp.asarray(ids))
    assert got.shape == () and abs(float(got) - float(want)) <= 1e-6


def test_fractional_state_wants_a_device():
    if torch.cuda.is_available():
        pytest.skip("the card is there: device=None is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfr.FractionalState.create(10, 2)
