"""The sized axis: repro_torch's ogb_sized, weighted projections, byte
accounting and sized_cdn against repro's.

* ``core.ogb_sized`` (the float64 host oracle) and the weighted projections
  (``kernels.capped_simplex.ops.weighted_simplex_project[_warm]``) against
  the reference's; the bisection reduces to the unit path bit for bit at
  sizes == 1.
* The stacked tree update's plain version against the reference's
  ``_stacked_tree_update``.
* ``ogb_sized``'s initial tree carry bit for bit (``test_torch_sized_tree.py``
  holds its chunks), and the scan flavor chunk by chunk against the
  reference's.
* The automata's byte accounting (LRU, LFU, FTPL) against the reference's
  sized runs, and ``run_scenario("sized_cdn", "mini")`` against the golden.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
from repro.cachesim import scenarios as jscen
from repro.cachesim import tree_engines as jtree
from repro.core import ogb_sized as jsized
from repro.kernels.capped_simplex import ops as jcs
import repro_torch
from repro_torch.cachesim import scenarios as tscen
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.core import ogb_sized as tsized
from repro_torch.jaxcache.fractional import capped_simplex_project
from repro_torch.kernels.capped_simplex.ops import (
    weighted_simplex_project,
    weighted_simplex_project_warm,
)
from repro_torch.kernels.prefix_tree.ops import stacked_tree_update_, tree_storage

SLABS = np.asarray([1.0, 4.0, 16.0, 64.0])
GOLDEN = os.path.join(os.path.dirname(__file__), "cachesim", "golden", "sized_cdn.json")
EXACT_ATOL, FLOAT_ATOL = 1e-12, 5e-3


def _instance(seed, n=120, t=4000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=t).astype(np.int32), SLABS[rng.integers(0, 4, size=n)]


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _reference_sized_carry(n, cap, t, sizes, **kw):
    with jax.threefry_partitionable(False):
        return japi.policy_def("ogb_sized", **kw).init(n, cap, seed=0, eta=None, horizon=t,
                                                       sizes=sizes)


# -- the host oracle and the weighted projections ------------------------------


def test_size_classes_and_host_sized_ogb_match_reference():
    rng = np.random.default_rng(0)
    for sizes in (SLABS[rng.integers(0, 4, 500)], rng.lognormal(3.0, 1.0, 500)):
        for k in (4, 16):
            got, want = tsized.size_classes(sizes, k), jsized.size_classes(sizes, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    cls = {i: int(c) for i, c in enumerate(rng.integers(0, 4, 200))}
    a = tsized.SizedOGB(list(SLABS), cls, capacity=300.0, eta=0.05)
    b = jsized.SizedOGB(list(SLABS), cls, capacity=300.0, eta=0.05)
    for j in rng.integers(0, 200, 3000):
        a.update(int(j))
        b.update(int(j))
    np.testing.assert_array_equal(a.fractional_vector(200), b.fractional_vector(200))
    y, s = rng.random(300) * 2, SLABS[rng.integers(0, 4, 300)]
    assert tsized.weighted_capped_simplex_tau(y, s, 40.0) == \
        jsized.weighted_capped_simplex_tau(y, s, 40.0)


@pytest.mark.parametrize("n", [7, 150, 5000])
def test_weighted_projection_reduces_to_the_unit_path_bit_for_bit(n):
    y = torch.from_numpy(np.random.default_rng(n).random(n).astype(np.float32) * 1.7)
    f_w, tau_w = weighted_simplex_project(y, torch.ones(n), 0.3 * n)
    f_u, tau_u = capped_simplex_project(y, torch.zeros(n), 0.0, 0.3 * n)
    assert torch.equal(f_w, f_u) and torch.equal(tau_w, tau_u)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_projections_match_reference_and_float64(seed):
    rng = np.random.default_rng(seed)
    n = 400
    y = (rng.random(n) * 1.5).astype(np.float32)
    s = SLABS[rng.integers(0, 4, n)].astype(np.float32)
    cap = float(0.2 * np.sum(s))
    f, tau = weighted_simplex_project(torch.from_numpy(y), torch.from_numpy(s), cap)
    jf, jtau = jcs.weighted_simplex_project(jnp.asarray(y), jnp.asarray(s), cap)
    assert float(tau) == pytest.approx(float(jtau), abs=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
    f64 = tsized.project_weighted(y.astype(np.float64), s.astype(np.float64), cap)
    np.testing.assert_allclose(f.numpy(), f64, atol=1e-4)
    assert float(np.sum(s * f.numpy())) == pytest.approx(cap, rel=1e-5)
    # the warm Newton form from a bracket around the root
    lo, hi, tau0 = float(tau) - 0.05, float(tau) + 0.05, float(tau) - 0.01
    wf, wtau = weighted_simplex_project_warm(torch.from_numpy(y), torch.from_numpy(s), cap, lo, hi,
                                             tau0)
    jwf, jwtau = jcs.weighted_simplex_project_warm(jnp.asarray(y), jnp.asarray(s), cap,
                                                   jnp.float32(lo), jnp.float32(hi),
                                                   jnp.float32(tau0))
    assert float(wtau) == pytest.approx(float(jwtau), abs=1e-6)
    np.testing.assert_allclose(wf.numpy(), np.asarray(jwf), atol=1e-5)
    np.testing.assert_allclose(wf.numpy(), f64, atol=1e-4)


def test_stacked_tree_update_matches_reference():
    rng = np.random.default_rng(3)
    kk, v, radix, q = 4, 4096, 64, 3000
    tot = tree_storage(v, radix)
    base = np.round(rng.random((kk, tot)) * 100).astype(np.float32)
    rows = rng.integers(0, kk, q)
    idx = np.where(rng.random(q) < 0.1, -1, rng.integers(0, v, q))
    for delta in (rng.choice([-1.0, 1.0], q).astype(np.float32),
                  (rng.random(q) - 0.5).astype(np.float32)):
        want = np.asarray(jtree._stacked_tree_update(jnp.asarray(base), v, radix,
                                                     jnp.asarray(rows), jnp.asarray(idx),
                                                     jnp.asarray(delta)))
        got = stacked_tree_update_(torch.from_numpy(base.copy()), v, radix, torch.from_numpy(rows),
                                   torch.from_numpy(idx), torch.from_numpy(delta)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        if np.all(np.abs(delta) == 1.0):  # integer deltas: exact in any order
            np.testing.assert_array_equal(got, want)


# -- ogb_sized, the tree flavor -------------------------------------------------


@pytest.mark.parametrize("sample,costs", [("poisson", None), ("none", None),
                                          ("poisson", "dyadic")])
def test_init_matches_reference(sample, costs):
    trace, sizes = _instance(1, n=300)
    n = len(sizes)
    w = None if costs is None else np.asarray([0.5, 1, 2, 4])[np.arange(n) % 4] * 1.0
    kw = dict(sizes=sizes, costs=w, eta=0.03, sample=sample, batch_hint=500)
    want = _leaves(jtree.init_sized_ogb_tree_carry(n, 900.0, **kw))
    got = ttree.init_sized_ogb_tree_carry(n, 900.0, device="cpu", **kw)
    assert got._fields[:-1] == tuple(want)
    for name, value in want.items():
        if name in ("p", "dcnt") and sample == "poisson":
            # the port's own stream of p, and the d-trees over y - p
            assert getattr(got, name).shape == value.shape
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=name)


# -- ogb_sized, the scan flavor -------------------------------------------------


def test_sized_scan_matches_reference_chunk_by_chunk():
    trace, sizes = _instance(21, n=200, t=6000)
    n, cap, w = 200, 8.0 * float(np.mean(sizes)), 500
    jc = _reference_sized_carry(n, cap, len(trace), sizes, flavor="scan")
    pd = repro_torch.policy_def("ogb_sized", flavor="scan")
    got = repro_torch.run(pd, trace, capacity=cap, window=w, sizes=sizes, device="cpu",
                          carry=repro_torch.carry_from_numpy(_leaves(jc), "cpu"))
    want = japi.run(japi.policy_def("ogb_sized", flavor="scan"), jnp.asarray(trace), carry=jc,
                    capacity=cap, window=w, sizes=sizes, track_opt=False)
    assert got.name == "OGB_sized_scan"
    np.testing.assert_allclose(got.reward, np.asarray(want.reward, np.float64), rtol=1e-4)
    np.testing.assert_allclose(got.aux, np.asarray(want.aux, np.float64), atol=1e-5)
    assert np.abs(got.hits - np.asarray(want.hits)).max() <= 2
    np.testing.assert_allclose(got.byte_hits, np.asarray(want.byte_hits, np.float64), rtol=1e-3)
    assert got.bytes_total == float(np.sum(sizes[trace]))


# -- byte accounting, the registry, sized_cdn ------------------------------------


@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl"])
def test_sized_automata_byte_hits_match_reference(kind):
    trace, sizes = _instance(21)
    kw = dict(window=500, seed=2, horizon=len(trace), track_opt=False)
    want = japi.run(japi.policy_def(kind), jnp.asarray(trace), 120, 11, sizes=sizes, **kw)
    got = repro_torch.run(repro_torch.policy_def(kind), trace, 120, 11, sizes=sizes,
                          device="cpu", **kw)
    plain = repro_torch.run(repro_torch.policy_def(kind), trace, 120, 11, device="cpu", **kw)
    np.testing.assert_array_equal(got.hits, np.asarray(want.hits))
    np.testing.assert_array_equal(got.hits, plain.hits)
    np.testing.assert_array_equal(got.byte_hits, np.asarray(want.byte_hits, np.float64))
    assert got.bytes_total == want.bytes_total and got.byte_hit_ratio == want.byte_hit_ratio
    assert plain.byte_hits is None and plain.byte_hit_ratio == plain.hit_ratio
    assert isinstance(got.carry, repro_torch.cachesim.api.SizedAutomatonCarry)


def test_unit_policies_reject_sizes_and_costs():
    trace, sizes = _instance(25, n=40, t=1000)
    kw = dict(window=250, track_opt=False, device="cpu")
    for kind in ("ogb", "ogb_tree", "omd"):
        with pytest.raises(ValueError, match="unit-size"):
            repro_torch.run(repro_torch.policy_def(kind), trace, 40, 5, sizes=sizes, **kw)
    with pytest.raises(ValueError, match="costs"):
        repro_torch.run(repro_torch.policy_def("lru"), trace, 40, 5, sizes=sizes, costs=sizes,
                        horizon=1000, **kw)
    with pytest.raises(ValueError, match="sizes"):
        repro_torch.run(repro_torch.policy_def("ogb_sized", flavor="scan"), trace, 40, 5,
                        eta=0.05, **kw)
    for bad in (np.zeros(40), np.full(40, -1.0), np.full(40, np.nan), np.ones(39)):
        with pytest.raises(ValueError):
            repro_torch.run(repro_torch.policy_def("lru"), trace, 40, 5, sizes=bad,
                            horizon=1000, **kw)


def test_sized_registry_matches_reference():
    for scale in ("mini", "quick", "full"):
        sc, ref = tscen.SCENARIOS["sized_cdn"], jscen.SCENARIOS["sized_cdn"]
        np.testing.assert_array_equal(sc.make_sizes(scale), ref.make_sizes(scale))
        assert sc.byte_capacity(scale) == ref.byte_capacity(scale)
    assert tscen.SCENARIOS["fig8_cdn"].make_sizes("mini") is None
    trace, sizes = _instance(30, n=300, t=5000)
    for cap in (0.0, 17.5, 400.0, 1e9):
        assert tscen.best_static_byte_hits(trace, sizes, cap) == \
            jscen.best_static_byte_hits(trace, sizes, cap)


@pytest.fixture(scope="module")
def sized_mini():
    return tscen.run_scenario("sized_cdn", "mini", device="cpu")


def test_sized_cdn_mini_matches_the_golden(sized_mini):
    """Every row of the golden: GDS, LRU, LFU, FTPL and OPT(static) hit and
    byte hit ratios exactly, OGB_sized_tree's hit and byte hit ratios and
    its byte regret as test_golden.py holds them (its Poisson p is the
    port's own here; from the reference's p below)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    res = sized_mini
    assert res.rows.keys() == golden["rows"].keys() and res.skipped == ()
    assert (res.N, res.T, res.C) == (golden["N"], golden["T"], golden["C"])
    for policy, entry in golden["rows"].items():
        for metric, want in entry.items():
            got = res.rows[policy][metric]
            if policy == "OGB_sized_tree" and metric != "byte_regret":
                continue  # the Poisson p: held below from the reference's carry
            tol = (EXACT_ATOL if metric in ("hit_ratio", "byte_hit_ratio")
                   else max(FLOAT_ATOL * golden["T"], abs(want) * 5e-3))
            assert round(got, 10) == pytest.approx(want, abs=tol), (policy, metric, got, want)
    assert res.byte_hit_ratio("GDS") == res.rows["GDS"]["byte_hit_ratio"]


def test_sized_cdn_ogb_row_from_the_reference_p():
    with open(GOLDEN) as f:
        golden = json.load(f)
    sc = tscen.get_scenario("sized_cdn")
    n, t, _ = sc.dims("mini")
    trace, sizes, cap = sc.make_trace("mini"), sc.make_sizes("mini"), sc.byte_capacity("mini")
    jc = _reference_sized_carry(n, cap, t, sizes)
    pd = repro_torch.policy_def("ogb_sized")
    res = repro_torch.run(pd, trace, capacity=cap, window=1000, sizes=sizes, device="cpu",
                          carry=repro_torch.carry_from_numpy(_leaves(jc), "cpu"))
    want = golden["rows"]["OGB_sized_tree"]
    assert res.hit_ratio == pytest.approx(want["hit_ratio"], abs=FLOAT_ATOL)
    assert res.byte_hit_ratio == pytest.approx(want["byte_hit_ratio"], abs=FLOAT_ATOL)
    regret = tscen.best_static_byte_hits(trace, sizes, float(cap)) - float(res.reward.sum())
    assert regret == pytest.approx(want["byte_regret"],
                                   abs=max(FLOAT_ATOL * t, abs(want["byte_regret"]) * 5e-3))


def test_sized_cdn_mini_ranks_bytes_and_objects_differently(sized_mini):
    """The scenario's claim on the port's own rows: byte hit ratio orders the
    policies differently from object hit ratio, and the byte winner is not
    the object winner."""
    rows = {k: v for k, v in sized_mini.rows.items() if k != "OPT(static)"}
    by_obj = sorted(rows, key=lambda k: -rows[k]["hit_ratio"])
    by_byte = sorted(rows, key=lambda k: -rows[k]["byte_hit_ratio"])
    assert by_obj != by_byte and by_byte[0] != by_obj[0]
