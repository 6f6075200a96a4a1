"""GreedyDual-Size: repro_torch's tree GDS and host GDS against repro's.

* The tree GDS (what the ``minpair_automaton`` kernel's GDS mode runs on the
  CPU, :func:`repro_torch.kernels.minpair_automaton.ref.gds_automaton_ref`)
  from the reference's initial carry: every carry leaf and the hits equal
  to ``repro.cachesim.tree_engines.make_gds_tree_chunk``'s after every
  chunk, with unit, size-equal and dyadic costs, and padded slots.
* ``run(policy_def("gds"))`` against the host ``GDS`` of both packages,
  window by window: hits and byte hits exactly (dyadic sizes and costs keep
  every H exact in float32, so the device keys are the host's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
from repro.cachesim import tree_engines as jtree
from repro.core.policies import GDS as JGDS
import repro_torch
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.core.policies import GDS, make_policy

SLABS = np.asarray([1.0, 4.0, 16.0, 64.0])


def _instance(seed, n=90, t=3000):
    rng = np.random.default_rng(seed)
    trace = rng.integers(0, n, size=t).astype(np.int32)
    sizes = SLABS[rng.integers(0, len(SLABS), size=n)]
    return trace, sizes


def _costs(mode, sizes, seed):
    if mode == "unit":
        return None
    if mode == "sizes":
        return sizes.copy()
    rng = np.random.default_rng(seed + 100)
    return np.asarray([0.5, 1.0, 2.0, 4.0])[rng.integers(0, 4, size=len(sizes))]


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


@pytest.mark.parametrize("c,n_slots", [(9, None), (1, None), (30, 41)])
@pytest.mark.parametrize("costs_mode", ["unit", "sizes", "dyadic"])
def test_gds_carry_matches_reference_every_chunk(costs_mode, c, n_slots):
    n, w = 90, 250
    trace, sizes = _instance(3, n=n)
    costs = _costs(costs_mode, sizes, 3)
    jc = jtree.init_tree_gds_carry(n, c, n_slots, sizes=sizes, costs=costs)
    chunk = jtree.make_gds_tree_chunk(n, int(jc.slots.shape[0]), True)
    tc = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
    assert isinstance(tc, ttree.TreeGDSCarry)
    for i in range(len(trace) // w):
        ids = trace[i * w:(i + 1) * w]
        jc, flags = chunk(jc, jnp.asarray(ids))
        flags_t = torch.empty(w, dtype=torch.bool)
        tc, (hits, stats) = ttree.tree_chunk("gds", tc, torch.from_numpy(ids), flags_t)
        np.testing.assert_array_equal(flags_t.numpy(), np.asarray(flags), err_msg=f"chunk {i}")
        assert int(hits) == int(np.asarray(flags).sum())
        assert float(stats[2]) == float((np.asarray(jc.slots) >= 0).sum())
        for name, want in _leaves(jc).items():
            np.testing.assert_array_equal(getattr(tc, name).numpy(), want,
                                          err_msg=f"{name} after chunk {i}")
    if n_slots:
        assert bool((tc.slots[c:] == -2).all())


@pytest.mark.parametrize("costs_mode", ["unit", "dyadic"])
def test_init_matches_reference(costs_mode):
    n = 70
    _, sizes = _instance(5, n=n)
    costs = _costs(costs_mode, sizes, 5)
    want = _leaves(jtree.init_tree_gds_carry(n, 12, 15, sizes=sizes, costs=costs))
    got = ttree.init_tree_gds_carry(n, 12, 15, sizes=sizes, costs=costs, device="cpu")
    assert got._fields == tuple(want)
    for name, value in want.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("costs_mode", ["unit", "sizes", "dyadic"])
def test_gds_run_matches_host_oracles(seed, costs_mode):
    """api.run(policy_def("gds")) against the port's host GDS and the
    reference's, window by window: hits and byte hits exactly."""
    n, c, w = 90, 9, 250
    trace, sizes = _instance(seed, n=n)
    costs = _costs(costs_mode, sizes, seed)
    r = repro_torch.run(repro_torch.policy_def("gds"), trace, n, c, window=w, sizes=sizes,
                        costs=costs, track_opt=False, device="cpu")
    hosts = (GDS(n, c, sizes=sizes, costs=costs), JGDS(n, c, sizes=sizes, costs=costs))
    for k in range(len(trace) // w):
        chunk = trace[k * w:(k + 1) * w]
        flags = [np.asarray([h.request(int(i)) for i in chunk]) for h in hosts]
        np.testing.assert_array_equal(flags[0], flags[1])
        assert r.hits[k] == flags[0].sum()
        assert r.byte_hits[k] == float(np.sum(sizes[chunk][flags[0]]))
    assert r.bytes_total == float(np.sum(sizes[trace]))
    assert 0.0 <= r.byte_hit_ratio <= 1.0 and r.name == "GDS"
    want = japi.run(japi.policy_def("gds"), jnp.asarray(trace), n, c, window=w, sizes=sizes,
                    costs=costs, track_opt=False)
    np.testing.assert_array_equal(r.hits, np.asarray(want.hits))
    np.testing.assert_array_equal(r.byte_hits, np.asarray(want.byte_hits, np.float64))
    np.testing.assert_array_equal(r.occupancy, np.asarray(want.occupancy))


def test_gds_run_resumes_bit_for_bit():
    n, c, w = 90, 9, 250
    trace, sizes = _instance(4, n=n)
    pd = repro_torch.policy_def("gds")
    whole = repro_torch.run(pd, trace, n, c, window=w, sizes=sizes, device="cpu")
    first = repro_torch.run(pd, trace[:1500], n, c, window=w, sizes=sizes, device="cpu")
    kept = [x.clone() for x in first.carry]
    second = repro_torch.run(pd, trace[1500:], capacity=c, window=w, carry=first.carry,
                             sizes=sizes, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(first.carry, kept))  # not modified
    np.testing.assert_array_equal(np.concatenate([first.hits, second.hits]), whole.hits)
    np.testing.assert_array_equal(np.concatenate([first.byte_hits, second.byte_hits]),
                                  whole.byte_hits)
    assert all(torch.equal(a, b) for a, b in zip(second.carry, whole.carry))


def test_unit_gds_is_lru_with_aging():
    """Unit sizes and costs: every byte hit is a hit, and the host oracle
    registered under "gds" replays the run."""
    n, c, w = 60, 7, 200
    trace, _ = _instance(6, n=n, t=2000)
    r = repro_torch.run(repro_torch.policy_def("gds"), trace, n, c, window=w, device="cpu")
    np.testing.assert_array_equal(r.byte_hits, r.hits.astype(np.float64))
    host = make_policy("gds", n, c)
    assert sum(host.request(int(i)) for i in trace) == int(r.hits.sum())


def test_gds_rejects_bad_sizes_and_costs():
    n = 10
    for kw in ({"sizes": np.zeros(n)}, {"costs": np.full(n, -1.0)},
               {"sizes": np.ones(n - 1)}):
        with pytest.raises(ValueError):
            ttree.init_tree_gds_carry(n, 3, device="cpu", **kw)
        with pytest.raises(ValueError):
            GDS(n, 3, **kw)
