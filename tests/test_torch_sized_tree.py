"""ogb_sized's tree flavor chunk by chunk against repro's.

From the reference's own carry (its Poisson ``p`` drawn under
``jax.threefry_partitionable(False)``, the stream the goldens were made
with), the port's ``make_sized_ogb_tree_chunk`` (the plain versions of the
stacked tree update and of the sized solve) and the reference's, chunk by
chunk: the hits, the rewards, byte hits and occupancy, each chunk's step of
rho within 1e-5 or within what the reference's solve leaves where it
restarts, and the re-anchors where the reference's.  The reference's
Newton solve cannot be held tighter at the scenario's grid (ROADMAP.md §3:
a Newton point equal to the iterate is refused and the bisection restarts
from the top of the grid, the remaining steps leaving it ~5e-5 to 2e-4
wide); on a small grid the steps agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
from repro.cachesim import scenarios as jscen
from repro.cachesim import tree_engines as jtree
import repro_torch
from repro_torch.cachesim import tree_engines as ttree

SLABS = np.asarray([1.0, 4.0, 16.0, 64.0])
#: the bound on each chunk's step of rho, port against reference
DRHO_TOL = 1e-4


def _instance(seed, n=120, t=4000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=t).astype(np.int32), SLABS[rng.integers(0, 4, size=n)]


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _reference_sized_carry(n, cap, t, sizes, **kw):
    with jax.threefry_partitionable(False):
        return japi.policy_def("ogb_sized", **kw).init(n, cap, seed=0, eta=None, horizon=t,
                                                       sizes=sizes)


def _per_chunk(trace, n, cap, sizes, window, **kw):
    """The port and the reference, chunk by chunk from the reference's carry:
    (reference carries and outputs, port carries and outputs)."""
    jc = _reference_sized_carry(n, cap, len(trace), sizes, **kw)
    kk = int(jc.s.shape[0])
    v = kw.get("buckets", jtree.OGB_TREE_BUCKETS)
    jchunk = jtree.make_sized_ogb_tree_chunk(n, kk, v, jtree.OGB_TREE_RADIX, "poisson")
    tc = ttree.start_sized_run(repro_torch.carry_from_numpy(_leaves(jc), "cpu"))
    tchunk = ttree.make_sized_ogb_tree_chunk(v, ttree.OGB_TREE_RADIX, "poisson")
    ref, port = [], []
    for i in range(len(trace) // window):
        ids = trace[i * window:(i + 1) * window]
        jc, jout = jchunk(jc, jnp.asarray(ids))
        tc, tout = tchunk(tc, torch.from_numpy(ids))
        ref.append((float(jc.rho), *(float(x) for x in jout)))
        port.append((float(tc.rho), *(float(x) for x in tout)))
    return np.asarray(ref), np.asarray(port), tc


@pytest.mark.parametrize("name", ["sized_cdn", "random_slabs"])
def test_sized_tree_tracks_the_reference_chunk_by_chunk(name):
    """From the reference's carry: each chunk's step of rho within 1e-5 of
    the reference's, or, where either solve restarted its bisection from
    the grid's top (ROADMAP.md §3), within the width such a restart leaves
    after 25 of the 30 steps, wb * V / 2^25 (2.0e-4 and 4.1e-4 here); its
    reward within 5e-3 relative (a step of rho off by 2e-4 moves each
    requested f by up to s * 2e-4, s up to 3 here), its byte hits and
    occupancy within 1e-3 relative, its hits within 0.5% of the window; the
    run's hits within 0.1% of the trace; the host reads the device for a
    re-anchor at most once in 20 chunks (none here)."""
    if name == "sized_cdn":
        sc = jscen.get_scenario("sized_cdn")
        n, t, _ = sc.dims("mini")
        trace, sizes, cap = sc.make_trace("mini").astype(np.int32), sc.make_sizes("mini"), \
            sc.byte_capacity("mini")
    else:
        trace, sizes = _instance(11, n=400, t=10_000)
        n, cap = 400, 30.0 * float(np.mean(sizes))
    w = 1000
    ref, port, tc = _per_chunk(trace, n, cap, sizes, w)
    # columns: rho after the chunk, reward, hits, byte hits, drho, occupancy
    np.testing.assert_allclose(port[:, 1], ref[:, 1], rtol=5e-3)
    np.testing.assert_allclose(port[:, 3], ref[:, 3], rtol=1e-3)
    assert np.abs(port[:, 2] - ref[:, 2]).max() <= 0.005 * w
    assert abs(port[:, 2].sum() - ref[:, 2].sum()) <= 1e-3 * len(trace)
    drho = np.abs(port[:, 4] - ref[:, 4])
    restart = float(tc.wb) * ttree.OGB_TREE_BUCKETS / 2**25
    assert drho.max() <= restart, (drho.max(), restart, (drho <= 1e-5).mean())
    np.testing.assert_allclose(port[:, 5], ref[:, 5], rtol=1e-3)
    assert tc.host.syncs <= len(ref) // 20 and tc.host.reanchors == 0


def test_sized_tree_reanchors_where_the_reference_does():
    """batch_hint=1 shrinks the value grid so that every chunk re-anchors:
    the port re-anchors after the chunks where the reference does.  On this
    small grid the reference's solve converges (its bisection, where it
    restarts, starts from a bracket of wb * V ~ 60), and each chunk's step
    of rho is the reference's within 1e-5 in at least 98% of the chunks."""
    trace, sizes = _instance(12, n=300, t=12_000)
    n, cap = 300, 25.0 * float(np.mean(sizes))
    ref, port, tc = _per_chunk(trace, n, cap, sizes, 500, batch_hint=1)
    reanchored_ref = ref[:, 0] == 0.0
    reanchored_port = port[:, 0] == 0.0
    assert reanchored_ref.sum() >= 3
    np.testing.assert_array_equal(reanchored_port, reanchored_ref)
    assert tc.host.reanchors == int(reanchored_port.sum()) <= tc.host.syncs
    drho = np.abs(port[:, 4] - ref[:, 4])
    assert drho.max() <= DRHO_TOL and (drho <= 1e-5).mean() >= 0.98


def test_sized_tree_at_unit_sizes_tracks_ogb_tree():
    """sizes == 1 gives the unit ogb_tree dynamics at the same eta, within
    the two solves' difference (the sized solve is Newton in float32, the
    unit one 30 halvings in float64; the reference's two are one code, bit
    for bit): each chunk's step of rho within 1e-4, rewards within 1e-3
    relative, hits within 2 a chunk."""
    trace, _ = _instance(8, n=150, t=4000)
    kw = dict(window=400, seed=5, eta=0.03, track_opt=False, device="cpu")
    sized = repro_torch.run(repro_torch.policy_def("ogb_sized"), trace, 150, 13,
                            sizes=np.ones(150), **kw)
    unit = repro_torch.run(repro_torch.policy_def("ogb_tree"), trace, 150, 13, **kw)
    np.testing.assert_allclose(sized.reward, unit.reward, rtol=1e-3)
    assert np.abs(sized.hits - unit.hits).max() <= 2
    np.testing.assert_allclose(sized.aux, unit.aux, atol=1e-4)
    np.testing.assert_array_equal(sized.byte_hits, sized.hits.astype(np.float64))
