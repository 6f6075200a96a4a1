"""``repro_torch.sweep`` on the CPU: each row its combo's single run, and
the reference's ``sweep``.

A sweep replays one trace through a (seeds x etas x capacities) grid.  The
kinds with a grid form (dense ``ogb`` with Poisson or no sampling, the tree
``lru``, ``lfu`` and ``ftpl``, ``fifo``) stack the combos' carries and run
each chunk once for the grid, the plain versions row by row here; the others
run their combos one after another.  Either way a row is its combo's
``run``: the automata's hits and final carries bit for bit, dense ``ogb``'s
f and tau bit for bit and its reward and occupancy within 1e-5 relative.
Against ``repro.cachesim.api.sweep`` (as ``tests/cachesim/test_api.py`` and
``test_tree_policies.py`` hold it against its runs): the automata's hits
equal, ``ogb`` with ``sample="none"`` within the reference's atol 1e-3 on
the reward (the Poisson ``p`` cannot be carried across packages here).
"""

import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
import repro_torch
from repro_torch import SweepResult, policy_def, register_policy_def, run, sweep
from repro_torch.cachesim.results import find_combo
from repro_torch.cachesim.traces import zipf
from repro_torch.core.regret import best_static_hits

N, T, W = 400, 6000, 200
CAPS = [9, 30, 64]
TRACE = zipf(N, T, alpha=0.9, seed=11)
SIZES = np.asarray([1.0, 4.0, 16.0, 64.0])[np.random.default_rng(3).integers(0, 4, N)]


def _tensors(x):
    """The tensor leaves of a carry, nested carries and queues included."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _tensors(y)]
    return []


#: (kind, options, sweep keywords): every trace-driven kind the port
#: registers, each grid form and each combo-by-combo path
CASES = [
    ("ogb", {}, {"etas": (None, 0.05), "seeds": (0, 1)}),
    ("ogb", {"sample": "none"}, {"etas": (None,)}),
    ("ogb", {"projection": "bisect", "iters": 20}, {"etas": (0.05,)}),
    ("ogb", {"sample": "madow", "madow_capacity": 30}, {"caps": [30]}),
    ("ogb_tree", {}, {"etas": (None,)}),
    ("omd", {}, {"etas": (None, 0.02)}),
    ("lru", {}, {"seeds": (0, 1)}),
    ("lfu", {}, {}),
    ("ftpl", {}, {"seeds": (0, 1)}),
    ("fifo", {}, {}),
    ("lru", {"impl": "dense"}, {}),
    ("gds", {}, {"sizes": SIZES}),
    ("ogb_sized", {}, {"sizes": SIZES, "caps": [200, 600]}),
    ("lfu", {}, {"sizes": SIZES}),
    ("fifo", {}, {"sizes": SIZES}),
]


@pytest.mark.parametrize("kind,options,kw", CASES,
                         ids=[f"{k}-{'-'.join(map(str, o.values())) or 'default'}"
                              f"{'-sized' if 'sizes' in kw else ''}" for k, o, kw in CASES])
def test_sweep_rows_equal_their_single_runs(kind, options, kw):
    kw = dict(kw)
    caps = kw.pop("caps", CAPS)
    pd = policy_def(kind, **options)
    res = sweep(pd, TRACE, N, caps, window=W, device="cpu", **kw)
    grid = (kind in ("lru", "lfu", "ftpl", "fifo") and options.get("impl") != "dense") or (
        kind == "ogb" and options.get("sample", "poisson") in ("poisson", "none")
        and options.get("projection", "warm") == "warm")
    assert grid == (pd.batched is not None)
    seeds, etas = kw.get("seeds", (0,)), kw.get("etas", (None,))
    assert len(res.combos) == len(seeds) * len(etas) * len(caps)
    assert res.reward.shape == res.hits.shape == (len(res.combos), T // W)
    sized = {k: kw[k] for k in ("sizes",) if k in kw}
    for r, combo in enumerate(res.combos):
        assert r == res.row(**combo)
        one = run(pd, TRACE, N, combo["capacity"], window=W, seed=combo["seed"],
                  eta=combo.get("eta"), n_slots=max(caps), device="cpu", **sized)
        np.testing.assert_array_equal(res.hits[r], one.hits)
        np.testing.assert_array_equal(res.aux[r], one.aux)
        np.testing.assert_allclose(res.reward[r], one.reward, rtol=1e-5, atol=0)
        np.testing.assert_allclose(res.occupancy[r], one.occupancy, rtol=1e-5, atol=0)
        if sized:
            np.testing.assert_allclose(res.byte_hits[r], one.byte_hits, rtol=1e-12)
        got, want = _tensors(res.carries[r]), _tensors(one.carry)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert res.opt_hits[r] == one.opt_hits
    if sized:
        assert res.bytes_total == float(np.sum(SIZES[TRACE[: T // W * W]]))


def test_sweep_orders_combos_seed_eta_capacity_and_resolves_eta_per_capacity():
    pd = policy_def("ogb", sample="none")
    res = sweep(pd, TRACE, N, [30, 9], etas=(None, 0.5), seeds=(3, 1), window=W, device="cpu")
    assert [(c["seed"], c["capacity"]) for c in res.combos] == [
        (3, 30), (3, 9), (3, 30), (3, 9), (1, 30), (1, 9), (1, 30), (1, 9)]
    for combo, want in zip(res.combos[:2], (30, 9)):
        assert combo["eta"] == pd.default_eta(N, want, T, W)
    assert [c["eta"] for c in res.combos[2:4]] == [0.5, 0.5]
    automaton = sweep(policy_def("lru"), TRACE, N, [9], window=W, device="cpu")
    assert automaton.combos == [{"capacity": 9, "seed": 0}]


def test_sweep_result_rows_ratios_and_opt_per_capacity():
    res = sweep(policy_def("ogb"), TRACE, N, CAPS, etas=(None, 0.05), seeds=(0, 1), window=W,
                device="cpu")
    assert isinstance(res, SweepResult) and res.kind == "ogb" and res.batch == W
    t_used = T // W * W
    for r, combo in enumerate(res.combos):
        assert res.opt_hits[r] == float(best_static_hits(TRACE[:t_used], combo["capacity"]))
    np.testing.assert_allclose(res.regrets, res.opt_hits - res.reward.sum(axis=1))
    np.testing.assert_allclose(res.frac_hit_ratios, res.reward.sum(axis=1) / t_used)
    np.testing.assert_allclose(res.hit_ratios, res.hits.sum(axis=1) / t_used)
    np.testing.assert_array_equal(res.byte_hit_ratios, res.hit_ratios)  # unsized
    assert res.frac_reward is res.reward and res.taus is res.aux
    r = res.row(capacity=30, eta=0.05, seed=1)
    assert res.combos[r] == {"capacity": 30, "seed": 1, "eta": 0.05}
    assert find_combo(res.combos, capacity=64) == 2
    with pytest.raises(KeyError, match="no combo"):
        res.row(capacity=31)
    assert (res.regrets > 0).all() and (res.frac_hit_ratios > 0).all()
    untracked = sweep(policy_def("lfu"), TRACE, N, CAPS, window=W, device="cpu",
                      track_opt=False)
    assert not untracked.opt_hits.any() and len(untracked.carries) == len(CAPS)


@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl", "fifo"])
def test_automata_sweep_equals_the_reference_sweep(kind):
    caps = [5, 23, 64]
    got = sweep(policy_def(kind), TRACE, N, caps, seeds=(0, 2), window=100, device="cpu")
    want = japi.sweep(japi.policy_def(kind), TRACE, N, caps, seeds=(0, 2), window=100)
    assert got.combos == want.combos
    np.testing.assert_array_equal(got.hits, want.hits)
    np.testing.assert_array_equal(got.opt_hits, want.opt_hits)
    np.testing.assert_allclose(got.occupancy, want.occupancy, rtol=0, atol=0)


def test_ogb_sweep_without_sampling_matches_the_reference_sweep():
    kw = dict(etas=(None, 0.05), seeds=(0,), window=100)
    got = sweep(policy_def("ogb", sample="none"), TRACE, N, CAPS, device="cpu", **kw)
    want = japi.sweep(japi.policy_def("ogb", sample="none"), TRACE, N, CAPS, **kw)
    assert got.combos == want.combos
    np.testing.assert_allclose(got.reward, want.reward, atol=1e-3)
    np.testing.assert_allclose(got.aux, want.aux, atol=1e-5)
    np.testing.assert_array_equal(got.opt_hits, want.opt_hits)


def test_register_policy_def_round_trips():
    """A registered kind resolves through policy_def and sweeps; with no grid
    form its combos run one after another, as the built-in kind's grid."""
    from repro_torch.cachesim import api

    def factory(**options):
        base = policy_def("lru", **options)
        return api.PolicyDef(kind="my_lru", name="MY_LRU", init=base.init, step=base.step,
                             start=base.start)

    assert "my_lru" not in repro_torch.policy_def_kinds()
    register_policy_def("My_LRU", factory)
    try:
        pd = policy_def("my_lru")
        assert "my_lru" in repro_torch.policy_def_kinds() and pd.name == "MY_LRU"
        assert pd is policy_def("MY_LRU") and pd.batched is None
        mine = sweep(pd, TRACE, N, CAPS, window=W, device="cpu")
        builtin = sweep(policy_def("lru"), TRACE, N, CAPS, window=W, device="cpu")
        assert mine.kind == "my_lru"
        np.testing.assert_array_equal(mine.hits, builtin.hits)
        register_policy_def("my_lru", lambda **o: api.PolicyDef(
            kind="my_lru", name="AGAIN", init=pd.init, step=pd.step, start=pd.start))
        assert policy_def("my_lru").name == "AGAIN"  # re-registering replaces
    finally:
        api._POLICY_DEFS.pop("my_lru", None)
        api._cached_def.cache_clear()


def test_sweep_checks_its_inputs():
    pd = policy_def("lru")
    with pytest.raises(ValueError, match="shorter than one window"):
        sweep(pd, TRACE[:10], N, CAPS, window=W, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        sweep(pd, TRACE, N, [], window=W, device="cpu")
    with pytest.raises(ValueError, match="trace ids"):
        sweep(pd, TRACE, 50, CAPS, window=W, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep(pd, TRACE, N, CAPS, window=W)
