"""The comparison baselines: repro_torch's engines against repro's.

* The slot automata (LRU, FIFO, LFU, FTPL; ``impl="dense"``): the port's
  plain version (what the slot-automaton kernel runs on the CPU) against the
  reference's
  ``make_engine_fn(kind)`` from the same carry, chunk hits, occupancy and
  the final carry bit for bit, with padded carries and with LFU and FTPL
  ties.
* The host policies and ``simulate``, hit for hit.
* OMD's chunk step against the reference's ``_make_omd_step`` over 50
  chunks from the same carry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import engines as jeng
from repro.cachesim.simulator import simulate as jsimulate
from repro.core import ftpl as jftpl
from repro.core.omd import theoretical_eta_omd as j_eta_omd
from repro.core.policies import make_policy as jmake_policy
import repro_torch
from repro_torch.cachesim import engines as teng
from repro_torch.cachesim import traces as ttraces
from repro_torch.cachesim.simulator import simulate as tsimulate
from repro_torch.core import ftpl as tftpl
from repro_torch.core.omd import theoretical_eta_omd
from repro_torch.core.policies import make_policy, policy_kinds
from repro_torch.jaxcache.fractional import permanent_random_numbers

KINDS = ("lru", "fifo", "lfu", "ftpl")
N, T, W = 400, 6000, 500


def _traces():
    return {
        "zipf": ttraces.zipf(N, T, alpha=0.9, seed=1),
        "adversarial": ttraces.adversarial(N, T, seed=2),
        "bursty": ttraces.bursty(N, T, seed=3),
    }


TRACES = _traces()


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _port_run(kind, leaves, trace, window, **pd_kw):
    """The port's dense automaton from the reference's carry leaves, through run."""
    carry = type(teng.init_engine_carry(kind, N, 2, horizon=T, device="cpu"))(
        **{k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
    pd_kw.setdefault("impl", "dense")
    return repro_torch.run(repro_torch.policy_def(kind, **pd_kw), trace, capacity=None,
                           window=window, carry=carry, device="cpu")


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("c,n_slots", [(1, None), (25, None), (60, 75)])
@pytest.mark.parametrize("kind", KINDS)
def test_automaton_matches_reference_bit_for_bit(kind, c, n_slots, trace):
    tr = TRACES[trace]
    jc = jeng.init_engine_carry(kind, N, c, n_slots=n_slots, horizon=T)
    leaves = _leaves(jc)
    want, ys = jeng.make_engine_fn(kind)(jc, jnp.asarray(tr.reshape(-1, W), jnp.int32))
    got = _port_run(kind, leaves, tr, W)
    np.testing.assert_array_equal(got.hits, np.asarray(ys[0]))
    np.testing.assert_array_equal(got.occupancy, np.asarray(ys[1]))
    np.testing.assert_array_equal(got.reward, np.asarray(ys[0]))
    assert not got.aux.any()
    for name, value in _leaves(want).items():
        np.testing.assert_array_equal(getattr(got.carry, name).numpy(), value, err_msg=name)
    assert int(teng._occ_slots(got.carry)) == int(np.asarray(ys[1])[-1])


@pytest.mark.parametrize("kind", KINDS)
def test_init_matches_reference(kind):
    for c, n_slots in ((30, None), (30, 41)):
        want = _leaves(jeng.init_engine_carry(kind, N, c, n_slots=n_slots, seed=3, horizon=T))
        got = teng.init_engine_carry(kind, N, c, n_slots=n_slots, seed=3, horizon=T,
                                     device="cpu")
        assert got._fields == tuple(want)
        for name, value in want.items():
            assert getattr(got, name).dtype == {np.dtype("int32"): torch.int32,
                                                np.dtype("float32"): torch.float32}[value.dtype]
            np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=name)


def test_lfu_ties_break_by_tick_then_slot():
    """Every item once, round robin, then a hot pair: the victims are the
    least frequency, then the least tick; the empty slots fill in order."""
    tr = np.concatenate([np.arange(N), np.tile([3, 4], 50), np.arange(N)[::-1]]).astype(np.int64)
    tr = tr[: len(tr) // 100 * 100]
    jc = jeng.init_engine_carry("lfu", N, 17, n_slots=20)
    want, ys = jeng.make_engine_fn("lfu")(jc, jnp.asarray(tr.reshape(-1, 100), jnp.int32))
    got = _port_run("lfu", _leaves(jeng.init_engine_carry("lfu", N, 17, n_slots=20)), tr, 100)
    np.testing.assert_array_equal(got.hits, np.asarray(ys[0]))
    for name, value in _leaves(want).items():
        np.testing.assert_array_equal(getattr(got.carry, name).numpy(), value, err_msg=name)


@pytest.mark.parametrize("trace", ["zipf", "adversarial"])
def test_ftpl_ties_go_to_the_smallest_item(trace):
    """zeta = 0: no noise, so scores are the counts and tie often; the
    victim among equal least scores is the smallest item id."""
    tr = TRACES[trace]
    jc = jeng.init_engine_carry("ftpl", N, 40, zeta=0.0)
    assert not np.asarray(jc.noise).any()
    want, ys = jeng.make_engine_fn("ftpl")(jc, jnp.asarray(tr.reshape(-1, W), jnp.int32))
    got = _port_run("ftpl", _leaves(jeng.init_engine_carry("ftpl", N, 40, zeta=0.0)), tr, W)
    np.testing.assert_array_equal(got.hits, np.asarray(ys[0]))
    np.testing.assert_array_equal(got.carry.slots.numpy(), np.asarray(want.slots))
    np.testing.assert_array_equal(got.carry.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("kind", KINDS)
def test_automaton_run_resumes_and_leaves_its_carry(kind):
    pd = repro_torch.policy_def(kind, impl="dense")
    tr = TRACES["zipf"]
    whole = repro_torch.run(pd, tr, N, 30, window=W, horizon=T, device="cpu")
    first = repro_torch.run(pd, tr[: T // 2], N, 30, window=W, horizon=T, device="cpu")
    kept = [x.clone() for x in first.carry]
    second = repro_torch.run(pd, tr[T // 2:], N, 30, window=W, carry=first.carry, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(first.carry, kept))  # not modified
    np.testing.assert_array_equal(np.concatenate([first.hits, second.hits]), whole.hits)
    assert all(torch.equal(a, b) for a, b in zip(second.carry, whole.carry))
    assert whole.name == kind.upper() and not pd.fractional and pd.trace_driven


def test_policy_defs_registered_and_tree_impl_not_yet():
    """impl=None is the tree automaton for lru, lfu and ftpl (as in the
    reference) and the dense one for fifo, which has no tree form."""
    from repro_torch.cachesim import tree_engines as ttree

    assert set(repro_torch.policy_def_kinds()) == {"ogb", "ogb_tree", "omd", "lru", "fifo",
                                                   "lfu", "ftpl"}
    assert repro_torch.policy_def("lru") is repro_torch.policy_def("lru")  # memoized
    assert repro_torch.policy_def("lfu", impl="dense").name == "LFU"
    assert repro_torch.policy_def("omd").fractional
    tree_carries = {"lru": ttree.TreeLRUCarry, "lfu": ttree.TreeLFUCarry,
                    "ftpl": ttree.TreeFTPLCarry}
    for kind, carry_type in tree_carries.items():
        for impl in (None, "tree"):
            carry = repro_torch.policy_def(kind, impl=impl).init(N, 5, horizon=T, device="cpu")
            assert isinstance(carry, carry_type), (kind, impl)
        dense = repro_torch.policy_def(kind, impl="dense").init(N, 5, horizon=T, device="cpu")
        assert not isinstance(dense, carry_type)
    assert isinstance(repro_torch.policy_def("fifo").init(N, 5, device="cpu"), teng.SlotCarry)
    with pytest.raises(ValueError, match="no tree engine"):
        repro_torch.policy_def("fifo", impl="tree")
    with pytest.raises(ValueError):
        repro_torch.policy_def("fifo", impl="other")
    with pytest.raises(ValueError, match="ids"):
        repro_torch.run(repro_torch.policy_def("lfu"), np.array([0, N]), N, 3, window=2,
                        device="cpu")
    with pytest.raises(ValueError):
        teng.init_engine_carry("ftpl", N, 3, device="cpu")  # needs zeta or horizon


def test_ftpl_noise_and_initial_top_c_match():
    for zeta in (0.0, 0.7, 31.0):
        np.testing.assert_array_equal(tftpl.ftpl_noise(N, zeta, seed=5),
                                      jftpl.ftpl_noise(N, zeta, seed=5))
    noise = tftpl.ftpl_noise(N, 2.0, seed=5)
    np.testing.assert_array_equal(tftpl.ftpl_initial_top_c(noise, 33),
                                  jftpl.ftpl_initial_top_c(noise, 33))
    assert tftpl.theoretical_zeta(30, N, T) == jftpl.theoretical_zeta(30, N, T)
    assert theoretical_eta_omd(30, N, T, W) == j_eta_omd(30, N, T, W)


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("kind", ["lru", "fifo", "lfu", "arc", "ftpl"])
def test_host_policies_match_reference(kind, trace):
    tr = TRACES[trace]
    kw = {"horizon": T} if kind == "ftpl" else {}
    want = jsimulate(jmake_policy(kind, N, 40, **kw), tr, window=1000)
    got = tsimulate(make_policy(kind, N, 40, **kw), tr, window=1000)
    assert (got.name, got.hits, got.T, got.window) == (want.name, want.hits, want.T, want.window)
    np.testing.assert_array_equal(got.cum_hits, want.cum_hits)
    np.testing.assert_array_equal(got.windowed, want.windowed)
    assert got.hit_ratio == want.hit_ratio


def test_host_registry():
    assert set(policy_kinds()) == {"lru", "fifo", "lfu", "arc", "ogb", "ftpl"}
    with pytest.raises(ValueError):
        make_policy("gds", N, 4)
    res = tsimulate(make_policy("arc", N, 40), TRACES["zipf"], window=700, occupancy_every=1000)
    assert len(res.occupancy) == T // 1000 and max(res.occupancy) <= 40


@pytest.mark.parametrize("sample", ["poisson", "none"])
def test_omd_step_matches_reference_over_50_chunks(sample):
    """Same carry, same chunks: |dlam| <= 1e-5 and max |df| <= 1e-5 in every
    chunk (float32 sums in another order, and the gradient step w + eta *
    counts where the reference adds eta once per duplicate id); the
    rewards within 1e-5 relative; the hits within 1 a chunk (an item whose
    f lies within rounding of its p)."""
    n, c, b, chunks = 2000, 100, 200, 50
    tr = ttraces.zipf(n, b * chunks, alpha=0.9, seed=4)
    eta = theoretical_eta_omd(c, n, b * chunks, b)
    p = permanent_random_numbers(0, n, "cpu") if sample == "poisson" else torch.zeros(0)
    jstep = jeng._make_omd_step(sample, jeng.DEFAULT_OMD_SWEEPS, track_opt=False)
    tstep = teng._make_omd_step(sample, teng.DEFAULT_OMD_SWEEPS)
    jstate = jeng.init_omd_carry(n, c)
    tstate = teng.init_omd_carry(n, c, "cpu")
    eta_t, cap_t = torch.tensor(eta, dtype=torch.float32), torch.tensor(float(c))
    for i in range(chunks):
        ids = tr[i * b:(i + 1) * b]
        jstate, (jr, jh, jl, jo) = jstep(jnp.float32(eta), jnp.asarray(p.numpy()),
                                         jnp.float32(c), jstate,
                                         (jnp.asarray(ids, jnp.int32), jnp.float32(0.0)))
        tstate, (tr_, th, tl, to) = tstep(eta_t, p, cap_t, tstate,
                                          torch.from_numpy(ids.astype(np.int32)), None)
        assert abs(float(tl) - float(jl)) <= 1e-5, i
        assert float(np.abs(tstate.f.numpy() - np.asarray(jstate.f)).max()) <= 1e-5, i
        assert float(tr_) == pytest.approx(float(jr), rel=1e-5)
        assert abs(int(th) - int(jh)) <= 1
        assert float(to) == pytest.approx(float(jo), rel=1e-5, abs=1)
    f = tstate.f.double().numpy()
    assert abs(f.sum() - c) < 1e-2 and f.max() <= 1.0


def test_omd_run_from_reference_carry_and_defaults():
    from repro.cachesim import api as japi

    n, c = 1000, 50
    tr = ttraces.zipf(n, 20_000, alpha=0.9, seed=6)
    pd = repro_torch.policy_def("omd")
    jpd = japi.policy_def("omd")
    eta = pd.default_eta(n, c, 20_000, 500)
    jcarry = jpd.init(n, c, seed=0, eta=eta)
    leaves = {k: np.asarray(v) for k, v in jcarry._asdict().items()}
    want = japi.run(jpd, tr, capacity=c, window=500, carry=jcarry)
    got = repro_torch.run(pd, tr, capacity=c, window=500,
                          carry=repro_torch.carry_from_numpy(leaves, "cpu"), device="cpu")
    assert isinstance(got.carry, repro_torch.OMDApiCarry)
    np.testing.assert_allclose(got.aux, want.aux, rtol=0, atol=1e-5)
    # a chunk's reward sums 500 f's, each within the 1e-5 of the step test
    # above: up to 5e-3 on rewards of 25-130
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-4)
    assert abs(int(got.hits.sum()) - int(want.hits.sum())) <= len(got.hits)
    fresh = repro_torch.run(pd, tr, n, c, window=500, device="cpu")
    assert fresh.extras["eta"] == eta and 0.0 < fresh.hit_ratio < 1.0
