"""The tree automata: repro_torch's tree engines against repro's.

* The tree LRU, LFU and FTPL (``repro_torch.cachesim.tree_engines``, what
  the ``tree_lru`` and ``minpair_automaton`` kernels run on the CPU)
  against the reference's ``make_tree_chunk``: from the same carry, carried
  across by ``carry_from_numpy``, every carry leaf and the hits bit for bit
  after every chunk, at windows 1, 16 and 250 on the zipf, cyclic and
  bursty traces of ``tests/cachesim/test_tree_policies.py`` (window 1 over
  the first 1500 requests: a chunk a request, each compared), with forced
  ring compactions and with padded slots; per-request flags.
* The same engines through ``run`` against the port's dense automata (hits
  and occupancy), the tree LRU against the reuse-distance oracle, resume.
* The int32 count trees and the min-pair trees against the reference's
  ``prefix_tree.ops``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import tree_engines as jtree
from repro.kernels.prefix_tree import ops as jops
from repro.kernels.prefix_tree.ref import stack_distance_hits_ref as j_stack_distance
import repro_torch
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.kernels.prefix_tree import ops as tops
from repro_torch.kernels.prefix_tree.ref import stack_distance_hits_ref

AUTOMATA = ("lru", "lfu", "ftpl")
N, T, C = 400, 6000, 23
WINDOW_1_REQUESTS = 1500


def _zipf_trace(rng, n, t, a=1.2):
    ranks = rng.zipf(a, size=t * 3) - 1
    ranks = ranks[ranks < n][:t]
    return rng.permutation(n)[ranks].astype(np.int32)


def _traces():
    """tests/cachesim/test_tree_policies.py's traces, as int32 numpy."""
    rng = np.random.default_rng(42)
    zipf = _zipf_trace(rng, N, T)
    cyclic = np.tile(np.arange(50), T // 50).astype(np.int32)
    bursty = np.concatenate(
        [np.repeat(rng.integers(0, N, 40), 30) for _ in range(5)]).astype(np.int32)
    return {"zipf": zipf, "cyclic": cyclic, "bursty": bursty}


TRACES = _traces()


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _tensors(carry):
    """A carry's tensor leaves (the tree LRU's also has a host-side bound)."""
    return [x for x in carry if isinstance(x, torch.Tensor)]


def _check_carry(port, ref, label):
    for name, want in _leaves(ref).items():
        got = getattr(port, name)
        assert got.dtype == {np.dtype("int32"): torch.int32,
                             np.dtype("float32"): torch.float32}[want.dtype], (label, name)
        np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape),
                                      err_msg=f"{label}: {name}")


def _chunk_by_chunk(kind, jcarry, trace, window, return_flags=False):
    """Both engines from ``jcarry`` over ``trace``, compared after every chunk."""
    ref = jax.jit(jtree.make_tree_chunk(kind, jcarry, return_flags))
    port = repro_torch.carry_from_numpy(_leaves(jcarry), "cpu")
    step = ttree.make_tree_chunk(kind, port, return_flags)
    hits = 0
    for i in range(len(trace) // window):
        ids = trace[i * window:(i + 1) * window]
        jcarry, (jh, jocc) = ref(jcarry, jnp.asarray(ids))
        port, (h, occ) = step(port, torch.from_numpy(ids))
        label = f"{kind} window {window} chunk {i}"
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh), err_msg=label)
        assert float(occ) == float(jocc), label
        _check_carry(port, jcarry, label)
        hits += int(np.asarray(jh).sum())
    return port, hits


@pytest.mark.parametrize("window", [1, 16, 250])
@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("kind", AUTOMATA)
def test_tree_engine_equals_the_reference_after_every_chunk(kind, trace, window):
    tr = TRACES[trace][:WINDOW_1_REQUESTS] if window == 1 else TRACES[trace]
    jc = jtree.init_tree_engine_carry(kind, N, C, seed=3, horizon=T)
    _, hits = _chunk_by_chunk(kind, jc, tr, window)
    assert hits < len(tr)  # every case misses, so every automaton evicts


@pytest.mark.parametrize("kind", AUTOMATA)
def test_per_request_flags_equal_the_reference(kind):
    jc = jtree.init_tree_engine_carry(kind, N, C, seed=1, horizon=T)
    _chunk_by_chunk(kind, jc, TRACES["zipf"][:3000], 300, return_flags=True)


def test_tree_lru_forced_compactions_equal_the_reference():
    """A ring of 256 positions for 40 slots: a compaction every few chunks,
    each the reference's (last remapped, the tree rebuilt, pos restarted)."""
    rng = np.random.default_rng(5)
    tr = _zipf_trace(rng, 600, 8000, a=1.1)
    jc = jtree.init_tree_lru_carry(600, 40, ring=256)
    compactions, pos = 0, 0
    ref = jax.jit(jtree.make_tree_chunk("lru", jc))
    port = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
    for i in range(len(tr) // 100):
        ids = tr[i * 100:(i + 1) * 100]
        compactions += pos + 100 > 256
        jc, (jh, _) = ref(jc, jnp.asarray(ids))
        port, (h, _) = ttree.make_tree_chunk("lru", port)(port, torch.from_numpy(ids))
        assert int(h) == int(jh)
        _check_carry(port, jc, f"chunk {i}")
        pos = int(port.pos)
    assert compactions >= 20
    dense = repro_torch.run(repro_torch.policy_def("lru", impl="dense"), tr, 600, 40,
                            window=100, device="cpu")
    tree = repro_torch.run(repro_torch.policy_def("lru"), tr, 600, 40, window=100, ring=256,
                           device="cpu")
    np.testing.assert_array_equal(tree.hits, dense.hits)


@pytest.mark.parametrize("cap,ring", [(40, 256), (5, 256), (100, 512)])
def test_host_bounds_on_the_ring_position_hold(cap, ring):
    """The card launches a compaction where the host's upper bound on pos
    leaves no room for the chunk; the bounds must hold the true pos (the
    plain version's, which decides from pos itself), so that no due
    compaction goes unlaunched, and a launch is certain to be due where the
    lower bound leaves no room either."""
    rng = np.random.default_rng(cap)
    tr = _zipf_trace(rng, 300, 12000, a=1.05)
    carry = ttree.init_tree_lru_carry(300, cap, ring=ring, device="cpu")
    host, at, launched, due = carry.host, 0, 0, 0
    while at < len(tr):
        window = int(rng.integers(1, ttree.max_window(ring) + 1))
        ids = torch.from_numpy(tr[at:at + window])
        pos = int(carry.pos)
        assert host.pos_lo <= pos <= host.pos_hi
        maybe, certain = host.pos_hi + ids.numel() > ring, host.pos_lo + ids.numel() > ring
        is_due = pos + ids.numel() > ring
        assert (not is_due or maybe) and (not certain or is_due)
        launched, due = launched + maybe, due + is_due
        lo, hi = ttree.lru_bounds(host, ids.numel(), ring)
        host = host._replace(pos_lo=lo, pos_hi=hi)
        carry, _ = ttree.tree_chunk("lru", carry, ids)
        at += window
    assert due >= 10 and launched >= due


@pytest.mark.parametrize("kind", AUTOMATA)
def test_padded_slots_equal_the_reference(kind):
    """n_slots > capacity: inactive slots (-2, keys I32_MAX) never win and
    are never written; the LRU's ring sizes by n_slots."""
    jc = jtree.init_tree_engine_carry(kind, N, C, n_slots=C + 50, seed=2, horizon=T)
    port, _ = _chunk_by_chunk(kind, jc, TRACES["zipf"], 500)
    if kind != "lru":
        assert bool((port.slots[C:] == -2).all())
        assert bool((port.tree_hi[C:C + 50] == tops.I32_MAX).all())


@pytest.mark.parametrize("window", [16, 250])
@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("kind", AUTOMATA)
def test_tree_engine_equals_the_dense_automaton(kind, trace, window):
    tr = TRACES[trace]
    rt = repro_torch.run(repro_torch.policy_def(kind), tr, N, C, window=window, seed=3,
                         device="cpu")
    rd = repro_torch.run(repro_torch.policy_def(kind, impl="dense"), tr, N, C, window=window,
                         seed=3, device="cpu")
    np.testing.assert_array_equal(rt.hits, rd.hits)
    np.testing.assert_array_equal(rt.occupancy, rd.occupancy)
    assert isinstance(rt.carry, (ttree.TreeLRUCarry, ttree.TreeLFUCarry, ttree.TreeFTPLCarry))


def test_tree_lru_matches_the_stack_distance_oracle():
    rng = np.random.default_rng(0)
    tr, n, c = _zipf_trace(rng, 120, 1500), 120, 11
    r = repro_torch.run(repro_torch.policy_def("lru"), tr, n, c, window=50, device="cpu")
    oracle = stack_distance_hits_ref(tr, c)
    np.testing.assert_array_equal(oracle, j_stack_distance(tr, c))
    np.testing.assert_array_equal(r.hits, oracle.reshape(-1, 50).sum(1))


@pytest.mark.parametrize("kind", AUTOMATA)
def test_tree_run_resumes_bit_for_bit(kind):
    """Two chunked runs replay one run; and the carry after the same
    requests does not depend on the window they came in."""
    tr = TRACES["zipf"]
    pd = repro_torch.policy_def(kind)
    whole = repro_torch.run(pd, tr, N, C, window=16, seed=1, horizon=T, device="cpu")
    first = repro_torch.run(pd, tr[:2992], N, C, window=16, seed=1, horizon=T, device="cpu")
    kept = [x.clone() for x in _tensors(first.carry)]
    second = repro_torch.run(pd, tr[2992:], capacity=C, window=16, carry=first.carry,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tensors(first.carry), kept))  # not modified
    np.testing.assert_array_equal(np.concatenate([first.hits, second.hits]), whole.hits)
    for a, b in zip(_tensors(second.carry), _tensors(whole.carry)):
        assert torch.equal(a, b)
    by_window = [repro_torch.run(pd, tr[2992:4992], capacity=C, window=w, carry=first.carry,
                                 device="cpu") for w in (16, 250, 2000)]
    for r in by_window[1:]:
        assert r.hits.sum() == by_window[0].hits.sum()
        for a, b in zip(_tensors(r.carry), _tensors(by_window[0].carry)):
            assert torch.equal(a, b)


def test_init_matches_the_reference():
    for kind in AUTOMATA:
        for n_slots in (None, 100):
            want = jtree.init_tree_engine_carry(kind, N, C, n_slots=n_slots, seed=4, horizon=T)
            got = ttree.init_tree_engine_carry(kind, N, C, n_slots=n_slots, seed=4, horizon=T,
                                               device="cpu")
            _check_carry(got, want, f"{kind} init n_slots={n_slots}")
    got = ttree.init_tree_lru_carry(N, C, ring=256, device="cpu")
    _check_carry(got, jtree.init_tree_lru_carry(N, C, ring=256), "lru ring 256")
    with pytest.raises(ValueError, match="power of two"):
        ttree.init_tree_lru_carry(N, C, ring=64, device="cpu")
    with pytest.raises(ValueError, match="zeta or horizon"):
        ttree.init_tree_ftpl_carry(N, C, device="cpu")


def test_geometry_helpers_match_the_reference():
    assert ttree.TREE_ENGINE_KINDS == jtree.TREE_ENGINE_KINDS
    assert (ttree.RING_RADIX, ttree.SLOT_RADIX, ttree.MAX_SUBCHUNK) == (
        jtree.RING_RADIX, jtree.SLOT_RADIX, jtree.MAX_SUBCHUNK)
    for k in (1, 23, 16384, 16385, 50000, 10**6):
        assert ttree.ring_size(k) == jtree.ring_size(k)
    for w in range(1, 400):
        assert ttree._pick_subchunk(w) == jtree._pick_subchunk(w)
    m = ttree.ring_for_window(50000, 10**6)
    assert m == 2**21 and 10**6 <= 3 * m // 4 - 16 < 2 * 10**6
    assert ttree.ring_for_window(1000, 10000) == jtree.ring_size(1000)
    with pytest.raises(ValueError, match="too large for ring"):
        repro_torch.run(repro_torch.policy_def("lru"), TRACES["zipf"], N, C, window=200,
                        ring=256, device="cpu")


def test_carry_from_numpy_takes_the_tree_carries():
    for kind, cls in (("lru", ttree.TreeLRUCarry), ("lfu", ttree.TreeLFUCarry),
                      ("ftpl", ttree.TreeFTPLCarry)):
        jc = jtree.init_tree_engine_carry(kind, N, C, seed=0, horizon=T)
        got = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
        assert type(got) is cls and got.catalog_size == N
        _check_carry(got, jc, kind)


# -- the trees -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 15, 16, 17, 256, 4097, 65536])
def test_int32_count_trees_match_the_reference(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 3, n).astype(np.int32)
    want = np.asarray(jops.tree_build(jnp.asarray(leaves), 16))
    tree = tops.tree_build(torch.from_numpy(leaves), 16)
    assert tree.dtype == torch.int32
    np.testing.assert_array_equal(tree.numpy(), want)
    q = rng.integers(-1, n, 64).astype(np.int32)
    got = tops.tree_prefix(tree, n, 16, torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.tree_prefix(jnp.asarray(want), n,
                                                                           16, jnp.asarray(q))))
    idx = rng.integers(-1, n, 40).astype(np.int32)
    delta = rng.integers(-2, 3, 40).astype(np.int32)
    want_u = np.asarray(jops.tree_update(jnp.asarray(want), n, 16, jnp.asarray(idx),
                                         jnp.asarray(delta)))
    got_u = tops.tree_update(tree, n, 16, torch.from_numpy(idx), torch.from_numpy(delta))
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(tree.numpy(), want)  # the functional form copies
    assert int(tops.tree_total(got_u, n, 16)) == int(jops.tree_total(jnp.asarray(want_u), n, 16))
    if n > 16:
        assert tops.leaves_for_storage(tops.tree_storage(1 << n.bit_length(), 16), 16) \
            == jops.leaves_for_storage(jops.tree_storage(1 << n.bit_length(), 16), 16)


def test_float_tree_build_is_unchanged():
    """The float32 tree is what it was: each level float32 sums of the one
    below, in torch's order (the JAX reference sums in its own order)."""
    rng = np.random.default_rng(7)
    leaves = torch.from_numpy(rng.random(5000).astype(np.float32))
    got = tops.tree_build(leaves, 64)
    assert got.dtype == torch.float32
    parts, cur = [leaves], leaves
    for size in tops.tree_sizes(5000, 64)[1:]:
        cur = torch.nn.functional.pad(cur, (0, size * 64 - cur.shape[0])).reshape(size, 64).sum(1)
        parts.append(cur)
    assert torch.equal(got, torch.cat(parts))
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.tree_build(jnp.asarray(leaves.numpy()),
                                                                       64)), rtol=1e-6)
    out = torch.empty_like(got)
    assert tops.tree_build(leaves, 64, out=out) is out
    assert torch.equal(out, got)


def test_sortable_f32_matches_the_reference():
    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 7.25, np.inf], np.float32)
    got = tops.sortable_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.sortable_f32(jnp.asarray(x))))
    assert (np.diff(got) >= 0).all() and got[3] == got[4]


@pytest.mark.parametrize("k", [5, 64, 65, 130, 4096, 5000])
def test_minpair_trees_match_the_reference(k):
    """Ties are dense (hi, lo in a narrow range) so the first-index rule and
    the partial last group decide; inactive slots hold (I32_MAX, I32_MAX)."""
    rng = np.random.default_rng(k)
    hi = rng.integers(-1, 3, k).astype(np.int32)
    lo = rng.integers(-1, 2, k).astype(np.int32)
    hi[k - k // 4:], lo[k - k // 4:] = tops.I32_MAX, tops.I32_MAX
    jh, jl = jops.minpair_build(jnp.asarray(hi), jnp.asarray(lo), 64)
    th, tl = tops.minpair_build(torch.from_numpy(hi), torch.from_numpy(lo), 64)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for _ in range(20):
        root = tops.minpair_root(th, tl, k, 64)
        want_root = jops.minpair_root(jh, jl, k, 64)
        assert (int(root[0]), int(root[1])) == (int(want_root[0]), int(want_root[1]))
        arg = int(tops.minpair_argmin(th, tl, k, 64))
        assert arg == int(jops.minpair_argmin(jh, jl, k, 64))
        i, h, lo_ = int(rng.integers(0, k)), int(rng.integers(-1, 4)), int(rng.integers(-1, 3))
        plan = tops.minpair_update_plan(th, tl, k, 64, torch.tensor(i), torch.tensor(h),
                                        torch.tensor(lo_))
        want_plan = jops.minpair_update_plan(jh, jl, k, 64, jnp.int32(i), jnp.int32(h),
                                             jnp.int32(lo_))
        for a, b in zip(plan, want_plan):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        th, tl = tops.minpair_update(th, tl, k, 64, i, h, lo_)
        jh, jl = jops.minpair_update(jh, jl, k, 64, jnp.int32(i), jnp.int32(h), jnp.int32(lo_))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
