"""The facts the redesigned automaton kernels rest on, held on the CPU.

* A hit never lowers its slot's (hi, lo) pair, request by request, in the
  reference's tree LFU, FTPL and GDS (``repro.cachesim.tree_engines``, one
  request a chunk) and in the port's plain versions; and where the hit
  slot is not its level-1 node's least leaf, no node above the leaves
  changes.  So the ``minpair_automaton`` kernel writes such a hit's leaf
  alone.
* Every node's least leaf (``least_leaves``, the pointers the kernel keeps
  beside the upper levels) against brute force over the node's leaves, and
  the root's against the reference's ``minpair_argmin``, with ties, empty
  and padded slots.
* ``unsortable_f32`` returns every GDS key's H bit for bit through a
  ``sized_cdn`` mini run, and after each eviction L is the victim's
  decoded hi: the kernel's GDS mode reads no H at an eviction.
* The tree LRU's chunk computed as the ``tree_lru`` kernel does (a table
  of each sub-chunk's ids, ``tree_lru_blocked_ref``) against the port's
  plain version and the reference's ``make_lru_tree_chunk``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import tree_engines as jtree
from repro.kernels.prefix_tree import ops as jops
import repro_torch
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.cachesim.scenarios import get_scenario
from repro_torch.kernels.minpair_automaton.ref import SLOT_RADIX, least_leaves, unsortable_f32
from repro_torch.kernels.prefix_tree.ops import minpair_build, sortable_f32
from repro_torch.kernels.prefix_tree.ref import tree_offsets, tree_sizes
from repro_torch.kernels.tree_lru.ref import tree_lru_blocked_ref, tree_lru_ref

I32_MAX = 2**31 - 1
SLABS = np.asarray([1.0, 4.0, 16.0, 64.0])


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _init(kind, n, c, seed):
    if kind == "gds":
        rng = np.random.default_rng(seed)
        sizes = SLABS[rng.integers(0, 4, n)]
        costs = np.asarray([0.5, 1.0, 2.0, 4.0])[rng.integers(0, 4, n)]
        return jtree.init_tree_gds_carry(n, c, sizes=sizes, costs=costs)
    return jtree.init_tree_engine_carry(kind, n, c, seed=seed, horizon=400)


def _trace(n, t, seed):
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.1, size=4 * t) - 1
    return rng.permutation(n)[ranks[ranks < n][:t]].astype(np.int32)


@pytest.mark.parametrize("c", [23, 100])
@pytest.mark.parametrize("kind", ["lfu", "ftpl", "gds"])
def test_a_hit_never_lowers_its_slots_pair(kind, c):
    n = 4 * c
    trace = _trace(n, 400, c)
    jc = _init(kind, n, c, seed=c)
    step = jax.jit(jtree.make_tree_chunk(kind, jc))
    tc = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
    k = int(tc.slots.numel())
    hits = skipped = 0
    for r, j in enumerate(trace.tolist()):
        slot = int(tc.imap[j])
        before = (int(tc.tree_hi[slot]), int(tc.tree_lo[slot])) if slot >= 0 else None
        upper = (tc.tree_hi[k:].clone(), tc.tree_lo[k:].clone())
        pointers, root = least_leaves(tc.tree_hi, tc.tree_lo, k)
        root_pair = (int(tc.tree_hi[root]), int(tc.tree_lo[root]))
        ids = np.asarray([j], np.int32)
        jc, _ = step(jc, jnp.asarray(ids))
        tc, (h, _) = ttree.tree_chunk(kind, tc, torch.from_numpy(ids))
        assert int(h) == (slot >= 0), f"request {r}"
        for name, want in _leaves(jc).items():
            np.testing.assert_array_equal(getattr(tc, name).numpy(), want,
                                          err_msg=f"{name} after request {r}")
        if slot < 0:
            continue
        hits += 1
        after = (int(tc.tree_hi[slot]), int(tc.tree_lo[slot]))
        assert after >= before, f"request {r}: the hit lowered slot {slot}'s pair"
        least = root if k <= SLOT_RADIX else int(pointers[k + (slot >> 6)])
        if slot != least:  # the rule: nothing above the leaf changes
            skipped += 1
            assert torch.equal(tc.tree_hi[k:], upper[0]) and torch.equal(tc.tree_lo[k:], upper[1])
            _, root_after = least_leaves(tc.tree_hi, tc.tree_lo, k)
            assert root_after == root
            assert (int(tc.tree_hi[root]), int(tc.tree_lo[root])) == root_pair
    assert hits > 50 and skipped > 0


def _brute_least_leaves(hi, lo, k):
    """Each node's first leaf holding its pair, over the node's leaf range."""
    offs, sizes = tree_offsets(k, SLOT_RADIX), tree_sizes(k, SLOT_RADIX)
    out = []
    for lvl, (off, size) in enumerate(zip(offs, sizes)):
        span = SLOT_RADIX ** lvl
        for x in range(size):
            pair = (hi[off + x], lo[off + x])
            leaves = range(x * span, min((x + 1) * span, k))
            out.append(next(q for q in leaves if (hi[q], lo[q]) == pair))
    return out


@pytest.mark.parametrize("k", [23, 64, 65, 4097])
def test_least_leaves_match_brute_force_and_the_reference(k):
    rng = np.random.default_rng(k)
    hi = rng.integers(0, 4, k).astype(np.int32)  # few values: ties at every level
    lo = rng.integers(0, 3, k).astype(np.int32)
    empty = rng.random(k) < 0.2
    hi[empty], lo[empty] = -1, -1
    pad = k - max(k // 8, 1)  # the last eighth inactive, as padded n_slots
    hi[pad:], lo[pad:] = I32_MAX, I32_MAX
    th, tl = minpair_build(torch.from_numpy(hi), torch.from_numpy(lo), SLOT_RADIX)
    jh, jl = jops.minpair_build(jnp.asarray(hi), jnp.asarray(lo), SLOT_RADIX)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    pointers, root = least_leaves(th, tl, k)
    assert pointers.tolist() == _brute_least_leaves(th.tolist(), tl.tolist(), k)
    assert root == int(jops.minpair_argmin(jh, jl, k, SLOT_RADIX))
    assert (int(th[root]), int(tl[root])) == min(zip(hi.tolist(), lo.tolist()))


@pytest.mark.parametrize("values", ["finite", "edges"])
def test_unsortable_inverts_sortable(values):
    rng = np.random.default_rng(7)
    if values == "finite":
        x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500),
                            rng.random(500) * 1e6]).astype(np.float32)
    else:
        x = np.asarray([0.0, np.inf, -np.inf, 1e-45, -1e-45, np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, 1.0, -1.0], np.float32)
    got = unsortable_f32(sortable_f32(torch.from_numpy(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), x.view(np.int32))
    # -0.0 comes back as +0.0: the kernel reads such an H from hval
    assert unsortable_f32(sortable_f32(torch.tensor([-0.0]))).view(torch.int32).item() == 0


@pytest.mark.parametrize("mode", ["every chunk", "every request"])
def test_gds_keys_decode_to_their_h_in_sized_cdn_mini(mode):
    sc = get_scenario("sized_cdn")
    n, t, c = sc.dims("mini")
    trace = sc.make_trace("mini").astype(np.int32)
    carry = ttree.init_tree_gds_carry(n, c, sizes=sc.make_sizes("mini"), device="cpu")
    if mode == "every chunk":
        w = max(t // 20, 1)
        parts = [trace[i:i + w] for i in range(0, len(trace), w)]
    else:
        parts = [trace[i:i + 1] for i in range(1500)]
    evictions = 0
    for part in parts:
        before = carry.slots.clone()
        victim_hi = None
        if len(part) == 1 and int(carry.imap[int(part[0])]) < 0:
            _, root = least_leaves(carry.tree_hi, carry.tree_lo, c)
            victim_hi = carry.tree_hi[root].clone() if int(carry.slots[root]) >= 0 else None
        carry, _ = ttree.tree_chunk("gds", carry, torch.from_numpy(part))
        filled = carry.slots >= 0
        decoded = unsortable_f32(carry.tree_hi[:c][filled])
        assert torch.equal(decoded.view(torch.int32), carry.hval[filled].view(torch.int32))
        if victim_hi is not None:
            evictions += 1
            assert bool((carry.slots != before).any())
            assert unsortable_f32(victim_hi).view(torch.int32).item() == \
                carry.L.view(torch.int32).item()
    if mode == "every request":
        assert evictions > 100
    assert float(carry.L) > 0.0


def _lru_traces():
    rng = np.random.default_rng(42)
    return {"zipf": _trace(400, 6000, 42),
            "cyclic": np.tile(np.arange(50), 120).astype(np.int32),
            "bursty": np.concatenate([np.repeat(rng.integers(0, 400, 40), 30)
                                      for _ in range(5)]).astype(np.int32)}


LRU_TRACES = _lru_traces()


@pytest.mark.parametrize("sub", [16, 256])
@pytest.mark.parametrize("window", [250, 700])
@pytest.mark.parametrize("trace", sorted(LRU_TRACES))
def test_tree_lru_as_the_kernel_computes_it(trace, window, sub):
    """Chunk by chunk from the reference's carry: the blocked version, the
    port's plain version and the reference, every carry leaf, the hits and
    the flags; the ring of 2048 compacts along the way."""
    tr = LRU_TRACES[trace]
    jc = jtree.init_tree_lru_carry(400, 23, ring=2048)
    ref = jax.jit(jtree.make_tree_chunk("lru", jc, True))
    blocked = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
    plain = repro_torch.carry_from_numpy(_leaves(jc), "cpu")
    m, compactions = 2048, 0
    for i in range(len(tr) // window):
        ids = tr[i * window:(i + 1) * window]
        compactions += int(plain.pos) + window > m
        jc, (jflags, _) = ref(jc, jnp.asarray(ids))
        fb = torch.empty(window, dtype=torch.bool)
        fp = torch.empty(window, dtype=torch.bool)
        hb, sb = tree_lru_blocked_ref(blocked.tree, blocked.last, blocked.pos, blocked.nseen,
                                      blocked.cap, torch.from_numpy(ids), m, fb, sub=sub)
        hp, sp = tree_lru_ref(plain.tree, plain.last, plain.pos, plain.nseen, plain.cap,
                              torch.from_numpy(ids), m, fp)
        np.testing.assert_array_equal(fb.numpy(), np.asarray(jflags), err_msg=f"chunk {i}")
        assert torch.equal(fb, fp) and int(hb) == int(hp) and torch.equal(sb, sp)
        for name, want in _leaves(jc).items():
            np.testing.assert_array_equal(getattr(blocked, name).numpy(), want,
                                          err_msg=f"{name} after chunk {i}")
            assert torch.equal(getattr(blocked, name), getattr(plain, name))
    assert compactions >= 1
