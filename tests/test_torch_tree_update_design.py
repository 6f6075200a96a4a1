"""The card's batched tree update, its plan emulated in numpy, on the CPU.

``csrc/tree_update.cu`` runs a block a level: it stages the call's deltas
(each one's key, row * size + its node at the level, or -1), hashes the keys
into a table, where each new key takes the next slot, gives each slot's run
its start, scatters the deltas into runs by slot, sums each run alone and
writes each touched node once.  Where every float64 partial sum is exact
(decided for the whole call from the deltas' exponents) the runs take the
deltas in any order, a long run on a warp (each lane a strided share, then
a butterfly of shuffles); else the deltas keep input order in their runs
and a thread walks each run.  ``_emulate`` below does the same steps, the
order of every add included, and is held bit for bit against the port's
plain versions (``stacked_tree_update_ref``, ``tree_update_ref``), which the
card is held to on the card (tests/test_torch_cuda.py, chip_smoke.py).  In
the any-order case it scatters the deltas in an order unlike the input's
(the card's order follows its atomics), so an exact rule that let through a
case where order matters would show here.

The port's CPU ``stacked_tree_update_`` is also held bit for bit against the
reference's ``_stacked_tree_update`` on integer-valued deltas, the count
trees' (ycnt, dcnt), at a sized chunk the port makes from the reference's
own carry.  Inputs are made with numpy from a seed.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.cachesim import tree_engines as jtree
from repro.cachesim.api import policy_def as jpolicy_def
from repro_torch.cachesim import tree_engines as ttree
from repro_torch.kernels.prefix_tree import ops, ref

CSRC = pathlib.Path(ops.__file__).resolve().parent / "csrc" / "tree_update.cu"
SOURCE = CSRC.read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE).group(1))
LONG_RUN = int(re.search(r"constexpr int kLongRun = (\d+);", SOURCE).group(1))
KEYS_PER_BLOCK = int(re.search(r"constexpr int kKeysPerBlock = (\d+);", SOURCE).group(1))
MAX_PARTS = int(re.search(r"constexpr int kMaxParts = (\d+);", SOURCE).group(1))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def table_bits(q):
    b = 10
    while (1 << b) < 2 * q:
        b += 1
    return b


def _exponents(delta, adds):
    """(lo, hi, count) of the deltas that add, as step A reduces them."""
    bits = delta[adds].view(np.uint32)
    field = (bits >> 23) & 0xFF
    nonzero = (bits & 0x7FFFFFFF) != 0
    lo = int(max(field[nonzero].min(), 1)) if nonzero.any() else 255
    hi = int(field[nonzero].max()) if nonzero.any() else 0
    return lo, hi, int(adds.sum())


def _exact(delta, adds):
    """The kernel's rule for the whole call (step A)."""
    if delta.dtype != np.float32:
        return True
    lo, hi, count = _exponents(delta, adds)
    log2_count = (count - 1).bit_length() if count > 1 else 0
    return hi < 255 and hi - lo <= 29 - log2_count


def _insert(tkey, key):
    bits = len(tkey).bit_length() - 1
    h = ((key * 2654435769) & 0xFFFFFFFF) >> (32 - bits)
    while tkey[h] not in (-1, key):
        h = (h + 1) & (len(tkey) - 1)
    tkey[h] = key
    return h


def _butterfly(lanes):
    """The 32 lane sums added by shuffles: xor 16, 8, 4, 2, 1; lane 0's."""
    lanes = list(lanes)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    return lanes[0]


def _emulate(trees, n, radix, rows, idx, delta):
    """One launch, block by block (a key lies in one block of its level, so
    the split changes no sum).  ``trees``: (K, TOT) or a flat tree (rows
    None).  Returns the updated copy and {level: (keys, writes)}."""
    flat = trees.reshape(-1).copy()
    n_rows, stride = (trees.shape[0], trees.shape[1]) if rows is not None else (1, trees.size)
    sh = radix.bit_length() - 1
    q = len(idx)
    # A. stage: the key a level (one rule every level) and the order
    leaf = idx.astype(np.int64)
    row = rows.astype(np.int64) if rows is not None else np.zeros(q, np.int64)
    adds = (leaf >= 0) & (leaf < n) & (row >= 0) & (row < n_rows)
    exact = _exact(delta, adds)
    stats = {}
    for level, (off, size) in enumerate(zip(ref.tree_offsets(n, radix), ref.tree_sizes(n, radix))):
        # the level's blocks: a block a KEYS_PER_BLOCK of the most keys it
        # can have, each taking the keys k with k % parts == its index
        parts = min(max(-(-min(q, n_rows * size) // KEYS_PER_BLOCK), 1), MAX_PARTS)
        keys = np.where(adds, row * size + (leaf >> (sh * level)), -1)
        stats[level] = (0, 0)
        for part in range(parts):
            key = np.where((keys >= 0) & (keys % parts == part), keys, -1)
            flat, (n_keys, writes) = _block(flat, key, delta, exact, size, off, stride)
            stats[level] = (stats[level][0] + n_keys, stats[level][1] + writes)
    return flat.reshape(trees.shape), stats


def _block(flat, key, delta, exact, size, off, stride):
    """One block: the deltas of its keys (key >= 0) hashed, sorted into runs,
    summed and written.  Returns the tree and (keys, writes)."""
    q = len(key)
    acc = np.float64 if delta.dtype == np.float32 else np.int64
    adds = key >= 0
    tkey = np.full(1 << table_bits(q), -1, np.int64)
    hidx = np.full(q, -1)
    for p in np.flatnonzero(adds):
        hidx[p] = _insert(tkey, int(key[p]))
    # B. a slot a key, in the order the keys were first inserted (on the
    # card the order of the atomics), each run's start (the card's runs
    # lie in any order: each is summed alone)
    occupied = np.asarray(list(dict.fromkeys(hidx[hidx >= 0].tolist())), np.int64)
    slot_of = np.full(len(tkey), -1)
    slot_of[occupied] = np.arange(len(occupied))
    counts = np.bincount(hidx[hidx >= 0], minlength=len(tkey))[occupied]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    # C. scatter: in input order where order matters; else in an order
    # unlike it (the 1024-delta rounds from the last, lanes reversed)
    if exact:
        order = np.concatenate([np.arange(b, min(b + THREADS, q))[::-1]
                                for b in range(0, q, THREADS)][::-1])
    else:
        order = np.arange(q)
    run = np.zeros(q, delta.dtype)
    cursor = start.copy()
    for p in order:
        if hidx[p] >= 0:
            s = slot_of[hidx[p]]
            run[cursor[s]] = delta[p]
            cursor[s] += 1
    # D. each run summed alone, its node written once
    writes = 0
    for k, c, b in zip(tkey[occupied], counts, start):
        part = run[b:b + c].astype(acc)
        if exact and c >= LONG_RUN:
            total = _butterfly(
                sum(part[lane::32], acc(0)) if acc is np.int64 else
                _chain(part[lane::32]) for lane in range(32))
        else:
            total = _chain(part) if acc is np.float64 else int(part.sum())
        a = (k // size) * stride + off + k % size
        if acc is np.float64:
            flat[a] = np.float32(np.float64(flat[a]) + total)
        else:
            flat[a] = np.int32(((int(flat[a]) + int(total) + 2**31) % 2**32) - 2**31)
        writes += 1
    return flat, (len(occupied), writes)


def _chain(values):
    """float64 adds one by one from +0.0, as a thread walks a run."""
    s = np.float64(0.0)
    for v in values:
        s = s + v
    return s


def _plain(trees, n, radix, rows, idx, delta):
    if rows is None:
        return ref.tree_update_ref(_t(trees.copy()), n, radix, _t(idx), _t(delta)).numpy()
    return ref.stacked_tree_update_ref(_t(trees.copy()), n, radix, _t(rows), _t(idx),
                                       _t(delta)).numpy()


def _wide(rng, size):
    """float32 deltas over twelve decades, half of them negative."""
    return (rng.standard_normal(size) * 10.0 ** rng.uniform(-8, 4, size)).astype(np.float32)


def _case(name, rng):
    """(trees, n, radix, rows or None, idx, delta) of one call."""
    kk, v, q = 4, 65536, 2000
    stacked = ref.tree_build_ref(_t(np.zeros(v, np.float32)), 64).numel()
    base = (rng.random((kk, stacked)) * 50).astype(np.float32)
    rows = rng.integers(0, kk, q)
    masked = rng.random(q) < 0.25
    if name in ("sized counts", "sized values"):  # a sized chunk's bucket moves
        idx = np.where(masked, -1, rng.integers(0, 400, q) * 97)
        delta = (rng.choice([-1.0, 1.0], q) if name == "sized counts"
                 else rng.uniform(-3, 3, q)).astype(np.float32)
        return base, v, 64, rows, idx, delta
    if name == "one node":  # a run of 2000 under one leaf of one tree
        return base, v, 64, np.full(q, 2), np.full(q, 40_000), rng.uniform(-2, 2, q).astype(
            np.float32)
    if name == "int32 scattered":  # over 262 144 leaves at radix 16, nodes near the wrap
        m = 262_144
        tree = ref.tree_build_ref(_t(rng.integers(0, 2, m).astype(np.int32)), 16).numpy()
        tree[m:] = np.int32(2**31 - 20)
        return tree, m, 16, None, rng.integers(-1, m, q), rng.integers(-9, 10, q).astype(
            np.int32)
    if name == "twelve decades":  # input order: +-1e8 cancelling around deltas of 12 decades
        groups = q // 4  # (+1e8, small, -1e8, small) under one (row, leaf) a group
        where = rng.integers(0, 16, groups)
        small = _wide(rng, 2 * groups) * np.float32(1e-6)
        delta = np.stack([np.full(groups, 1e8, np.float32), small[:groups],
                          np.full(groups, -1e8, np.float32), small[groups:]]).T.reshape(-1)
        return np.zeros_like(base), v, 64, np.repeat(where % kk, 4), \
            np.repeat((where // kk) * 4099, 4), delta
    if name == "nan and infinity":  # input order: NaN and inf travel their paths
        delta = rng.uniform(-1, 1, q).astype(np.float32)
        delta[[5, 900]] = np.nan
        delta[[77, 1500]] = [np.inf, -np.inf]
        return base, v, 64, rows, rng.integers(0, 2000, q) * 31, delta
    if name == "out of range":  # ids past the leaves, rows past the trees
        idx = rng.integers(-5, v + 5, q)
        idx[:40] = v + np.arange(40)
        bad_rows = rng.integers(-2, kk + 2, q)
        return base, v, 64, bad_rows, idx, rng.uniform(-2, 2, q).astype(np.float32)
    raise KeyError(name)


def _edge(rng, count, spread):
    """``count`` deltas under one leaf whose exponents span exactly
    ``spread``, and whose every partial sum is exact iff ``spread`` <= 29 -
    log2(count) (top magnitudes at the lowest exponent's 2^spread)."""
    e0 = int(rng.integers(60, 150))
    field = np.concatenate([[e0, e0 + spread], rng.integers(e0, e0 + spread + 1, count - 2)])
    bits = (field.astype(np.uint32) << 23) | np.uint32(0x7FFFFF)
    delta = bits.view(np.float32) * np.where(np.arange(count) % 2, 1, -1).astype(np.float32)
    return delta


CASES = ["sized counts", "sized values", "one node", "int32 scattered", "twelve decades",
         "nan and infinity", "out of range"]


@pytest.mark.parametrize("name", CASES)
def test_the_plan_gives_the_plain_versions_bits(name):
    rng = np.random.default_rng(CASES.index(name))
    trees, n, radix, rows, idx, delta = _case(name, rng)
    got, stats = _emulate(trees, n, radix, rows, idx, delta)
    want = _plain(trees, n, radix, rows, idx, delta)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    order = ops.update_order(n, _t(idx), _t(delta), None if rows is None else _t(rows),
                             trees.shape[0] if rows is not None else 1)
    expected = ops.INPUT_ORDER if name in ("twelve decades", "nan and infinity") else \
        ops.EXACT_ANY_ORDER
    assert order == expected
    # one write a touched node, none elsewhere
    assert all(keys == writes for keys, writes in stats.values())
    changed = int((got.view(np.uint32) != trees.view(np.uint32)).sum())
    assert 0 < changed <= sum(keys for keys, _ in stats.values())
    if name == "one node":
        assert all(keys == 1 for keys, _ in stats.values())
    if name == "int32 scattered":
        assert bool((got[262_144:] < 0).any())  # some node wrapped past 2^31 - 1


@pytest.mark.parametrize("count", [2, 33, 2000, 4097])
def test_the_exactness_rule_at_its_edge(count):
    """At hi - lo = 29 - log2(count) every partial sum is exact: the
    kernel adds in any order (a long run on a warp's strided lanes), and
    the bits are the input order's; one exponent past it, the rule takes
    input order."""
    rng = np.random.default_rng(count)
    limit = 29 - (count - 1).bit_length()
    tree = ref.tree_build_ref(_t(np.zeros(64, np.float32)), 8).numpy()
    idx = np.full(count, 5)
    for spread, order in ((limit, ops.EXACT_ANY_ORDER), (limit + 1, ops.INPUT_ORDER)):
        delta = _edge(rng, count, spread)
        assert ops.update_order(64, _t(idx), _t(delta)) == order
        got, _ = _emulate(tree, 64, 8, None, idx, delta)
        np.testing.assert_array_equal(got, _plain(tree, 64, 8, None, idx, delta))
    # the exact sum's any orders agree: lane shares and reversed
    delta = _edge(rng, count, limit).astype(np.float64)
    assert _chain(delta) == _chain(delta[::-1])
    assert _chain(delta) == _butterfly(_chain(delta[lane::32]) for lane in range(32))


def test_past_the_limit_the_order_shows():
    """Deltas one exponent past the edge whose sum depends on the order:
    the rule must not let them add in any order."""
    delta = np.array([2.0**24, 1.0, -(2.0**24), 2.0**-29] * 8, np.float32)
    assert ops.update_order(1, _t(np.zeros(32, np.int64)), _t(delta)) == ops.INPUT_ORDER
    d = delta.astype(np.float64)
    assert _chain(d) != _butterfly(_chain(d[lane::32]) for lane in range(32))


def test_update_order_counts_only_what_adds():
    """A row or an id out of range adds nothing, so its delta counts in no
    sum and in no rule."""
    idx = _t(np.array([0, 0, 5, 0], np.int64))
    delta = _t(np.array([1.0, np.nan, np.inf, 2.0**-100], np.float32))
    rows = _t(np.array([0, 4, 0, -1], np.int64))
    assert ops.update_order(4, idx, delta, rows, 4) == ops.EXACT_ANY_ORDER
    assert ops.update_order(4, idx, delta) == ops.INPUT_ORDER
    assert ops.update_order(4, idx, _t(np.array([1, 2, 3, 4], np.int32))) == ops.EXACT_ANY_ORDER


def test_constants_mirror_the_source():
    assert ops.ON_CHIP_DELTAS == int(re.search(r"constexpr int kOnChipDeltas = (\d+);",
                                               SOURCE).group(1))
    assert (KEYS_PER_BLOCK, MAX_PARTS) == (512, 8)  # ops.UPDATE_DESIGN names them
    assert "1-8 blocks a level (a block a 512 of its possible nodes)" in ops.UPDATE_DESIGN
    assert ops.MAX_UPDATE_DELTAS == 2 ** int(re.search(
        r"constexpr long long kMaxDeltas = 1LL << (\d+);", SOURCE).group(1))
    # the shared-memory workspace of the most deltas fits a block's 227 KB
    q = ops.ON_CHIP_DELTAS
    assert 4 * (2 * (1 << table_bits(q)) + 7 * q) <= 232_448 - 1024


def _reference_chunk_updates(n, window, seed):
    """The three stacked tree updates of one sized chunk of the port, from
    the reference's own carry (its Poisson p made under
    jax.threefry_partitionable(False)) over a zipf trace: [(trees, v,
    radix, rows, idx, delta)] for ycnt, ysum, dcnt."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[rng.integers(0, 4, n)]
    cap = float(round(0.05 * n * sizes.mean()))
    with jax.threefry_partitionable(False):
        jc = jpolicy_def("ogb_sized").init(n, cap, seed=0, eta=None, horizon=20 * window,
                                           sizes=sizes)
    leaves = {k: np.asarray(v) for k, v in jc._asdict().items()}
    tc = ttree.start_sized_run(repro_torch.carry_from_numpy(leaves, "cpu"))
    step = ttree.make_sized_ogb_tree_chunk(jtree.OGB_TREE_BUCKETS, ttree.OGB_TREE_RADIX,
                                           "poisson")
    ids = (rng.zipf(1.3, size=window) % n).astype(np.int32)
    calls, real = [], ttree.stacked_tree_update_

    def record(trees, v, radix, rows, idx, delta):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x
                           for x in (trees, v, radix, rows, idx, delta)))
        return real(trees, v, radix, rows, idx, delta)

    ttree.stacked_tree_update_ = record
    try:
        step(tc, torch.from_numpy(ids))
    finally:
        ttree.stacked_tree_update_ = real
    assert len(calls) == 3
    return calls


@pytest.mark.parametrize("tree", ["ycnt", "dcnt"])
def test_the_ports_stacked_update_is_the_references_on_integer_deltas(tree):
    """ycnt's and dcnt's deltas are +-1: every float32 add of the
    reference's scatter-add is exact, so its tree and the port's float64
    sums rounded once are the same bits; the plan's emulation too."""
    calls = _reference_chunk_updates(20_000, 1000, 5)
    trees, v, radix, rows, idx, delta = calls[{"ycnt": 0, "dcnt": 2}[tree]]
    assert set(np.unique(delta.numpy())) <= {-1.0, 1.0} and int((idx >= 0).sum()) > 0
    want = np.asarray(jtree._stacked_tree_update(jnp.asarray(trees.numpy()), v, radix,
                                                 jnp.asarray(rows.numpy()),
                                                 jnp.asarray(idx.numpy()),
                                                 jnp.asarray(delta.numpy())))
    got = ops.stacked_tree_update_(trees.clone(), v, radix, rows, idx, delta).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    emulated, _ = _emulate(trees.numpy(), v, radix, rows.numpy(), idx.numpy(), delta.numpy())
    np.testing.assert_array_equal(emulated.view(np.uint32), want.view(np.uint32))
