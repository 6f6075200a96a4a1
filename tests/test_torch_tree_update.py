"""The prefix tree's two sums, and the chunk's request count, on the CPU.

On a CPU tensor ``tree_build`` and ``tree_update_`` run their plain
versions (``ref.tree_build_ref``, ``ref.tree_update_ref``), so these tests
hold that arithmetic against ``repro`` (``tree_build`` with and without the
Pallas ``block_segment_sums`` in interpret mode) and against a float64
oracle written out here.  Inputs are made with numpy from a seed.
Tolerances: integer-valued trees exact; float builds at 1e-6 relative
(float32 sums in another order); updates bit for bit, since the plain
version and the CUDA kernel both sum a node's deltas in float64 in input
order and round once.  The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.prefix_tree import kernel as jkernel
from repro.kernels.prefix_tree import ops as jops
from repro_torch.jaxcache.fractional import request_counts
from repro_torch.kernels import launch_counts
from repro_torch.kernels.prefix_tree import ops, ref
from repro_torch.kernels.scatter_counts import ops as sc_ops

CSRC = pathlib.Path(ops.__file__).resolve().parent / "csrc"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _oracle(tree, n, radix, idx, delta):
    """Each node on a delta's ancestor path gets float32(float64(node) + the
    float64 sum of its deltas taken in input order); idx < 0 adds nothing."""
    sh = radix.bit_length() - 1
    sums = {}
    for i, d in zip(idx.tolist(), delta.astype(np.float64).tolist()):
        if i < 0:
            continue
        for off in ref.tree_offsets(n, radix):
            sums[off + i] = sums.get(off + i, 0.0) + d  # Python floats add in float64
            i >>= sh
    out = tree.copy()
    for node, s in sums.items():
        out[node] = np.float32(np.float64(tree[node]) + s)
    return out


def _wide(rng, size):
    """float32 deltas over twelve decades, half of them negative."""
    return (rng.standard_normal(size) * 10.0 ** rng.uniform(-8, 4, size)).astype(np.float32)


def _case(name, rng):
    """(n, radix, idx, delta) of one update."""
    if name == "masked":
        n, radix = 1000, 16
        idx = rng.integers(-3, n, size=600)
    elif name == "one node":  # a chunk's run of 2000 deltas under one leaf
        n, radix = 65536, 64
        idx = np.full(2000, 40_000)
    elif name == "ragged last group":  # 1000 = 62 * 16 + 8 leaves
        n, radix = 1000, 16
        idx = rng.integers(984, n, size=300)
    elif name == "five levels":  # 5000 -> 625 -> 79 -> 10 -> 2
        n, radix = 5000, 8
        idx = rng.integers(-1, n, size=1500)
    else:  # an ogb_tree chunk: 2B = 2000 bucket moves over a few buckets
        n, radix = 65536, 64
        idx = np.where(rng.random(2000) < 0.2, -1, rng.integers(30_000, 30_030, size=2000))
    return n, radix, idx.astype(np.int64), _wide(rng, idx.shape[0])


CASES = ["masked", "one node", "ragged last group", "five levels", "chunk"]


@pytest.mark.parametrize("name", CASES)
def test_tree_update_ref_equals_the_input_order_oracle_bit_for_bit(name):
    rng = np.random.default_rng(CASES.index(name))
    n, radix, idx, delta = _case(name, rng)
    tree = ref.tree_build_ref(_t(rng.random(n).astype(np.float32) * 100), radix).numpy()
    want = _oracle(tree, n, radix, idx, delta)
    got = ops.tree_update_(_t(tree.copy()), n, radix, _t(idx), _t(delta)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(got, tree)
    if name == "five levels":
        assert len(ref.tree_sizes(n, radix)) == 5


def test_the_oracle_sees_the_order_of_the_adds():
    """Deltas that cancel (+-1e8 around small values) round differently in
    another order even in float64, so the input order is what is held."""
    rng = np.random.default_rng(9)
    big = np.repeat(np.float32(1e8), 500) * np.tile([1, -1], 250).astype(np.float32)
    delta = np.stack([big, _wide(rng, 500) * 1e-6]).T.reshape(-1).astype(np.float32)
    idx = np.full(delta.shape[0], 7, dtype=np.int64)
    n, radix = 256, 16
    tree = ref.tree_build_ref(_t(np.zeros(n, np.float32)), radix).numpy()
    forward = _oracle(tree, n, radix, idx, delta)
    backward = _oracle(tree, n, radix, idx[::-1], delta[::-1])
    assert not np.array_equal(forward, backward)
    got = ops.tree_update_(_t(tree.copy()), n, radix, _t(idx), _t(delta)).numpy()
    np.testing.assert_array_equal(got, forward)


def _strided_oracle(tree, n, radix, idx, delta):
    """As _oracle, but each node's deltas go into 8 float64 sums by their
    position modulo 8, added up at the end: the card's order where every
    partial sum is exact."""
    sh = radix.bit_length() - 1
    sums = {}
    for q, (i, d) in enumerate(zip(idx.tolist(), delta.astype(np.float64).tolist())):
        if i < 0:
            continue
        for off in ref.tree_offsets(n, radix):
            parts = sums.setdefault(off + i, [0.0] * 8)
            parts[q % 8] += d
            i >>= sh
    out = tree.copy()
    for node, parts in sums.items():
        s = parts[0]
        for p in parts[1:]:
            s += p
        out[node] = np.float32(np.float64(tree[node]) + s)
    return out


def _deltas(kind, rng, size):
    if kind == "counts":  # the count trees' moves
        return rng.choice([-1.0, 1.0], size).astype(np.float32)
    if kind == "values":  # a sum tree's moves: values of y with either sign
        return (rng.uniform(0.05, 2.5, size) * rng.choice([-1, 1], size)).astype(np.float32)
    return _wide(rng, size)


@pytest.mark.parametrize("kind,order", [("counts", ops.EXACT_ANY_ORDER),
                                        ("values", ops.EXACT_ANY_ORDER),
                                        ("wide", ops.INPUT_ORDER)])
@pytest.mark.parametrize("name", CASES)
def test_the_cards_order_of_the_adds_gives_the_plain_versions_bits(name, kind, order):
    """Where the card adds in any order (every partial sum exact), that
    order gives the input order's bits; where it cannot, it adds in input
    order (update_order mirrors the kernel's test)."""
    rng = np.random.default_rng(10 + CASES.index(name))
    n, radix, idx, _ = _case(name, rng)
    delta = _deltas(kind, rng, idx.shape[0])
    assert ops.update_order(n, _t(idx), _t(delta)) == order
    tree = ref.tree_build_ref(_t(rng.random(n).astype(np.float32) * 100), radix).numpy()
    want = ops.tree_update_(_t(tree.copy()), n, radix, _t(idx), _t(delta)).numpy()
    np.testing.assert_array_equal(want, _oracle(tree, n, radix, idx, delta))
    if order == ops.EXACT_ANY_ORDER:
        np.testing.assert_array_equal(want, _strided_oracle(tree, n, radix, idx, delta))


def test_the_exactness_rule_at_its_edge():
    """Deltas whose magnitudes span just under the rule's limit, where the
    rule says any order: 8 strided sums and the reversed order both give
    the input order's float64 sum, bit for bit."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        count = int(rng.integers(2, 3000))
        spread = 29 - (count - 1).bit_length()
        field = rng.integers(1, spread + 2, count) + int(rng.integers(0, 200))
        bits = (field.astype(np.uint32) << 23) | rng.integers(0, 1 << 23, count).astype(np.uint32)
        delta = bits.view(np.float32) * rng.choice([-1, 1], count).astype(np.float32)
        idx = np.zeros(count, np.int64)
        assert ops.update_order(1, _t(idx), _t(delta)) == ops.EXACT_ANY_ORDER
        tree = np.zeros(1, np.float32)
        want = _oracle(tree, 1, 2, idx, delta)
        np.testing.assert_array_equal(_strided_oracle(tree, 1, 2, idx, delta), want)
        np.testing.assert_array_equal(_oracle(tree, 1, 2, idx[::-1], delta[::-1]), want)


def test_update_order_refuses_what_is_not_finite():
    idx = _t(np.zeros(3, np.int64))
    assert ops.update_order(1, idx, _t(np.array([1, np.inf, 1], np.float32))) == ops.INPUT_ORDER
    assert ops.update_order(1, idx, _t(np.array([1, np.nan, 1], np.float32))) == ops.INPUT_ORDER
    assert ops.update_order(1, idx, _t(np.zeros(3, np.float32))) == ops.EXACT_ANY_ORDER
    masked = _t(np.array([-1, 0, 0], np.int64))
    assert ops.update_order(1, masked, _t(np.array([np.nan, 1, 1], np.float32))) == \
        ops.EXACT_ANY_ORDER


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tree_update_takes_int32_and_int64_ids(dtype):
    rng = np.random.default_rng(3)
    n, radix, idx, delta = _case("five levels", rng)
    tree = ref.tree_build_ref(_t(rng.random(n).astype(np.float32)), radix)
    got = ops.tree_update(tree, n, radix, _t(idx.astype(dtype)), _t(delta))
    np.testing.assert_array_equal(got.numpy(), _oracle(tree.numpy(), n, radix, idx, delta))


@pytest.mark.parametrize("n,radix", [(1, 64), (64, 64), (65, 64), (4097, 64), (5000, 8),
                                     (65536, 64), (262_145, 64), (1000, 2)])
def test_tree_build_matches_reference_and_pallas(n, radix):
    rng = np.random.default_rng(n + radix)
    ints = rng.integers(0, 50, size=n).astype(np.float32)  # every sum below 2^24: exact
    got = ops.tree_build(_t(ints), radix).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.tree_build(jnp.asarray(ints), radix)))
    pallas = np.asarray(jops.tree_build(jnp.asarray(ints), radix, use_kernel=True,
                                        interpret=True))
    np.testing.assert_array_equal(got, pallas)
    floats = rng.random(n).astype(np.float32)
    got = ops.tree_build(_t(floats), radix).numpy()
    want = np.asarray(jops.tree_build(jnp.asarray(floats), radix, use_kernel=True,
                                      interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # each level summed from the float32 level below, as block_segment_sums sums one
    offs, sizes = ref.tree_offsets(n, radix), ref.tree_sizes(n, radix)
    for l in range(1, len(sizes)):
        below = jnp.asarray(got[offs[l - 1]:offs[l - 1] + sizes[l - 1]])
        level = np.asarray(jkernel.block_segment_sums(below, sizes[l], radix, interpret=True))
        np.testing.assert_allclose(got[offs[l]:offs[l] + sizes[l]], level, rtol=1e-6, atol=0)


def test_the_geometry_is_the_references():
    for n, radix in [(1, 64), (1_000_000, 64), (65536, 64), (5000, 8), (1000, 2)]:
        assert ops.tree_sizes(n, radix) == jops.tree_sizes(n, radix)
        assert ops.tree_offsets(n, radix) == jops.tree_offsets(n, radix)
        assert ops.tree_storage(n, radix) == jops.tree_storage(n, radix)
    with pytest.raises(ValueError, match="power of two"):
        ops.tree_build(torch.ones(10), 12)


@pytest.mark.parametrize("b,seed", [(1000, 0), (1000, 1), (37, 2), (4096, 3)])
def test_the_chunks_request_count_through_the_histogram_equals_the_accumulate(b, seed):
    """k, ogb_tree's requests a lead lane, as the chunk counts it now (the
    histogram, float32 counts widened) and as it did (a float64 accumulate)."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.zipf(1.2, size=b) % 500)
    lanes = torch.arange(b, dtype=torch.int32)
    scratch = torch.full((500,), 2**31 - 1, dtype=torch.int32)
    scratch.scatter_reduce_(0, ids, lanes, "amin")
    lead = scratch.index_select(0, ids)
    k = request_counts(lead, b).to(torch.float64)
    old = torch.zeros(b, dtype=torch.float64).index_put_(
        (lead.to(torch.int64),), torch.ones(b, dtype=torch.float64), accumulate=True)
    assert k.dtype == torch.float64 and torch.equal(k, old)
    assert float(k.sum()) == b and int((k > 0).sum()) == len(torch.unique(ids))


@pytest.mark.parametrize("n", [1, 1000, sc_ops.TILE_BINS])
@pytest.mark.parametrize("b", [0, 1, 1000, 1_000_000])
def test_bins_that_fit_one_tile_take_bin_tiles(b, n):
    assert sc_ops.design(b, n) == sc_ops.BIN_TILES
    assert sc_ops.histogram_plan(b, n, 132, 1) == {"design": sc_ops.BIN_TILES, "blocks": 1}


def test_tile_constant_mirrors_the_source():
    text = (CSRC / "segsum.cu").read_text()
    assert ops.TILE_LEAVES == int(re.search(r"constexpr int kTileLeaves = (\d+);", text).group(1))


def test_cpu_calls_count_no_launches():
    before = launch_counts()
    tree = ops.tree_build(torch.ones(5000), 8)
    ops.tree_update_(tree, 5000, 8, torch.tensor([3, -1, 4999]), torch.ones(3))
    assert launch_counts() == before
    assert float(ops.tree_total(tree, 5000, 8)) == 5002.0


@pytest.mark.parametrize("call", ["build", "update"])
def test_other_devices_raise(call):
    meta = torch.zeros(ops.tree_storage(100, 8), device="meta")
    calls = {
        "build": lambda: ops.tree_build(torch.zeros(100, device="meta"), 8),
        "update": lambda: ops.tree_update_(meta, 100, 8, torch.zeros(3, dtype=torch.int64,
                                                                     device="meta"),
                                           torch.zeros(3, device="meta")),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[call]()
