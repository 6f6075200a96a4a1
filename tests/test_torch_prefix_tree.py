"""The port's prefix-tree kernels and tree ops against the JAX package's.

On a CPU tensor the kernel wrappers run their plain PyTorch versions, so
these tests hold that arithmetic against the Pallas kernels (in interpret
mode, as the JAX package's own tests run them), against ``repro``'s jnp
tree ops and against the float64 oracles of ``repro.kernels.prefix_tree.
ref``.  Integer-valued trees are exact in float32 whatever the summation
order, so they are compared exactly; float trees at 1e-6 relative (float32
sums of a few thousand values in another order).  The CUDA kernels are
held against the same plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.prefix_tree import kernel as jkernel
from repro.kernels.prefix_tree import ops as jops
from repro.kernels.prefix_tree import ref as jref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.prefix_tree import ops
from repro_torch.kernels.prefix_tree.kernel import block_segment_sums, bucket_masses

SIZES = [1, 5, 64, 65, 1000, 4097]


def _ints(n, seed, hi=50):
    return np.random.default_rng(seed).integers(0, hi, size=n).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("radix", [16, 64])
def test_integer_trees_match_reference_exactly(n, radix):
    vals = _ints(n, n * 7 + radix)
    tree = ops.tree_build(_t(vals), radix)
    jtree = np.asarray(jops.tree_build(jnp.asarray(vals), radix))
    assert tree.shape[0] == ops.tree_storage(n, radix) == jtree.shape[0]
    assert ops.tree_sizes(n, radix) == jops.tree_sizes(n, radix)
    assert ops.tree_offsets(n, radix) == jops.tree_offsets(n, radix)
    np.testing.assert_array_equal(tree.numpy(), jtree)
    idx = np.arange(-1, n, dtype=np.int32)
    np.testing.assert_array_equal(
        ops.tree_prefix(tree, n, radix, _t(idx)).numpy(),
        np.asarray(jops.tree_prefix(jnp.asarray(jtree), n, radix, jnp.asarray(idx))),
    )
    assert float(ops.tree_total(tree, n, radix)) == float(vals.sum(dtype=np.float64))
    lo = np.random.default_rng(n).integers(-1, n, size=64).astype(np.int32)
    hi = np.random.default_rng(n + 1).integers(-1, n, size=64).astype(np.int32)
    np.testing.assert_array_equal(
        ops.tree_range(tree, n, radix, _t(lo), _t(hi)).numpy(),
        np.asarray(jops.tree_range(jnp.asarray(jtree), n, radix, jnp.asarray(lo),
                                   jnp.asarray(hi))),
    )
    total = int(vals.sum())
    if total:
        targets = np.arange(0, total, max(1, total // 97), dtype=np.float32)
        got = ops.tree_select(tree, n, radix, _t(targets)).numpy()
        want = np.asarray(jops.tree_select(jnp.asarray(jtree), n, radix, jnp.asarray(targets)))
        np.testing.assert_array_equal(got, want)
        levels = jref.build_ref(vals.astype(np.float64), radix)
        assert list(got) == [jref.select_ref(levels, float(x)) for x in targets]


@pytest.mark.parametrize("radix", [16, 64])
def test_integer_updates_match_reference_exactly(radix):
    n, rounds, batch = 777, 8, 32
    rng = np.random.default_rng(7)
    vals = _ints(n, 3)
    tree = ops.tree_build(_t(vals), radix)
    jtree = jops.tree_build(jnp.asarray(vals), radix)
    levels = jref.build_ref(vals.astype(np.float64), radix)
    for _ in range(rounds):
        idx = rng.integers(-2, n, size=batch).astype(np.int32)  # idx < 0 is skipped
        delta = rng.integers(-3, 4, size=batch).astype(np.float32)
        got = ops.tree_update(tree, n, radix, _t(idx), _t(delta))
        assert not torch.equal(got, tree) or not np.any(delta[idx >= 0])
        ops.tree_update_(tree, n, radix, _t(idx), _t(delta))
        assert torch.equal(got, tree)
        jtree = jops.tree_update(jtree, n, radix, jnp.asarray(idx), jnp.asarray(delta))
        for i, d in zip(idx, delta):
            if i >= 0:
                jref.update_ref(levels, i, float(d), radix)
    np.testing.assert_array_equal(tree.numpy(), np.asarray(jtree))
    np.testing.assert_array_equal(tree.numpy(), np.concatenate(levels))


@pytest.mark.parametrize("n", [65, 1000, 4097])
def test_float_trees_match_the_float64_oracle(n):
    radix = 64
    vals = np.random.default_rng(n).random(n).astype(np.float32)
    tree = ops.tree_build(_t(vals), radix)
    levels = jref.build_ref(vals.astype(np.float64), radix)
    np.testing.assert_allclose(tree.numpy(), np.concatenate(levels), rtol=1e-6, atol=0)
    idx = np.arange(-1, n, dtype=np.int32)
    got = ops.tree_prefix(tree, n, radix, _t(idx)).numpy()
    want = np.array([jref.prefix_ref(levels, i) for i in idx])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,radix", [(1, 64), (64, 64), (1000, 16), (1_000_003, 64), (65536, 64)])
def test_block_segment_sums_match_pallas(n, radix):
    out_size = -(-n // radix)
    ints = _ints(n, n % 97)
    got = block_segment_sums(_t(ints), out_size, radix).numpy()
    pallas = np.asarray(jkernel.block_segment_sums(jnp.asarray(ints), out_size, radix,
                                                   interpret=True))
    np.testing.assert_array_equal(got, pallas)
    floats = np.random.default_rng(n).random(n).astype(np.float32)
    got = block_segment_sums(_t(floats), out_size, radix).numpy()
    want = np.pad(floats.astype(np.float64), (0, out_size * radix - n)).reshape(
        out_size, radix).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_block_segment_sums_rejects_what_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        block_segment_sums(torch.ones(129), 2, 64)


def _buckets(v, seed, empty=0.7):
    """A y-histogram: counts with most buckets empty, sums = counts * a
    value inside each bucket of width w over [-1, v*w - 1)."""
    rng = np.random.default_rng(seed)
    w = 3.0 / v
    cnt = rng.integers(0, 40, size=v).astype(np.float32)
    cnt[rng.random(v) < empty] = 0
    centre = -1.0 + (np.arange(v) + rng.random(v)) * w
    total = (cnt * centre).astype(np.float32)
    return cnt, total


def _thresholds(k, seed):
    # inside the grid's range, so that every threshold splits the buckets
    return np.sort(np.random.default_rng(seed + 50).uniform(-0.8, 1.6, k)).astype(np.float32)


def _mass64(cnt, total, taus):
    cnt, total = cnt.astype(np.float64), total.astype(np.float64)
    mean = np.where(cnt > 0, total / np.maximum(cnt, 1.0), 0.0)
    return (cnt[None] * np.clip(mean[None] - taus.astype(np.float64)[:, None], 0, 1)).sum(1)


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("v", [1000, 65536])
def test_bucket_masses_match_pallas(v, k):
    cnt, total = _buckets(v, v + k)
    taus = _thresholds(k, k)
    got = bucket_masses(_t(cnt), _t(total), _t(taus)).numpy()
    pallas = np.asarray(jkernel.bucket_masses(jnp.asarray(cnt), jnp.asarray(total),
                                              jnp.asarray(taus), interpret=True))
    # every term is rounded alike; the sums differ in order only
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6 * cnt.sum())
    assert 0 < got.min() and got.max() < cnt.sum()


@pytest.mark.parametrize("k", [1, 12, 63])
def test_bucket_masses_match_float64_at_any_k(k):
    cnt, total = _buckets(65536, k)
    taus = _thresholds(k, k)
    got = bucket_masses(_t(cnt), _t(total), _t(taus)).numpy()
    np.testing.assert_allclose(got, _mass64(cnt, total, taus), rtol=0, atol=1e-6 * cnt.sum())
    assert np.all(np.diff(got) <= 0)  # non-increasing in tau


def test_bucket_masses_reject_bad_shapes():
    with pytest.raises(ValueError, match="one shape"):
        bucket_masses(torch.ones(4), torch.ones(5), torch.zeros(1))
    with pytest.raises(ValueError, match="taus"):
        bucket_masses(torch.ones(4), torch.ones(4), torch.zeros(0))


@pytest.mark.parametrize("n,cap", [(50, 5), (1000, 60), (4097, 300)])
def test_madow_sample_tree_distinct_and_matches_reference(n, cap):
    # f on a grid of 2^-10, so every tree sum is exact in float32 and the
    # two descents compare the same numbers
    rng = np.random.default_rng(n + cap)
    f = np.minimum(np.floor(rng.random(n) * (2.4 * cap / n) * 1024) / 1024, 1.0)
    f = f.astype(np.float32)
    assert f.sum() >= cap
    u = np.float32(rng.random())
    got = ops.madow_sample_tree(_t(f), torch.tensor(u), cap).numpy()
    assert got.shape == (cap,)
    assert np.all(np.diff(got) > 0)  # C distinct ascending ids
    want = np.asarray(jops.madow_sample_tree(jnp.asarray(f), jnp.asarray(u), cap))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jref.madow_sample_ref(f, float(u), cap))


def test_cpu_path_counts_no_launches():
    before = launch_counts()
    ops.tree_build(torch.ones(5000), 64)
    bucket_masses(torch.ones(8), torch.ones(8), torch.zeros(3))
    assert launch_counts() == before
