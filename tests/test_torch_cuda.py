"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without an NVIDIA card every test skips.  On
the card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They cover the shapes chip_smoke.py does not: ragged catalog sizes, every
K around the 8-threshold chunk, ids out of range, and run-to-run
determinism, of the kernels and of whole ogb_tree replays.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.cachesim.traces import zipf
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.capped_simplex.ops import apply, fused_ogb_update, masses
from repro_torch.kernels.capped_simplex.ref import apply_ref, masses_ref
from repro_torch.kernels.prefix_tree.kernel import block_segment_sums, bucket_masses
from repro_torch.kernels.prefix_tree.ref import bucket_masses_ref, segment_sums_ref
from repro_torch.kernels.scatter_counts.ops import histogram
from repro_torch.kernels.scatter_counts.ref import histogram_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    return torch.device("cuda")


def _state(n, b, seed, card):
    gen = torch.Generator().manual_seed(seed)
    f = torch.rand(n, generator=gen) * 0.2
    ids = torch.randint(-2, n + 3, (b,), generator=gen, dtype=torch.int32)
    return f.to(card), ids.to(card)


@pytest.mark.parametrize("n,b", [(1, 5), (1000, 1000), (100_003, 777), (1_000_000, 1000)])
def test_histogram_matches_plain(card, n, b):
    _, ids = _state(n, b, 0, card)
    assert torch.equal(histogram(ids, n), histogram_ref(ids, n))


@pytest.mark.parametrize("k", [1, 7, 8, 12, 64, 65])
@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_masses_match_plain_and_repeat_bit_for_bit(card, n, k):
    f, ids = _state(n, 500, k, card)
    counts = histogram(ids, n)
    eta = torch.tensor(0.01, device=card)
    taus = torch.linspace(-0.5, 1.0, k, device=card)
    mass, cnt = masses(f, counts, eta, taus)
    want_mass, want_cnt = masses_ref(f, counts, eta, taus)
    assert torch.equal(cnt, want_cnt)
    torch.testing.assert_close(mass, want_mass, rtol=0, atol=1e-6 * n)
    again, again_cnt = masses(f, counts, eta, taus)
    assert torch.equal(again, mass) and torch.equal(again_cnt, cnt)


@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_apply_matches_plain_exactly(card, n):
    f, ids = _state(n, 500, 3, card)
    counts = histogram(ids, n)
    eta, tau = torch.tensor(0.3, device=card), torch.tensor(0.05, device=card)
    assert torch.equal(apply(f, counts, eta, tau), apply_ref(f, counts, eta, tau))


def test_fused_ogb_update_matches_cpu(card):
    f, ids = _state(50_000, 2000, 5, card)
    f = f * (500.0 / float(f.sum()))
    counts = histogram(ids, f.numel())
    got = fused_ogb_update(f, counts, 0.01, 500.0)
    want = fused_ogb_update(f.cpu(), counts.cpu(), 0.01, 500.0)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_run_on_the_card_matches_the_cpu_and_counts_launches(card):
    n, c, w = 20_000, 1000, 500
    trace = zipf(n, 100 * w, seed=2)
    pd = repro_torch.policy_def("ogb")
    reset_launch_counts()
    got = repro_torch.run(pd, trace, n, c, window=w)
    assert launch_counts() == {"histogram": 100, "mass": 500, "apply": 100, "segsum": 0,
                               "bucket_mass": 0}
    want = repro_torch.run(pd, trace, n, c, window=w, device="cpu")
    np.testing.assert_allclose(got.aux, want.aux, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-5, atol=0)
    assert abs(int(got.hits.sum()) - int(want.hits.sum())) <= len(trace) // 10_000


@pytest.mark.parametrize("n,radix", [(1, 64), (64, 64), (1000, 16), (65536, 64),
                                     (1_000_000, 64), (15_625, 64)])
def test_segsum_matches_plain(card, n, radix):
    out_size = -(-n // radix)
    gen = torch.Generator().manual_seed(n)
    ints = torch.randint(0, 1000, (n,), generator=gen).to(torch.float32).to(card)
    assert torch.equal(block_segment_sums(ints, out_size, radix),
                       segment_sums_ref(ints, out_size, radix))
    floats = torch.rand(n, generator=gen).to(card)
    got = block_segment_sums(floats, out_size, radix)
    torch.testing.assert_close(got, segment_sums_ref(floats, out_size, radix), rtol=1e-6, atol=0)
    assert torch.equal(block_segment_sums(floats, out_size, radix), got)


@pytest.mark.parametrize("k", [1, 7, 8, 12, 63, 64, 65])
@pytest.mark.parametrize("v", [1, 1000, 65536])
def test_bucket_masses_match_plain_and_repeat_bit_for_bit(card, v, k):
    gen = torch.Generator().manual_seed(v + k)
    cnt = torch.randint(0, 40, (v,), generator=gen).to(torch.float32)
    cnt[torch.rand(v, generator=gen) < 0.7] = 0.0
    centre = -1.0 + (torch.arange(v) + torch.rand(v, generator=gen)) * (3.0 / v)
    total = cnt * centre
    taus = torch.sort(torch.rand(k, generator=gen) * 2.4 - 0.8).values
    cnt, total, taus = cnt.to(card), total.to(card), taus.to(card)
    got = bucket_masses(cnt, total, taus)
    want = bucket_masses_ref(cnt, total, taus)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * max(1.0, float(cnt.sum())))
    assert torch.equal(bucket_masses(cnt, total, taus), got)


@pytest.mark.parametrize("batch_hint,chunks", [(4096, 200), (1, 50)])
def test_ogb_tree_two_runs_equal_bit_for_bit(card, batch_hint, chunks):
    """Two replays on the card agree bit for bit (index_put_ accumulates
    in a fixed order); batch_hint=1 re-anchors every chunk here."""
    n, c, w = 200_000, 10_000, 1000
    trace = zipf(n, chunks * w, seed=3)
    pd = repro_torch.policy_def("ogb_tree", batch_hint=batch_hint)
    reset_launch_counts()
    one = repro_torch.run(pd, trace, n, c, window=w, eta=0.05)
    counts = launch_counts()
    two = repro_torch.run(pd, trace, n, c, window=w, eta=0.05)
    assert counts["bucket_mass"] == 5 * chunks
    reanchors = one.extras["reanchors"]
    assert (reanchors == chunks) if batch_hint == 1 else (reanchors == 0)
    assert counts["segsum"] == 6 * (1 + reanchors)
    for name in ("reward", "hits", "aux", "occupancy"):
        np.testing.assert_array_equal(getattr(one, name), getattr(two, name))
    for a, b in zip(one.carry.tensors(), two.carry.tensors()):
        assert torch.equal(a, b)
    cpu = repro_torch.run(pd, trace, n, c, window=w, eta=0.05, device="cpu")
    np.testing.assert_allclose(one.aux, cpu.aux, rtol=0, atol=1e-5)
    assert abs(int(one.hits.sum()) - int(cpu.hits.sum())) <= len(trace) // 10_000


@pytest.mark.parametrize("sample", ["madow", "madow_tree"])
def test_madow_on_the_card_holds_capacity_and_matches_the_cpu(card, sample):
    n, c, w = 100_000, 5000, 1000
    trace = zipf(n, 100 * w, seed=4)
    pd = repro_torch.policy_def("ogb", sample=sample, madow_capacity=c)
    got = repro_torch.run(pd, trace, n, c, window=w)
    want = repro_torch.run(pd, trace, n, c, window=w, device="cpu")
    np.testing.assert_array_equal(got.occupancy, c)
    assert abs(got.hit_ratio - want.hit_ratio) <= 2e-3
