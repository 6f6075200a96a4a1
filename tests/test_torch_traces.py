"""The trace families and their statistics: repro_torch's against repro's.

Every generator is numpy and seeded, so the port's must give the
reference's trace id for id; the §B.2 statistics and the tracelab
synthesizer (``real_like``'s fit and synthesis) likewise.
"""

import numpy as np
import pytest

from repro.cachesim import traces as jtraces
from repro.cachesim.tracelab import synth as jsynth
from repro_torch.cachesim import traces as ttraces
from repro_torch.cachesim.tracelab import synth as tsynth

N, T = 700, 12_000


def test_registry_names_the_same_generators():
    assert ttraces.TRACE_REGISTRY.keys() == jtraces.TRACE_REGISTRY.keys()


@pytest.mark.parametrize("kind", sorted(jtraces.TRACE_REGISTRY))
@pytest.mark.parametrize("seed", [0, 7])
def test_trace_matches_reference_id_for_id(kind, seed):
    want = jtraces.make_trace(kind, N, T, seed=seed)
    got = ttraces.make_trace(kind, N, T, seed=seed)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < N


@pytest.mark.parametrize("kind,kw", [
    ("shifting_zipf", {"alpha": 0.9, "phase": 1500}),
    ("bursty", {"burst_fraction": 0.5, "burst_len_mean": 8.0, "burst_span": 60}),
    ("scan_mix", {"hot_fraction": 0.3, "scan_len": 500}),
    ("real_like", {"source": "bursty", "burst_fraction": 0.5}),
    ("real_like", {"source": "zipf", "alpha": 0.9, "sample_T": 3000}),
])
def test_trace_options_match_reference(kind, kw):
    np.testing.assert_array_equal(
        ttraces.make_trace(kind, N, T, seed=3, **kw), jtraces.make_trace(kind, N, T, seed=3, **kw)
    )


def test_real_like_small():
    """real_like at a small size: the reference's ids, in range, with a
    fitted profile that the port computes as the reference does."""
    got = ttraces.real_like(200, 5000, source="zipf", seed=21, alpha=0.9)
    np.testing.assert_array_equal(got, jtraces.real_like(200, 5000, source="zipf", seed=21,
                                                         alpha=0.9))
    assert got.min() >= 0 and got.max() < 200


@pytest.mark.parametrize("kind", ["zipf", "bursty", "shifting_zipf", "adversarial"])
def test_trace_stats_and_reuse_distances_match(kind):
    tr = jtraces.make_trace(kind, N, T, seed=1)
    want, got = jtraces.trace_stats(tr), ttraces.trace_stats(tr)
    assert (got.catalog, got.length, got.unique) == (want.catalog, want.length, want.unique)
    for name in ("items", "lifetimes", "max_hits"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for L in (10, 100, 1000):
        assert got.hit_share_lifetime_below(L) == want.hit_share_lifetime_below(L)
    np.testing.assert_array_equal(ttraces.reuse_distances(tr), jtraces.reuse_distances(tr))


def test_trace_stats_sparse_ids_and_edges():
    sparse = np.array([5, 1 << 40, 5, 3, 1 << 40, 5], dtype=np.int64)
    want, got = jtraces.trace_stats(sparse), ttraces.trace_stats(sparse)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.lifetimes, want.lifetimes)
    assert got.lifetime_by_item == want.lifetime_by_item
    assert got.max_hits_by_item == want.max_hits_by_item
    assert ttraces.trace_stats(np.empty(0, np.int64)).length == 0
    with pytest.raises(ValueError):
        ttraces.trace_stats(np.array([-1, 2]))
    assert ttraces.reuse_distances(np.array([4])).size == 0


@pytest.mark.parametrize("source", ["zipf", "bursty", "shifting_zipf"])
def test_fit_profile_and_synthesis_match(source):
    sample = jtraces.make_trace(source, 400, 9000, seed=2)
    want, got = jsynth.fit_profile(sample), tsynth.fit_profile(sample)
    for name in ("catalog", "base_item_frac", "oneshot_frac", "burst_frac", "burst_len_mean",
                 "burst_span", "drift_phase", "source_T"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("pop_cdf", "pop_bins", "reuse_q"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(tsynth.synthesize(got, 20_000, catalog=900, seed=4),
                                  jsynth.synthesize(want, 20_000, catalog=900, seed=4))
    # any chunk size concatenates to the same trace
    pieces = list(tsynth.synthesize_chunks(got, 20_000, catalog=900, seed=4, chunk_size=3001))
    np.testing.assert_array_equal(np.concatenate(pieces),
                                  tsynth.synthesize(got, 20_000, catalog=900, seed=4))


def test_sized_fit_and_sizes_match():
    sample = jtraces.make_trace("zipf", 300, 6000, seed=5)
    sizes = np.random.default_rng(0).lognormal(3.0, 1.0, size=sample.shape)
    want = jsynth.fit_profile(sample, sizes=sizes)
    got = tsynth.fit_profile(sample, sizes=sizes)
    np.testing.assert_array_equal(got.size_logmu, want.size_logmu)
    np.testing.assert_array_equal(tsynth.synthesize_sizes(got, catalog=500, seed=1),
                                  jsynth.synthesize_sizes(want, catalog=500, seed=1))
