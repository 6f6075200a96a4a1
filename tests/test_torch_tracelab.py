"""The port's tracelab against repro's: trace loaders, the catalog remap,
and the out-of-core stream.

The loaders and ``CatalogRemap`` are numpy on both sides, so they must give
the same ids, sizes and errors on every committed trace under
``tests/cachesim/data/``.  ``run_stream`` must be bit for bit a one-shot
``run`` over the concatenated trace, whatever the chunking and with the
pipeline (prefetch 2) or without (prefetch 0), here on the CPU through the
kernels' plain versions; its dynamic-OPT windows and the automata's
streamed hits must be ``repro``'s own.
"""

import os

import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
from repro.cachesim.tracelab import catalog as jcatalog
from repro.cachesim.tracelab import loaders as jloaders
from repro.cachesim.tracelab import stream as jstream
import repro_torch
from repro_torch.cachesim.tracelab import (
    CatalogRemap,
    StreamFault,
    load_trace,
    open_trace,
    remap_trace,
    run_stream,
    sniff_format,
    write_trace,
)
from repro_torch.cachesim.traces import zipf

DATA = os.path.join(os.path.dirname(__file__), "cachesim", "data")
FILES = sorted(os.listdir(DATA))
N, C, W, T = 600, 40, 100, 12_000


def _load(mod, path, **kw):
    """(ids, sizes or None, None) or (None, None, the error's class)."""
    try:
        got = mod.load_trace(path, **kw)
    except (ValueError, OverflowError) as e:
        return None, None, type(e)
    if isinstance(got, tuple):
        return got[0], got[1], None
    return got, None, None


def _options(name):
    """The loader options worth trying on a committed file."""
    opts = [{}, {"chunk_size": 3}, {"on_bad": "skip"}, {"header": "none"}]
    if sniff_format(name) in ("csv", "tsv", "cdn"):
        opts += [{"with_sizes": True}, {"with_sizes": True, "on_bad": "skip"},
                 {"key_mode": "hash", "header": "skip"}, {"key_mode": "hash"}]
    else:
        opts += [{"with_sizes": True}, {"key_mode": "hash"}]
    return opts


@pytest.mark.parametrize("name", FILES)
def test_loaders_match_reference_on_every_committed_file(name):
    path = os.path.join(DATA, name)
    assert sniff_format(path) == jloaders.sniff_format(path)
    for kw in _options(name):
        got, want = _load(repro_torch.cachesim.tracelab.loaders, path, **kw), _load(jloaders,
                                                                                     path, **kw)
        assert got[2] == want[2], (name, kw)
        if want[2] is None:
            np.testing.assert_array_equal(got[0], want[0])
            assert got[0].dtype == np.int64
            if want[1] is not None:
                np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fmt", ["csv", "tsv", "cdn", "bin32", "bin64"])
def test_write_trace_round_trips_through_reference_reader(tmp_path, fmt):
    ids = zipf(N, 2000, alpha=0.9, seed=1) * 7919
    sized = fmt in ("csv", "tsv", "cdn")
    sizes = (np.random.default_rng(0).choice([1.0, 2.5, 64.0], size=ids.size)
             if sized else None)
    path = write_trace(str(tmp_path / f"t.{fmt}"), ids, fmt, sizes=sizes)
    want = jloaders.load_trace(path, fmt, with_sizes=sized)
    got = load_trace(path, fmt, with_sizes=sized, chunk_size=333)
    if sized:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], sizes)
        np.testing.assert_array_equal(got[1], want[1])
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ids)
    chunks = list(open_trace(path, fmt, chunk_size=257))
    assert sum(len(c) for c in chunks) == ids.size


@pytest.mark.parametrize("overflow,cap", [("raise", None), ("drop", 50), ("clamp", 50),
                                          ("raise", 50)])
def test_catalog_remap_matches_reference(overflow, cap):
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 2**40, size=400)[zipf(400, 5000, alpha=0.8, seed=2)]
    sizes = rng.choice([1.0, 8.0, 32.0], size=raw.size)
    got, want = CatalogRemap(cap, overflow), jcatalog.CatalogRemap(cap, overflow)
    outs = []
    for mod in (got, want):
        try:
            outs.append([mod.apply(raw[i:i + 333], sizes=sizes[i:i + 333])
                         for i in range(0, raw.size, 333)])
        except ValueError as e:
            outs.append(type(e))
    if isinstance(outs[1], type):
        assert outs[0] is outs[1]
        return
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(want) and got.dropped == want.dropped and got.clamped == want.clamped
    np.testing.assert_array_equal(got.raw_ids, want.raw_ids)
    np.testing.assert_array_equal(got.item_sizes, want.item_sizes)
    # first-seen order does not depend on the chunking
    np.testing.assert_array_equal(remap_trace(raw), jcatalog.remap_trace(raw))


@pytest.fixture(scope="module")
def trace():
    return zipf(N, T, alpha=0.8, seed=5)


def _ragged(trace, step=997):
    return [trace[i:i + step] for i in range(0, len(trace), step)]


def _same_carry(a, b):
    ta = [x for x in a if isinstance(x, torch.Tensor)]
    tb = [x for x in b if isinstance(x, torch.Tensor)]
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("kind", ["ogb", "lru", "lfu", "fifo", "omd"])
def test_run_stream_is_one_shot_run_bit_for_bit(trace, kind, prefetch):
    pd = repro_torch.policy_def(kind)
    one = repro_torch.run(pd, trace, N, C, window=W, device="cpu", track_opt=False)
    st = run_stream(pd, iter(_ragged(trace)), N, C, window=W, horizon=T, segment_len=1500,
                    prefetch=prefetch, device="cpu")
    assert st.T == one.T == T and st.n_segments == 8 and st.t_dropped == 0
    assert st.prefetch == prefetch
    for a in ("hits", "reward", "aux", "occupancy"):
        np.testing.assert_array_equal(getattr(st, a), getattr(one, a))
    _same_carry(st.carry, one.carry)


def test_run_stream_tail_and_resume(trace):
    """A tail short of a window is dropped as run drops it; a stream resumed
    from a stream's carry equals one stream."""
    pd = repro_torch.policy_def("ogb")
    cut = T - 63  # 37 requests past the last whole window
    one = repro_torch.run(pd, trace[:cut], N, C, window=W, device="cpu", horizon=T, eta=0.05)
    st = run_stream(pd, _ragged(trace[:cut], 211), N, C, window=W, horizon=T, eta=0.05,
                    prefetch=2, device="cpu")
    assert st.t_dropped == 37 and st.T == one.T
    np.testing.assert_array_equal(st.reward, one.reward)
    first = run_stream(pd, trace[:5000], N, C, window=W, horizon=T, eta=0.05, prefetch=0,
                       device="cpu")
    rest = run_stream(pd, trace[5000:cut], capacity=C, window=W, carry=first.carry, prefetch=2,
                      device="cpu")
    np.testing.assert_array_equal(np.concatenate([first.hits, rest.hits]), one.hits)
    _same_carry(rest.carry, one.carry)
    with pytest.raises(ValueError, match="horizon"):
        run_stream(pd, trace, N, C, window=W, device="cpu")
    with pytest.raises(ValueError, match="resumes with"):
        run_stream(pd, trace, capacity=C, window=W, carry=first.carry, seed=1, device="cpu")
    with pytest.raises(ValueError, match="dense in"):
        run_stream(pd, [trace[:500], np.array([N + 3])], N, C, window=W, horizon=T,
                   prefetch=0, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_fault_pins_position_and_partial(trace, prefetch):
    def source():
        yield trace[:2500]
        yield trace[2500:4100]
        raise OSError("disk gone")

    pd = repro_torch.policy_def("ogb")
    with pytest.raises(StreamFault) as ei:
        run_stream(pd, source(), N, C, window=W, horizon=T, segment_len=1000,
                   prefetch=prefetch, device="cpu", opt_window=1000)
    fault = ei.value
    assert isinstance(fault.__cause__, OSError)
    assert fault.t_ingested == 4100 and fault.t_replayed == 4000 and fault.n_segments == 4
    part = fault.partial
    assert part.T == 4000 and part.carry is not None and len(part.dyn_opt_hits) == 4
    # the partial resumes: the rest of the trace after it equals one run
    one = repro_torch.run(pd, trace, N, C, window=W, device="cpu", track_opt=False)
    rest = run_stream(pd, trace[4000:], capacity=C, window=W, carry=part.carry, prefetch=0,
                      device="cpu")
    np.testing.assert_array_equal(np.concatenate([part.reward, rest.reward]), one.reward)


def test_dynamic_opt_matches_reference(trace):
    pd = repro_torch.policy_def("lru")
    got = run_stream(pd, _ragged(trace, 401), N, C, window=W, horizon=T, opt_window=2500,
                     prefetch=2, device="cpu")
    want = jstream.run_stream(japi.policy_def("lru"), _ragged(trace, 401), N, C, window=W,
                              horizon=T, opt_window=2500, prefetch=0)
    np.testing.assert_array_equal(got.dyn_opt_hits, want.dyn_opt_hits)
    np.testing.assert_array_equal(got.dyn_opt_lens, want.dyn_opt_lens)
    assert got.dyn_opt_lens.sum() == T and got.dyn_opt_window == want.dyn_opt_window
    assert got.dynamic_regret == pytest.approx(want.dynamic_regret)
    np.testing.assert_array_equal(got.dyn_opt_ratio(), want.dyn_opt_ratio())
    np.testing.assert_array_equal(got.windowed_hit_ratio(2000), want.windowed_hit_ratio(2000))


@pytest.mark.parametrize("kind", ["lru", "lfu", "fifo"])
def test_streamed_automata_hits_match_reference(trace, kind):
    got = run_stream(repro_torch.policy_def(kind), _ragged(trace, 1301), N, C, window=W,
                     horizon=T, segment_len=2000, prefetch=2, device="cpu")
    want = jstream.run_stream(japi.policy_def(kind), _ragged(trace, 1301), N, C, window=W,
                              horizon=T, segment_len=2000, prefetch=0)
    np.testing.assert_array_equal(got.hits, want.hits)
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    assert got.n_segments == want.n_segments


def test_file_to_stream_with_sizes(tmp_path, trace):
    """The file path end to end: a sized CDN log written with raw ids, read
    back through open_trace(with_sizes) and CatalogRemap into a sized
    stream, equals the one-shot run over remap_trace of the same ids."""
    rng = np.random.default_rng(9)
    raw_of = rng.permutation(N) * 1_000_003 + 17
    sizes_of = rng.choice([1.0, 4.0, 16.0], size=N)
    raw = raw_of[trace]
    path = write_trace(str(tmp_path / "t.log"), raw, sizes=sizes_of[trace])
    remap = CatalogRemap(max_items=N)
    pd = repro_torch.policy_def("gds")
    dense_chunks = list(remap.remap(open_trace(path, with_sizes=True, chunk_size=777)))
    item_sizes, n = remap.item_sizes, len(remap)  # the items the trace requests
    item_of = {int(r): i for i, r in enumerate(raw_of)}
    np.testing.assert_array_equal(item_sizes,
                                  sizes_of[[item_of[int(r)] for r in remap.raw_ids]])
    st = run_stream(pd, dense_chunks, n, C, window=W, horizon=T, sizes=item_sizes, prefetch=2,
                    device="cpu")
    dense = remap_trace(raw)
    one = repro_torch.run(pd, dense, n, C, window=W, sizes=item_sizes, device="cpu")
    np.testing.assert_array_equal(st.hits, one.hits)
    np.testing.assert_array_equal(st.byte_hits, one.byte_hits)
    assert st.bytes_total == one.bytes_total and st.byte_hit_ratio == one.byte_hit_ratio


def test_run_without_blocking_equals_blocking(trace):
    pd = repro_torch.policy_def("ogb")
    a = repro_torch.run(pd, trace, N, C, window=W, device="cpu")
    b = repro_torch.run(pd, trace, N, C, window=W, device="cpu", block=False, name="x")
    assert b.name == "x" and b.pending is not None and isinstance(b.hits, torch.Tensor)
    assert b.consume() is b and b.pending is None
    for k in ("hits", "reward", "aux", "occupancy"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_pipelines_under_thread_switching(trace):
    """Sixteen streams at once, each with its ingest thread, the interpreter
    switching threads every microsecond: every stream is still the one-shot
    run bit for bit and counts every request it ingested."""
    import sys
    import threading

    pd = repro_torch.policy_def("lru")
    part = trace[:4000]
    one = repro_torch.run(pd, part, N, C, window=W, device="cpu", track_opt=False)
    results, errors = [None] * 16, []

    def worker(i):
        try:
            results[i] = run_stream(pd, _ragged(part, 97 + i), N, C, window=W, horizon=4000,
                                    segment_len=700, prefetch=1 + i % 3, device="cpu")
        except Exception as e:  # reported below, with the others
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for res in results:
        np.testing.assert_array_equal(res.hits, one.hits)
        assert res.T == 4000 and res.t_dropped == 0
