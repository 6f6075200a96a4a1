"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without an NVIDIA card every test skips.  On
the card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They cover the shapes chip_smoke.py does not: ragged catalog sizes, every
K around the 8-threshold chunk, ids out of range, and run-to-run
determinism, of the kernels and of whole ogb_tree replays (and ogb_tree on
the card against the CPU, bit for bit); the whole-tree build at every
radix its tiles plan for, and the batched tree update bit for bit at a
chunk's shapes, a run of 2000 deltas under one node and in a CUDA graph;
the histogram's
two plans at their edges; the standalone apply at every length modulo 4 and
on views that start mid-vector; both persistent threshold solves (the warm
projection, with and without its f' epilogue, and the bucket solve) on each
side of their on-chip plans; and the attention kernels
at the served models' head shapes in bf16 and f32, and the smoke serving
engine on the card against the same engine on the CPU; the slot automaton
in every plan (one warp to 32 warps, 1 to 16 slots a thread, padded
carries) bit for bit against its plain version, its size limit, the
scenario path's launches and OMD on the card against the CPU; the tree
automata's two kernels (``tree_lru``, with forced ring compactions, and
``minpair_automaton`` for LFU and FTPL, with padded slots) bit for bit
against their plain versions at C = 23 to 50 000, every case evicting, the
int32 tree build, and tree runs on the card with no host read in a chunk.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.cachesim.traces import zipf
from repro_torch.cachesim.tree_engines import OGB_TREE_BUCKETS
from repro_torch.jaxcache.fractional import warm_bracket_hi
from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
from repro_torch.kernels.capped_simplex.ops import (
    apply,
    as_scalar,
    fused_ogb_update,
    masses,
    project_warm,
    project_warm_tau,
)
from repro_torch.kernels.capped_simplex.ref import (
    apply_ref,
    masses_ref,
    project_warm_ref,
    project_warm_tau_ref,
)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.prefix_tree.kernel import (
    block_segment_sums,
    bucket_masses,
    solve_buckets,
)
from repro_torch.kernels.prefix_tree.ops import (
    EXACT_ANY_ORDER,
    INPUT_ORDER,
    first_scratch,
    tree_build,
    tree_offsets,
    tree_sizes,
    tree_update_,
    update_order,
)
from repro_torch.kernels.prefix_tree.ref import (
    bucket_masses_ref,
    segment_sums_ref,
    solve_buckets_ref,
    tree_build_ref,
    tree_update_ref,
)
from repro_torch.kernels.scatter_counts.ops import TILE_BINS, design, histogram
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


# (n, b): the chunk's and a re-anchor's shapes; n one past a tile and one
# short of it, n past the id-slices window of 65 536 bins, B = 0; a slice
# of more ids than a 16-bit counter holds (1.6e7 ids on 132 blocks: every
# count stays below 2^24, where float32 counts are exact)
HISTOGRAM_EDGES = [(1_000_000, 1000), (65536, 1_000_000), (TILE_BINS + 1, 3000),
                   (3 * TILE_BINS - 1, 1000), (70_001, 1_000_000), (1, 0), (100_003, 0),
                   (5, 1000), (65536, 16_000_000)]


@pytest.mark.parametrize("spread", ["one bin", "skewed", "uniform"])
@pytest.mark.parametrize("n,b", HISTOGRAM_EDGES)
def test_histogram_plans_match_plain_at_their_edges(card, n, b, spread):
    gen = torch.Generator().manual_seed(n + b)
    ids = torch.randint(-3, n + 3, (b,), generator=gen, dtype=torch.int32)  # some out of range
    if spread != "uniform":
        hot = torch.rand(b, generator=gen) < (1.0 if spread == "one bin" else 0.95)
        ids[hot] = n // 2
    ids = ids.to(card)
    reset_launch_counts()
    got = histogram(ids, n)
    assert torch.equal(got, histogram_ref(ids, n))
    assert torch.equal(histogram(ids, n), got)
    assert design_counts()["histogram"] == {design(b, n): 2}


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


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 100_001, 100_002, 100_003, 1_000_000])
def test_apply_matches_plain_exactly(card, n):
    f, ids = _state(n, 500, 3, card)
    counts = histogram(ids, n)
    eta, tau = torch.tensor(0.3, device=card), torch.tensor(0.05, device=card)
    reset_launch_counts()
    assert torch.equal(apply(f, counts, eta, tau), apply_ref(f, counts, eta, tau))
    assert design_counts()["apply"] == {"standalone": 1}


@pytest.mark.parametrize("f_at,c_at", [(1, 1), (2, 2), (3, 3), (1, 0), (0, 2)])
@pytest.mark.parametrize("n", [5, 4097, 100_002])
def test_apply_on_views_that_start_mid_vector(card, n, f_at, c_at):
    """Views f[f_at:] and c[c_at:]: at one offset the kernel takes a scalar
    head and the 16-byte body, at two offsets every item one at a time;
    both bit for bit."""
    f, ids = _state(n + 3, 500, 4, card)
    counts = histogram(ids, n + 3)
    fv, cv = f[f_at:f_at + n], counts[c_at:c_at + n]
    eta, tau = torch.tensor(0.3, device=card), torch.tensor(0.05, device=card)
    got = apply(fv, cv, eta, tau)
    assert got.shape == (n,) and got.data_ptr() % 16 == fv.data_ptr() % 16
    assert torch.equal(got, apply_ref(fv, cv, eta, tau))


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
    assert launch_counts() == {"histogram": 100, "mass": 100, "apply": 100, "segsum": 0,
                               "tree_update": 0, "bucket_mass": 0, "flash_prefill": 0,
                               "decode_attention": 0, "slot_automaton": 0, "tree_lru": 0,
                               "minpair_automaton": 0}
    designs = design_counts()
    assert designs["histogram"] == {"bin tiles": 100}
    assert designs["apply"] == {"projection epilogue": 100}
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


def _levels_by_segsum(leaves, radix):
    """The tree as the per-level design built it: one block_segment_sums
    launch a level, then a concatenation."""
    parts, cur = [leaves], leaves
    for size in tree_sizes(leaves.numel(), radix)[1:]:
        cur = block_segment_sums(cur, size, radix)
        parts.append(cur)
    return torch.cat(parts)


# (n, radix): the tiny trees; ogb_tree's 65 536 buckets and the catalog's 1e6
# leaves at radix 64 (4096-leaf tiles, the last block summing the levels
# above); ragged sizes; radices whose tiles hold 3, 4 or 12 levels, and one
# whose tile is a single group; a tree of 2442 tiles
TREE_SHAPES = [(1, 64), (64, 64), (65, 64), (4097, 64), (65536, 64), (1_000_000, 64),
               (262_145, 64), (1000, 16), (5000, 8), (1000, 2), (70_001, 4096),
               (10_000_019, 64)]


@pytest.mark.parametrize("n,radix", TREE_SHAPES)
def test_tree_build_matches_plain_in_one_launch(card, n, radix):
    """Integer trees exact; float trees within 1e-6 relative of the plain
    version, and bit for bit the per-level design's (each level summed from
    the float32 level below, in the same order); two runs bit for bit."""
    gen = torch.Generator().manual_seed(n + radix)
    ints = torch.randint(0, 50, (n,), generator=gen).to(torch.float32).to(card)
    if n * 49 >= 1 << 24:  # keep every sum below 2^24, where float32 counts are exact
        ints = (ints > 47).to(torch.float32)
    reset_launch_counts()
    got = tree_build(ints, radix)
    assert launch_counts()["segsum"] == 1
    assert design_counts()["segsum"] == {"whole tree, one launch": 1}
    assert torch.equal(got, tree_build_ref(ints, radix))
    floats = torch.rand(n, generator=gen).to(card)
    got = tree_build(floats, radix)
    torch.testing.assert_close(got, tree_build_ref(floats, radix), rtol=1e-6, atol=0)
    assert torch.equal(got, _levels_by_segsum(floats, radix))
    assert torch.equal(tree_build(floats, radix), got)


def _update_case(name, seed, card, kind="wide"):
    """(tree, n, radix, idx, delta) of one update on the card.  Deltas:
    "wide", float32 over twelve decades, which the card adds in input order;
    "counts" (+-1) and "values" (0.05 to 2.5 of either sign), whose partial
    sums are exact, which it adds in any order."""
    gen = torch.Generator().manual_seed(seed)
    n, radix, q = 65536, 64, 2000
    if name == "chunk":  # an ogb_tree chunk: 2B moves over a few dozen buckets, some masked
        idx = 30_000 + torch.randint(0, 30, (q,), generator=gen)
        idx[torch.rand(q, generator=gen) < 0.2] = -1
    elif name == "one node":  # a run of 2000 deltas under one leaf
        idx = torch.full((q,), 40_000)
    elif name == "spread":  # every delta its own leaf, nodes of every level shared
        idx = torch.randperm(n, generator=gen)[:q]
    elif name == "five levels":
        n, radix, q = 5000, 8, 1500
        idx = torch.randint(-2, n, (q,), generator=gen)
    else:  # many deltas: the walk past a block's share
        n, radix, q = 1_000_000, 64, 20_000
        idx = torch.randint(-1, n, (q,), generator=gen)
    sign = torch.randint(0, 2, (q,), generator=gen) * 2.0 - 1.0
    delta = {"wide": torch.randn(q, generator=gen) * 10.0 ** (torch.rand(q, generator=gen) * 12 - 8),
             "counts": sign,
             "values": sign * (0.05 + 2.45 * torch.rand(q, generator=gen))}[kind]
    tree = tree_build_ref(torch.rand(n, generator=gen) * 100, radix)
    return tree.to(card), n, radix, idx.to(card), delta.to(card)


@pytest.mark.parametrize("kind,order", [("wide", INPUT_ORDER), ("counts", EXACT_ANY_ORDER),
                                        ("values", EXACT_ANY_ORDER)])
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", ["chunk", "one node", "spread", "five levels", "many"])
def test_tree_update_equals_plain_bit_for_bit(card, name, index_dtype, kind, order):
    """The kernel against the plain version on the card and on the CPU,
    bit for bit, in either order of the adds; nodes no delta reaches
    unchanged; two runs bit for bit."""
    tree, n, radix, idx, delta = _update_case(name, len(name), card, kind)
    idx = idx.to(index_dtype)
    assert update_order(n, idx, delta) == order
    reset_launch_counts()
    got = tree_update_(tree.clone(), n, radix, idx, delta)
    assert launch_counts()["tree_update"] == 1
    want = tree_update_ref(tree.clone(), n, radix, idx, delta)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tree_update_ref(tree.cpu(), n, radix, idx.cpu(), delta.cpu()))
    assert not torch.equal(got, tree)
    assert torch.equal(tree_update_(tree.clone(), n, radix, idx, delta), got)
    assert bool((first_scratch(got.device, tree.numel()) == 2**31 - 1).all())  # left as found
    touched = torch.zeros(tree.numel(), dtype=torch.bool, device=card)
    ok = idx >= 0
    node = idx[ok].long()
    for off in tree_offsets(n, radix):
        touched[off + node] = True
        node = node // radix
    assert torch.equal(got[~touched], tree[~touched])


def test_tree_update_skips_empty_and_masked_calls(card):
    tree, n, radix, idx, delta = _update_case("chunk", 1, card)
    before = tree.clone()
    reset_launch_counts()
    tree_update_(tree, n, radix, idx[:0], delta[:0])
    assert launch_counts()["tree_update"] == 0
    tree_update_(tree, n, radix, torch.full_like(idx, -1), delta)
    assert launch_counts()["tree_update"] == 1 and torch.equal(tree, before)


@pytest.mark.parametrize("kind", ["wide", "counts"])
def test_tree_update_replays_in_a_cuda_graph(card, kind):
    """One update captured in a CUDA graph (the step of a later replay
    loop) replays to the eager result, bit for bit."""
    tree, n, radix, idx, delta = _update_case("chunk", 2, card, kind)
    eager = tree_update_(tree.clone(), n, radix, idx, delta)
    work = tree.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tree_update_(tree.clone(), n, radix, idx, delta)  # builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tree_update_(work, n, radix, idx, delta)
    work.copy_(tree)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(work, eager)


@pytest.mark.parametrize("batch_hint,chunks", [(4096, 100), (1, 30)])
def test_ogb_tree_on_the_card_equals_the_cpu_bit_for_bit(card, batch_hint, chunks):
    """The replay on the card and on the CPU: every threshold step, every
    hit and the state the solve reads (y, the count trees, the sum tree's
    leaves) bit for bit, with and without a re-anchor in every chunk."""
    n, c, w = 200_000, 10_000, 1000
    trace = zipf(n, chunks * w, seed=5)
    pd = repro_torch.policy_def("ogb_tree", batch_hint=batch_hint)
    got = repro_torch.run(pd, trace, n, c, window=w, eta=0.05)
    want = repro_torch.run(pd, trace, n, c, window=w, eta=0.05, device="cpu")
    assert got.extras["reanchors"] == want.extras["reanchors"] == (chunks if batch_hint == 1 else 0)
    np.testing.assert_array_equal(got.aux, want.aux)
    np.testing.assert_array_equal(got.hits, want.hits)
    for name in ("y", "ycnt", "dcnt"):
        assert torch.equal(getattr(got.carry, name).cpu(), getattr(want.carry, name))
    assert torch.equal(got.carry.ysum[:OGB_TREE_BUCKETS].cpu(), want.carry.ysum[:OGB_TREE_BUCKETS])


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


def _warm_step(n, seed, card):
    """A projection step of the replay's shape: f feasible-ish around C =
    n / 20, the counts of n / 10 ids, eta 0.05, lo = 0 and the bracket's hi
    for that step."""
    gen = torch.Generator().manual_seed(seed)
    cap = max(1.0, float(n // 20))
    f = (torch.rand(n, generator=gen) * (2.0 * cap / n)).clamp(max=1.0).to(card)
    b = max(1, n // 10)
    counts = histogram(torch.randint(0, n, (b,), generator=gen, dtype=torch.int32).to(card), n)
    eta = torch.tensor(0.05, device=card)
    return f, counts, eta, as_scalar(cap, card), torch.zeros((), device=card), \
        warm_bracket_hi(eta * float(b))


def _held_warm(card, f, counts, eta, cap, lo, hi, tau0, sweeps):
    """The persistent projection within 1e-6 of its plain version, and two
    runs bit for bit; returns the designs it ran."""
    reset_launch_counts()
    got = project_warm_tau(f, counts, eta, cap, lo, hi, tau0, sweeps)
    want = project_warm_tau_ref(f, counts, eta, cap, lo, hi, tau0, sweeps)
    assert got.shape == () and bool(torch.isfinite(got))
    assert abs(float(got) - float(want)) <= 1e-6
    assert torch.equal(project_warm_tau(f, counts, eta, cap, lo, hi, tau0, sweeps), got)
    assert launch_counts()["mass"] == 2
    return design_counts()["mass"]


@pytest.mark.parametrize("n", [1, 1000, 20_000, 1_000_000, "edge", "past the edge", 4_000_000])
def test_project_warm_tau_matches_plain_on_each_side_of_the_register_plan(card, n):
    """tau alone, and with f' from the epilogue: the same tau bit for bit,
    f' bit for bit apply's plain version at it.  The edge: one resident
    block of 1024 threads an SM, 8 items of y each."""
    edge = torch.cuda.get_device_properties(card).multi_processor_count * 1024 * 8
    n = {"edge": edge, "past the edge": edge + 1}.get(n, n)
    f, counts, eta, cap, lo, hi = _warm_step(n, n, card)
    designs = _held_warm(card, f, counts, eta, cap, lo, hi, 0.3 * hi, 5)
    where = "in registers" if n <= edge else "re-read from L2"
    assert designs == {f"persistent, y {where}": 2}
    tau = project_warm_tau(f, counts, eta, cap, lo, hi, 0.3 * hi, 5)
    reset_launch_counts()
    got_f, got_tau = project_warm(f, counts, eta, cap, lo, hi, 0.3 * hi, 5)
    assert torch.equal(got_tau, tau)
    assert torch.equal(got_f, apply_ref(f, counts, eta, got_tau))
    assert torch.equal(got_f, apply(f, counts, eta, got_tau))
    assert launch_counts()["mass"] == 1 and launch_counts()["apply"] == 2
    assert design_counts()["mass"] == {f"persistent, y {where}": 1}
    assert design_counts()["apply"] == {"projection epilogue": 1, "standalone": 1}
    plain_f, plain_tau = project_warm_ref(f, counts, eta, cap, lo, hi, 0.3 * hi, 5)
    assert abs(float(got_tau) - float(plain_tau)) <= 1e-6
    if torch.equal(got_tau, plain_tau):
        assert torch.equal(got_f, plain_f)


@pytest.mark.parametrize("sweeps", [0, 1, 25])
def test_project_warm_epilogue_at_any_sweep_count(card, sweeps):
    f, counts, eta, cap, lo, hi = _warm_step(20_000, sweeps, card)
    got_f, got_tau = project_warm(f, counts, eta, cap, lo, hi, 0.5 * hi, sweeps)
    assert torch.equal(got_tau, project_warm_tau(f, counts, eta, cap, lo, hi, 0.5 * hi, sweeps))
    assert torch.equal(got_f, apply_ref(f, counts, eta, got_tau))


@pytest.mark.parametrize("sweeps", [1, 5, 25])
@pytest.mark.parametrize("start", ["lo", "mid", "hi"])
def test_project_warm_tau_sweeps_and_starts(card, sweeps, start):
    f, counts, eta, cap, lo, hi = _warm_step(20_000, 7, card)
    tau0 = {"lo": lo, "mid": 0.5 * hi, "hi": hi}[start]
    _held_warm(card, f, counts, eta, cap, lo, hi, tau0, sweeps)


def test_project_warm_tau_stops_where_the_reference_does_on_its_cycling_instance(card):
    y = torch.tensor([1.0, 0.5, 1.5, 0.0], device=card)
    zeros = torch.zeros(4, device=card)
    one = lambda x: as_scalar(x, card)  # noqa: E731
    got = project_warm_tau(y, zeros, one(0.5), one(2.0), one(0.0), one(1.0), one(0.5), 25)
    assert float(got) == 0.0
    _held_warm(card, y, zeros, one(0.5), one(2.0), one(0.0), one(1.0), one(0.5), 25)


def _buckets(v, seed, card):
    """(V,) bucket counts (70% empty) and sums with means spread over
    [-1, 2], as a value histogram of y holds them."""
    gen = torch.Generator().manual_seed(seed)
    cnt = torch.randint(0, 40, (v,), generator=gen).to(torch.float32)
    cnt[torch.rand(v, generator=gen) < 0.7] = 0.0
    cnt[v // 2] = 7.0
    centre = -1.0 + (torch.arange(v) + torch.rand(v, generator=gen)) * (3.0 / v)
    return cnt.to(card), (cnt * centre).to(card)


@pytest.mark.parametrize("iters", [6, 7, 30])
@pytest.mark.parametrize("v", [1, 1000, 65536, 1 << 20])
def test_solve_buckets_equals_plain_bit_for_bit(card, v, iters):
    cnt, total = _buckets(v, v + iters, card)
    cap = as_scalar(0.4 * float(cnt.double().sum()), card)
    lo, hi = as_scalar(-1.5, card), as_scalar(2.5, card)
    reset_launch_counts()
    got = solve_buckets(cnt, total, cap, lo, hi, iters)
    want = solve_buckets_ref(cnt, total, cap, lo, hi, iters)
    assert got.shape == () and torch.equal(got, want)
    assert torch.equal(solve_buckets(cnt, total, cap, lo, hi, iters), got)
    where = "in shared memory" if v <= 65536 else "re-read from L2"
    assert design_counts()["bucket_mass"] == {f"persistent, means {where}": 2}
    assert launch_counts()["bucket_mass"] == 2


def test_persistent_solves_replay_in_a_cuda_graph(card):
    """The cooperative launches (the projection with and without its
    epilogue, the bucket solve) can be captured in a CUDA graph (the step of
    a later replay loop) and replay to the eager results, bit for bit."""
    f, counts, eta, cap, lo, hi = _warm_step(1_000_000, 11, card)
    cnt, total = _buckets(65536, 11, card)
    bcap = as_scalar(0.4 * float(cnt.double().sum()), card)
    blo, bhi = as_scalar(-1.5, card), as_scalar(2.5, card)

    def step():
        return (project_warm_tau(f, counts, eta, cap, lo, hi, 0.3 * hi, 5),
                *project_warm(f, counts, eta, cap, lo, hi, 0.3 * hi, 5),
                solve_buckets(cnt, total, bcap, blo, bhi, 30))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm up outside the capture (builds, occupancy queries)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("batch_hint,chunks", [(4096, 200), (1, 50)])
def test_ogb_tree_two_runs_equal_bit_for_bit(card, batch_hint, chunks):
    """Two replays on the card agree bit for bit (every sum of a chunk adds
    in a fixed order); batch_hint=1 re-anchors every chunk here."""
    n, c, w = 200_000, 10_000, 1000
    trace = zipf(n, chunks * w, seed=3)
    pd = repro_torch.policy_def("ogb_tree", batch_hint=batch_hint)
    reset_launch_counts()
    one = repro_torch.run(pd, trace, n, c, window=w, eta=0.05)
    counts, designs = launch_counts(), design_counts()
    two = repro_torch.run(pd, trace, n, c, window=w, eta=0.05)
    assert counts["bucket_mass"] == chunks
    reanchors = one.extras["reanchors"]
    assert (reanchors == chunks) if batch_hint == 1 else (reanchors == 0)
    # three trees built at init and at each re-anchor, one launch each;
    # three tree updates and one request count (a histogram) a chunk
    assert counts["segsum"] == 3 * (1 + reanchors)
    assert designs["segsum"] == {"whole tree, one launch": 3 * (1 + reanchors)}
    assert counts["tree_update"] == 3 * chunks
    assert counts["histogram"] == chunks + 2 * reanchors
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


def _attention_limit(dtype, want):
    """float32: 2e-5, the JAX package's kernel tests' tolerance; bf16: one
    ulp of the largest output (both round a float32 result once)."""
    return 2e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.float().abs().max())


# (B, H, Hkv, D): glm4-9b, qwen3-14b, gemma-7b, a smoke config, MQA
DECODE_HEADS = [(8, 32, 2, 128), (8, 40, 8, 128), (4, 16, 16, 256), (2, 8, 2, 16), (3, 16, 1, 64),
                # phi-3-vision's D = 96 (the mma design at a D outside {16, 64, 128,
                # 256}); q-groups of 32 and 40 (mma_grid_plan's row tiles past 16,
                # the last one ragged)
                (4, 32, 32, 96), (2, 64, 2, 128), (2, 40, 1, 64)]
KINDS = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: bf16 lengths at serving's S = 2080 around the mma design's edges: its
#: 64-position tile, its 3-tile ring (refilled from the 4th tile on), the
#: 320-position split of glm4-9b's plan and the 1088-position split of
#: qwen3-14b's, and the served lengths 2049..2080
EDGE_LENGTHS = {
    "tile": [1, 63, 64, 65, 127, 128, 129, 2080],
    "ring": [191, 192, 193, 255, 256, 257, 2049, 2080],
    "split": [319, 320, 321, 639, 640, 641, 1919, 2080],
    "qwen-split": [575, 576, 577, 1087, 1088, 1089, 2079, 2080],
    "served": [2049, 2050, 2051, 2052, 2053, 2054, 2055, 2080],
}
DECODE_CASES = [
    pytest.param(B, H, Hkv, D, S, dtype, None, id=f"{B}-{H}-{Hkv}-{D}-{S}-{KINDS[dtype]}")
    for dtype in (torch.bfloat16, torch.float32) for S in (1, 130, 4096)
    for B, H, Hkv, D in DECODE_HEADS
] + [
    pytest.param(8, H, Hkv, D, 2080, torch.bfloat16, lengths, id=f"8-{H}-{Hkv}-{D}-2080-bf16-{name}")
    for H, Hkv, D in ((32, 2, 128), (40, 8, 128), (16, 16, 256))
    for name, lengths in EDGE_LENGTHS.items()
]


@pytest.mark.parametrize("B,H,Hkv,D,S,dtype,lengths", DECODE_CASES)
def test_decode_attention_matches_plain(card, B, H, Hkv, D, S, dtype, lengths):
    gen = torch.Generator(device=card).manual_seed(B * S + D)
    q = torch.randn(B, H, D, generator=gen, device=card).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=card).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=card).to(dtype)
    if lengths is None:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=card, dtype=torch.int32)
        lengths[0], lengths[-1] = 1, S
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))
    assert torch.equal(got, decode_attention(q, k, v, lengths))


PREFILL_SHAPES = [(1, 1024, 32, 2, 128), (2, 200, 40, 8, 128), (1, 700, 16, 16, 256), (2, 1, 8, 2, 16),
                  (2, 65, 8, 2, 16), (1, 512, 4, 1, 64), (1, 700, 8, 2, 192)]
#: bf16 edges of the wgmma design: S around its 64- and 128-row tiles (TMA's
#: zero fill past S, the diagonal tiles), D = 128 (128-key tiles), 192 and 256
#: (64-key tiles), groups of 1, 5 and 16 query heads a KV head
PREFILL_CASES = [
    pytest.param(B, S, H, Hkv, D, dtype, id=f"{B}-{S}-{H}-{Hkv}-{D}-{KINDS[dtype]}")
    for dtype in (torch.bfloat16, torch.float32) for B, S, H, Hkv, D in PREFILL_SHAPES
] + [
    pytest.param(1, S, 2 * g, 2, D, torch.bfloat16, id=f"1-{S}-{2 * g}-2-{D}-bf16-edge")
    for S in (1, 63, 64, 127, 128, 129, 2047, 4000) for D in (128, 192, 256) for g in (1, 5, 16)
]


@pytest.mark.parametrize("B,S,H,Hkv,D,dtype", PREFILL_CASES)
def test_flash_prefill_matches_plain(card, B, S, H, Hkv, D, dtype):
    gen = torch.Generator(device=card).manual_seed(B * S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=card).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=card).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=card).to(dtype)
    got = flash_prefill(q, k, v)
    want = flash_prefill_ref(q, k, v)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))
    assert torch.equal(got, flash_prefill(q, k, v))


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-14b", "gemma-7b"])
def test_served_shapes_take_their_design(card, arch, monkeypatch):
    """bf16 at a served model's head shapes launches the tensor-core designs
    and float32 the CUDA-core ones: with the other design's entry point made
    to raise, each call still runs, and is counted once."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_prefill import kernel as pk

    cfg = get_arch(arch)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=card).manual_seed(D)
    for dtype, new in ((torch.bfloat16, True), (torch.float32, False)):
        assert (pk.design(dtype, D) == pk.WGMMA) == new
        assert (dk.design(dtype, D) == dk.MMA) == new

        def refuse(*args, **kwargs):
            raise AssertionError("the other design was launched")

        with monkeypatch.context() as m:
            m.setattr(pk, "_entry" if new else "_entry_wgmma", lambda: refuse)
            m.setattr(dk, "_entry" if new else "_entry_mma", lambda: refuse)
            q = torch.randn(1, 130, H, D, generator=gen, device=card).to(dtype)
            k = torch.randn(1, 130, Hkv, D, generator=gen, device=card).to(dtype)
            reset_launch_counts()
            out = flash_prefill(q, k, k)
            lengths = torch.tensor([97], dtype=torch.int32, device=card)
            dec = decode_attention(q[:, 0].contiguous(), k, k, lengths)
            torch.cuda.synchronize()
            assert launch_counts()["flash_prefill"] == 1
            assert launch_counts()["decode_attention"] == 1
        for got, want in ((out, flash_prefill_ref(q, k, k)),
                          (dec, decode_attention_ref(q[:, 0], k, k, lengths))):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=_attention_limit(dtype, want))


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-14b", "gemma-7b"])
def test_smoke_engine_on_the_card_matches_the_cpu(card, arch):
    """The float32 smoke engine gives the same tokens on the card, through
    the kernels, as on the CPU, through the plain versions."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.core.ogb import OGB
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool

    cfg = get_smoke(arch)
    cpu_params = init_params(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    outs, reuse = {}, {}
    for dev in ("cpu", card):
        params = _to(cpu_params, dev)
        pool = PagedKVPool(OGB(catalog_size=1 << 16, capacity=16, eta=0.3, batch_size=8),
                           page_size=4)
        engine = ServeEngine(cfg, params, pool=pool, max_len=48, device=dev)
        reset_launch_counts()
        outs[str(dev)] = [engine.generate(prompt, max_new_tokens=4) for _ in range(3)]
        reuse[str(dev)] = engine.stats.prefix_reuse
        if dev == card:
            counts = launch_counts()
            assert counts["flash_prefill"] == 3 * cfg.n_layers
            assert counts["decode_attention"] == 3 * 4 * cfg.n_layers
    for a, b in zip(outs["cpu"], outs[str(card)]):
        np.testing.assert_array_equal(a, b)
    assert reuse["cpu"] == reuse[str(card)]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# -- the scenario path: the slot automaton, OMD, run_scenario ---------------

AUTOMATA = ("lru", "fifo", "lfu", "ftpl")


@pytest.mark.parametrize("c,n_slots", [(1, None), (25, None), (31, 33), (250, None),
                                       (1000, 1100), (4097, None), (16384, None)])
@pytest.mark.parametrize("kind", AUTOMATA)
def test_slot_automaton_matches_plain_bit_for_bit(card, kind, c, n_slots):
    """Every plan (one warp to 32 warps, 1 to 16 slots a thread) and padded
    carries: hits, stats and the whole carry, chunk by chunk, equal to the
    plain version's on the CPU; a zipf trace over 4C items, a round robin
    over them (C + 1500 distinct ids: the slots fill and every request past
    them misses), then zipf again, so that every kind evicts at every C."""
    from repro_torch.cachesim.engines import automaton_args, init_engine_carry
    from repro_torch.cachesim.traces import adversarial
    from repro_torch.kernels.slot_automaton.ops import slot_automaton

    n = max(4 * c, 64)
    trace = np.concatenate([zipf(n, 3000, alpha=0.9, seed=c), adversarial(n, c + 1500, seed=c),
                            zipf(n, 1500, alpha=0.9, seed=c + 1)])
    cpu = init_engine_carry(kind, n, c, n_slots=n_slots, horizon=len(trace), device="cpu")
    dev = type(cpu)(*(x.to(card) for x in cpu))
    launches, evicted = slot_automaton.launches, 0
    for part in np.array_split(trace.astype(np.int32), 3):
        ids = torch.from_numpy(part)
        before = set(cpu.slots.tolist())
        want = slot_automaton(kind, *automaton_args(kind, cpu), ids)
        got = slot_automaton(kind, *automaton_args(kind, dev), ids.to(card))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        for name, a, b in zip(cpu._fields, dev, cpu):
            assert torch.equal(a.cpu(), b), name
        evicted += len(before - set(cpu.slots.tolist()) - {-1, -2})
    assert slot_automaton.launches == launches + 3
    assert evicted > 0 or (kind, c) == ("lfu", 1)  # one slot: LFU keeps the most requested
    if n_slots:
        assert bool((dev.slots[c:] == -2).all())


@pytest.mark.parametrize("kind", AUTOMATA)
def test_slot_automaton_plain_version_on_the_card(card, kind):
    from repro_torch.cachesim.engines import automaton_args, init_engine_carry
    from repro_torch.kernels.slot_automaton.ops import slot_automaton
    from repro_torch.kernels.slot_automaton.ref import slot_automaton_ref

    trace = torch.from_numpy(zipf(900, 1500, alpha=0.9, seed=3).astype(np.int32)).to(card)
    a = init_engine_carry(kind, 900, 120, n_slots=130, horizon=1500, device=card)
    b = type(a)(*(x.clone() for x in a))
    got = slot_automaton(kind, *automaton_args(kind, a), trace)
    want = slot_automaton_ref(kind, *automaton_args(kind, b), trace)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_slot_automaton_raises_past_its_capacity(card):
    from repro_torch.cachesim.engines import automaton_args, init_engine_carry
    from repro_torch.kernels.slot_automaton.ops import MAX_SLOTS, slot_automaton

    big = init_engine_carry("lfu", 4 * MAX_SLOTS, MAX_SLOTS + 1, device=card)
    ids = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="tree automata"):
        slot_automaton("lfu", *automaton_args("lfu", big), ids)
    with pytest.raises(ValueError, match="tree automata"):
        repro_torch.run(repro_torch.policy_def("lru", impl="dense"), np.zeros(20, np.int64), 10,
                        MAX_SLOTS + 1, window=10)


def test_run_scenario_launches_one_automaton_kernel_a_chunk(card):
    """fig8_cdn at mini on the card: one launch a chunk of each automaton row
    (20 chunks each): slot_automaton for FIFO, tree_lru for LRU,
    minpair_automaton for LFU and FTPL; the OGB row's histogram, mass and
    apply once a chunk and OMD's histogram once a chunk; every row equal to
    the CPU run (automata exactly)."""
    from repro_torch.cachesim.scenarios import run_scenario

    reset_launch_counts()
    res = run_scenario("fig8_cdn", "mini")
    chunks = res.T // 1000
    counts = launch_counts()
    assert counts["slot_automaton"] == 20
    assert (counts["tree_lru"], counts["minpair_automaton"], counts["segsum"]) == (20, 40, 0)
    assert (counts["histogram"], counts["mass"], counts["apply"]) == (2 * chunks, chunks, chunks)
    cpu = run_scenario("fig8_cdn", "mini", device="cpu")
    for row in ("LRU", "FIFO", "LFU", "FTPL", "ARC", "OPT(static)"):
        assert res.rows[row]["hit_ratio"] == cpu.rows[row]["hit_ratio"], row
    for row in ("OGB", "OMD"):
        assert res.rows[row]["frac_hit_ratio"] == pytest.approx(cpu.rows[row]["frac_hit_ratio"],
                                                                rel=1e-4)


def test_omd_on_the_card_matches_the_cpu(card):
    n, c, w = 20_000, 1000, 1000
    trace = zipf(n, 100 * w, alpha=0.9, seed=8)
    pd = repro_torch.policy_def("omd")
    got = repro_torch.run(pd, trace, n, c, window=w)
    want = repro_torch.run(pd, trace, n, c, window=w, device="cpu")
    np.testing.assert_allclose(got.aux, want.aux, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-4)
    np.testing.assert_allclose(got.final_f, want.final_f, rtol=0, atol=1e-5)
    assert abs(int(got.hits.sum()) - int(want.hits.sum())) <= len(trace) // 1000


# -- the tree automata: tree_lru, minpair_automaton, the int32 tree build ----

TREE_CS = (23, 1000, 16384, 50000)


def _evicting_trace(c, seed):
    """zipf over 4C items, a round robin of C + 1500 distinct items (the
    slots fill and every request past them misses), zipf again."""
    from repro_torch.cachesim.traces import adversarial

    n = max(4 * c, 64)
    return n, np.concatenate([zipf(n, 3000, alpha=0.9, seed=c),
                              adversarial(n, c + 1500, seed=c),
                              zipf(n, 1500, alpha=0.9, seed=c + 1)]).astype(np.int32)


def _tree_case(kind, c, n_slots=None, ring=None, window=None, seed=0):
    """One tree automaton from the same initial carry on the CPU and the
    card, chunk by chunk: hits, stats, per-request flags and every carry
    leaf equal; returns the items evicted between chunks and the card's
    carry."""
    from repro_torch.cachesim import tree_engines as ttree

    n, trace = _evicting_trace(c, seed)
    cpu = ttree.init_tree_engine_carry(kind, n, c, n_slots=n_slots, ring=ring, seed=seed,
                                       horizon=len(trace), device="cpu")
    tensors = [x for x in cpu if isinstance(x, torch.Tensor)]
    dev = type(cpu)(*(x.to("cuda") for x in tensors))
    parts = (np.array_split(trace, 3) if window is None
             else [trace[i:i + window] for i in range(0, len(trace) - window + 1, window)])
    evicted = 0
    for part in parts:
        ids = torch.from_numpy(np.ascontiguousarray(part))
        before = set(cpu.slots.tolist()) if kind != "lru" else set()
        fc = torch.empty(ids.shape, dtype=torch.bool)
        fd = torch.empty(ids.shape, dtype=torch.bool, device="cuda")
        cpu, (h_cpu, s_cpu) = ttree.tree_chunk(kind, cpu, ids, fc)
        dev, (h_dev, s_dev) = ttree.tree_chunk(kind, dev, ids.to("cuda"), fd)
        assert int(h_dev) == int(h_cpu) and torch.equal(s_dev.cpu(), s_cpu)
        assert torch.equal(fd.cpu(), fc)
        for name in cpu._fields:
            a, b = getattr(dev, name), getattr(cpu, name)
            if isinstance(b, torch.Tensor):
                assert torch.equal(a.cpu(), b), name
        if kind != "lru":
            evicted += len(before - set(cpu.slots.tolist()) - {-1, -2})
        else:
            evicted += int(ids.numel()) - int(h_cpu)  # misses past a full cache evict
    return evicted, dev


@pytest.mark.parametrize("c", TREE_CS)
def test_tree_lru_matches_plain_bit_for_bit(card, c):
    reset_launch_counts()
    evicted, carry = _tree_case("lru", c)
    assert evicted > c and launch_counts()["tree_lru"] == 3
    assert carry.host.syncs == 1  # the bound read once, at the first chunk


@pytest.mark.parametrize("c,ring,window", [(23, 256, 150), (40, 256, 176), (1000, 4096, 3000)])
def test_tree_lru_forced_compactions_match_plain(card, c, ring, window):
    """A ring barely above 4C: a compaction every few chunks, decided on the
    card, each one compaction launch and one int32 tree build; where the
    host's bound launches one that is not due, the carry is unchanged."""
    from repro_torch.kernels.tree_lru.ops import CHUNK, COMPACTION

    reset_launch_counts()
    _tree_case("lru", c, ring=ring, window=window)
    counts, designs = launch_counts(), design_counts()["tree_lru"]
    assert designs[COMPACTION] == counts["segsum"] >= 1
    assert counts["tree_lru"] == designs[COMPACTION] + designs[CHUNK]


@pytest.mark.parametrize("c,n_slots", [(c, None) for c in TREE_CS] + [(23, 90), (1000, 1100)])
@pytest.mark.parametrize("kind", ["lfu", "ftpl"])
def test_minpair_automaton_matches_plain_bit_for_bit(card, kind, c, n_slots):
    """Every tree depth (one level at C = 23, two at 1000, three at 16 384
    and 50 000) and padded slots: hits, flags, stats and the whole carry,
    chunk by chunk, equal to the plain version's on the CPU."""
    reset_launch_counts()
    evicted, carry = _tree_case(kind, c, n_slots=n_slots, seed=3)
    assert evicted > 0 and launch_counts()["minpair_automaton"] == 3
    if n_slots:
        assert bool((carry.slots[c:] == -2).all())


@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl"])
@pytest.mark.parametrize("window", [1, 16, 250])
def test_tree_automata_at_small_windows_match_plain(card, kind, window):
    """A chunk of one request, of 16 (less than a tile or a sub-chunk) and
    of 250, over a trace whose ids repeat within a chunk."""
    _tree_case(kind, 23, window=window, seed=5)


@pytest.mark.parametrize("n", [16, 4097, 65536, 262144, 2**21])
def test_int32_tree_build_matches_plain(card, n):
    gen = torch.Generator().manual_seed(n)
    leaves = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32).to(card)
    reset_launch_counts()
    got = tree_build(leaves, 16)
    assert launch_counts()["segsum"] == 1 and got.dtype == torch.int32
    assert torch.equal(got, tree_build_ref(leaves, 16))
    out = torch.full_like(got, -7)
    assert tree_build(leaves, 16, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl"])
def test_tree_runs_read_nothing_on_the_host_in_a_chunk(card, kind):
    """Steps of a started run under torch's sync debug mode "error": a read
    of the device, or a copy to it, inside a chunk raises.  Hits equal the
    dense automaton's."""
    trace = zipf(20_000, 80_000, alpha=0.9, seed=2).astype(np.int32)
    pd = repro_torch.policy_def(kind)
    carry = pd.start(pd.init(20_000, 1000, horizon=len(trace)))
    chunks = torch.from_numpy(trace.reshape(8, 10_000)).to(card)
    hits = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:  # the LRU's 7th chunk runs past its ring of 65 536: a compaction
        for i in range(8):
            carry, out = pd.step(carry, chunks[i])
            hits.append(out.hits)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dense = repro_torch.run(repro_torch.policy_def(kind, impl="dense"), trace, 20_000, 1000,
                            window=10_000)
    assert [int(h) for h in hits] == dense.hits.tolist()


def test_tree_runs_equal_dense_runs_on_the_card(card):
    from repro_torch.cachesim.traces import bursty

    trace = bursty(20_000, 200_000, seed=6)
    for kind in ("lru", "lfu", "ftpl"):
        reset_launch_counts()
        tree = repro_torch.run(repro_torch.policy_def(kind), trace, 20_000, 1000, window=10_000)
        counts = launch_counts()
        assert counts["slot_automaton"] == 0
        assert counts["tree_lru" if kind == "lru" else "minpair_automaton"] >= 20
        dense = repro_torch.run(repro_torch.policy_def(kind, impl="dense"), trace, 20_000, 1000,
                                window=10_000)
        np.testing.assert_array_equal(tree.hits, dense.hits)
        np.testing.assert_array_equal(tree.occupancy, dense.occupancy)
        if kind == "lru":
            assert tree.extras["host_syncs"] == 0
