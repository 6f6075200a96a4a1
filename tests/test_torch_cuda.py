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
int32 tree build, and tree runs on the card with no host read in a chunk;
the sized axis's kernels: the FIFO queue at C = 25 to 50 000 in both its
plans (each side of 32 active slots, padded slots, and churn traces whose
tiles evict what they request again) and the GDS mode of
``minpair_automaton`` bit for bit against their plain versions, the
stacked and the int32 tree updates (the sorted-runs plan at a sized
chunk's shape, a run of 2000 under one node, 2000 int32 deltas scattered
past the int32 wrap, +-1e8 cancelling in input order, NaN and infinity,
rows and ids out of range, the exactness edge, past the shared workspace,
and replayed in a CUDA graph), the sized solve in both its plans
(also past its shared memory) with their tally, ``ogb_sized`` and
``sized_cdn`` mini on the card against the CPU, and sized runs with no host
read in a chunk; the MoE layer (the dense mixture and capacity dispatch)
on the card against the CPU, attention at granite-moe's and kimi-k2's
heads, and ``ogb_grad`` and ``OGBExpertCache`` on the card against the CPU
with their 50 ``masses`` and one ``apply`` launches a step; the WKV-6
recurrence (``wkv6``) against its plain version at n = 16, 32 and 64 and
S = 1, 7 and 2049 from a zero and a mid-run state, at near-zero and
near-one decays and at each head dim's plan, the state written in place
and two runs bit for bit, what it refuses, and the rwkv6 smoke model
on the card against the CPU; Mamba's selective scan (``selective_scan``)
against its plain version at n = 8 and 16, S = 1, 7 and 2049, a ragged
d_in and slow and fast dt from a zero and a mid-run state, the state
written in place and two runs bit for bit, a decode step (its own kernel)
continuing a prompt bit for bit, each launch counted by design, its earlier
design (kept as text by tools/time_selective_scan_designs.py) against the
plain version, what it refuses, and the jamba smoke model on the card
against the CPU; training's attention: the backward kernel
(``flash_prefill_bwd``) against its plain version in its three modes
(causal, non-causal, cross), at D = 16, 64, 96 and 128, ragged S and
groups of 1 to 16 query heads a KV head, in bf16 (within 8 bf16 ulps of
each output's largest) and float32 (1e-4), two runs bit for bit and the
design's launches a call (three of the wgmma design, two of the others);
the wgmma design at phase 28's shapes, S = 1, ragged S and T and the cross
shape, at every head group, each design by name, and what it refuses; the forward's log-sum-exp in both designs, an lse buffer
leaving the serving call's output and launch count as they were; a
training step of the smoke glm4-9b on the card against the CPU; and every
kernel wrapper without a backward raising on a tensor that requires grad.
The backward's two designs (bf16 at D = 64, 96, 128 on the tensor cores,
everything else on CUDA cores) are each held at the other's shapes too, and
the CUDA-core design at D = 192 and 256 (gemma-7b's; 32-key tiles).  The
WKV-6 backward (``wkv6_bwd``) against its plain version at n = 16, 32 and 64,
S = 1, 15, 16, 17 and 2049, slow and fast decay, from a zero and a nonzero
start state, within 1e-4 of each output's largest and two runs bit for bit,
counted by design, what it refuses, and ``WKV6`` (``wkv6`` under autograd)
on the card; and a full-width training step of gemma-7b (depth 1) and
rwkv6-1.6b (depth 2) at 1 x 512 tokens through the kernels against the
same step through the plain versions on the card.
"""

import math

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
    ON_CHIP_DELTAS,
    UPDATE_DESIGN,
    UPDATE_DESIGN_L2,
    stacked_tree_update_,
    tree_build,
    tree_offsets,
    tree_sizes,
    tree_storage,
    tree_update_,
    update_order,
)
from repro_torch.kernels.prefix_tree.ref import (
    bucket_masses_ref,
    segment_sums_ref,
    solve_buckets_ref,
    stacked_tree_update_ref,
    tree_build_ref,
    tree_update_ref,
)
from repro_torch.kernels.scatter_counts.ops import TILE_BINS, design, histogram
from repro_torch.kernels.scatter_counts.ref import histogram_ref
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.wkv6.ref import wkv6_ref

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
                               "decode_attention": 0, "slot_automaton": 0, "fifo_queue": 0,
                               "tree_lru": 0, "minpair_automaton": 0, "wkv6": 0,
                               "selective_scan": 0, "flash_prefill_bwd": 0, "wkv6_bwd": 0}
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
    # the workspace in shared memory, or past ON_CHIP_DELTAS in a global buffer
    assert design_counts()["tree_update"] == {
        UPDATE_DESIGN if idx.numel() <= ON_CHIP_DELTAS else UPDATE_DESIGN_L2: 1}
    want = tree_update_ref(tree.clone(), n, radix, idx, delta)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tree_update_ref(tree.cpu(), n, radix, idx.cpu(), delta.cpu()))
    assert not torch.equal(got, tree)
    assert torch.equal(tree_update_(tree.clone(), n, radix, idx, delta), got)
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
                (4, 32, 32, 96), (2, 64, 2, 128), (2, 40, 1, 64),
                # granite-moe's served heads (groups of 2 at D = 64) and kimi-k2's
                (8, 16, 8, 64), (2, 64, 8, 128)]
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
    for H, Hkv, D in ((32, 2, 128), (40, 8, 128), (16, 16, 256), (16, 8, 64))
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


SERVED_ARCHS = ["glm4-9b", "qwen3-14b", "gemma-7b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
PREFILL_SHAPES = [(1, 1024, 32, 2, 128), (2, 200, 40, 8, 128), (1, 700, 16, 16, 256), (2, 1, 8, 2, 16),
                  (2, 65, 8, 2, 16), (1, 512, 4, 1, 64), (1, 700, 8, 2, 192),
                  # granite-moe's heads at its served prompt length, and ragged
                  (2, 2048, 16, 8, 64), (1, 700, 16, 8, 64)]
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


@pytest.mark.parametrize("arch", SERVED_ARCHS)
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


@pytest.mark.parametrize("arch", SERVED_ARCHS)
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
    (20 chunks each): fifo_queue for FIFO, tree_lru for LRU,
    minpair_automaton for LFU and FTPL; the OGB row's histogram, mass and
    apply once a chunk and OMD's histogram once a chunk; every row equal to
    the CPU run (automata exactly)."""
    from repro_torch.cachesim.scenarios import run_scenario

    reset_launch_counts()
    res = run_scenario("fig8_cdn", "mini")
    chunks = res.T // 1000
    counts = launch_counts()
    assert (counts["fifo_queue"], counts["slot_automaton"]) == (20, 0)
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


# -- the sized axis and FIFO at any capacity: fifo_queue, the GDS mode of
# minpair_automaton, the stacked and int32 tree updates, solve_sized --------

FIFO_CS = (25, 1000, 16384, 50000)


@pytest.mark.parametrize("churn", [False, True], ids=["evicting", "churn"])
@pytest.mark.parametrize("c,n_slots", [(c, None) for c in FIFO_CS] + [(31, 40), (1000, 1100),
                                                                        (31, None), (32, None),
                                                                        (33, None), (32, 40),
                                                                        (5000, None)])
def test_fifo_queue_matches_plain_bit_for_bit(card, c, n_slots, churn):
    """Every capacity (fewer slots than a warp's 32 lanes, each side of the
    tile plan's 32, past the slot kernel's 16 384), padded slots, and churn
    traces whose tiles evict items they request again: hits, flags, stats,
    the carry and the run's queue chunk by chunk equal to the plain
    version's on the CPU, in the plan the active slots pick."""
    from repro_torch.cachesim import engines as teng
    from repro_torch.kernels.fifo_queue.ops import design, fifo_queue

    if churn:
        n = max(4 * c, 2000)
        trace = _churn_trace(n, c, 20_000, c)
    else:
        n, trace = _evicting_trace(c, 4)
    cpu = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, n_slots=n_slots,
                                                     device="cpu"), n)
    dev = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, n_slots=n_slots,
                                                     device=card), n)
    reset_launch_counts()
    for part in np.array_split(trace, 4):
        ids = torch.from_numpy(np.ascontiguousarray(part))
        fc = torch.empty(ids.shape, dtype=torch.bool)
        fd = torch.empty(ids.shape, dtype=torch.bool, device=card)
        hc, sc = fifo_queue(cpu.slots, cpu.stamps, cpu.t, cpu.queue, ids, fc)
        hd, sd = fifo_queue(dev.slots, dev.stamps, dev.t, dev.queue, ids.to(card), fd)
        assert int(hd) == int(hc) and torch.equal(sd.cpu(), sc) and torch.equal(fd.cpu(), fc)
        for a, b in zip((*dev[:3], *dev.queue), (*cpu[:3], *cpu.queue)):
            assert torch.equal(a.cpu(), b)
    assert launch_counts()["fifo_queue"] == 4
    assert design_counts()["fifo_queue"] == {design(c): 4}
    if n_slots:
        assert bool((dev.slots[c:] == -2).all())


@pytest.mark.parametrize("hit", [False, True], ids=["evicted", "outlives"])
@pytest.mark.parametrize("c", [32, 6000, 40000])
def test_fifo_tile_settles_the_last_request_at_the_edge_of_its_life(card, c, hit):
    """C slots filled in order, then a tile of S - 1 new ids (S the tile's
    requests) and one request of item S - 2 (the tile's last miss evicts it
    first) or S - 1 (it outlives the tile): the card as the CPU."""
    from repro_torch.cachesim import engines as teng
    from repro_torch.kernels.fifo_queue.ops import fifo_queue, tile_requests

    size = tile_requests(c)
    n = c + size
    item = size - 1 if hit else size - 2
    cpu = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, device="cpu"), n)
    dev = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, device=card), n)
    for part in (np.arange(c), np.concatenate([c + np.arange(size - 1), [item]])):
        ids = torch.from_numpy(part.astype(np.int32))
        fc = torch.empty(ids.shape, dtype=torch.bool)
        fd = torch.empty(ids.shape, dtype=torch.bool, device=card)
        hc, _ = fifo_queue(cpu.slots, cpu.stamps, cpu.t, cpu.queue, ids, fc)
        hd, _ = fifo_queue(dev.slots, dev.stamps, dev.t, dev.queue, ids.to(card), fd)
        assert int(hd) == int(hc) and torch.equal(fd.cpu(), fc)
        for a, b in zip((*dev[:3], *dev.queue), (*cpu[:3], *cpu.queue)):
            assert torch.equal(a.cpu(), b)
    assert bool(fc[-1]) == hit


def _churn_trace(n, c, length, seed):
    """C distinct ids, then new ids, ids admitted about C misses ago and
    repeats of the last few: FIFO's oldest items stay in play."""
    rng = np.random.default_rng(seed)
    out, nxt = list(range(c)), c
    for _ in range(length):
        u = rng.random()
        if u < 0.4:
            out.append(nxt % n)
            nxt += 1
        elif u < 0.75:
            out.append(int(rng.integers(max(0, nxt - c - 40), max(1, nxt - c + 40))) % n)
        else:
            out.append(out[-1 - int(rng.integers(0, 8))])
    return np.asarray(out, np.int32)


def test_fifo_at_50000_slots_runs_as_the_cpu(card):
    trace = zipf(1_000_000, 400_000, alpha=0.9, seed=3)
    pd = repro_torch.policy_def("fifo")
    reset_launch_counts()
    got = repro_torch.run(pd, trace, 1_000_000, 50_000, window=100_000)
    assert launch_counts()["fifo_queue"] == 4
    want = repro_torch.run(pd, trace, 1_000_000, 50_000, window=100_000, device="cpu")
    np.testing.assert_array_equal(got.hits, want.hits)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got.carry, want.carry))


@pytest.mark.parametrize("c,n_slots", [(c, None) for c in TREE_CS] + [(23, 90), (1000, 1100)])
@pytest.mark.parametrize("costs", ["unit", "dyadic"])
def test_gds_automaton_matches_plain_bit_for_bit(card, c, n_slots, costs):
    from repro_torch.cachesim import tree_engines as ttree
    from repro_torch.kernels.minpair_automaton.ops import DESIGN_GDS

    n, trace = _evicting_trace(c, 6)
    rng = np.random.default_rng(c)
    sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[rng.integers(0, 4, n)]
    w = None if costs == "unit" else np.asarray([0.5, 1.0, 2.0, 4.0])[rng.integers(0, 4, n)]
    cpu = ttree.init_tree_gds_carry(n, c, n_slots, sizes=sizes, costs=w, device="cpu")
    dev = type(cpu)(*(x.to(card) for x in cpu))
    reset_launch_counts()
    for part in np.array_split(trace, 3):
        ids = torch.from_numpy(np.ascontiguousarray(part))
        fc = torch.empty(ids.shape, dtype=torch.bool)
        fd = torch.empty(ids.shape, dtype=torch.bool, device=card)
        cpu, (hc, sc) = ttree.tree_chunk("gds", cpu, ids, fc)
        dev, (hd, sd) = ttree.tree_chunk("gds", dev, ids.to(card), fd)
        assert int(hd) == int(hc) and torch.equal(sd.cpu(), sc) and torch.equal(fd.cpu(), fc)
        for name, a, b in zip(cpu._fields, dev, cpu):
            assert torch.equal(a.cpu(), b), name
    assert design_counts()["minpair_automaton"] == {DESIGN_GDS: 3}
    assert float(dev.L) > 0.0  # it evicted


@pytest.mark.parametrize("deltas", ["counts", "values"])
@pytest.mark.parametrize("rows_dtype", [torch.int64, torch.int32])
def test_stacked_tree_update_matches_plain(card, deltas, rows_dtype):
    """A sized chunk's shape (4 classes of 65 536 buckets, 2000 deltas, a
    quarter of them skipped) and a run of 2000 deltas under one node: one
    launch, bit for bit the plain version on the card and the CPU."""
    from repro_torch.kernels.prefix_tree.ops import stacked_tree_update_, tree_storage
    from repro_torch.kernels.prefix_tree.ref import stacked_tree_update_ref

    gen = torch.Generator().manual_seed(7)
    kk, v, q = 4, OGB_TREE_BUCKETS, 2000
    base = torch.rand((kk, tree_storage(v, 64)), generator=gen) * 50
    for hot in (False, True):
        rows = torch.randint(0, kk, (q,), generator=gen).to(rows_dtype)
        idx = (torch.full((q,), 777) if hot else torch.randint(0, v, (q,), generator=gen))
        idx = torch.where(torch.rand(q, generator=gen) < 0.25, -1, idx).to(rows_dtype)
        delta = (torch.randint(0, 2, (q,), generator=gen) * 2 - 1).float() if deltas == "counts" \
            else torch.rand(q, generator=gen) - 0.5
        want = stacked_tree_update_ref(base.clone(), v, 64, rows, idx, delta)
        reset_launch_counts()
        got = stacked_tree_update_(base.to(card), v, 64, rows.to(card), idx.to(card),
                                   delta.to(card))
        assert launch_counts()["tree_update"] == 1
        assert torch.equal(got.cpu(), want)
        plain = stacked_tree_update_ref(base.to(card), v, 64, rows.to(card), idx.to(card),
                                        delta.to(card))
        assert torch.equal(got, plain)


@pytest.mark.parametrize("n,radix", [(262_144, 16), (65536, 64), (100, 16)])
def test_int32_tree_update_matches_plain(card, n, radix):
    gen = torch.Generator().manual_seed(n)
    tree = tree_build_ref(torch.randint(0, 5, (n,), generator=gen, dtype=torch.int32), radix)
    idx = torch.randint(-3, n, (5000,), generator=gen)
    delta = torch.randint(-3, 4, (5000,), generator=gen, dtype=torch.int32)
    want = tree_update_ref(tree.clone(), n, radix, idx, delta)
    reset_launch_counts()
    got = tree_update_(tree.to(card), n, radix, idx.to(card), delta.to(card))
    assert launch_counts()["tree_update"] == 1 and torch.equal(got.cpu(), want)


def _plan_case(name, seed, index_dtype):
    """(trees, n, radix, rows or None, idx, delta) on the CPU: the cases the
    hashed-runs plan is held to (tests/test_torch_tree_update_design.py
    emulates it on the same kinds)."""
    gen = torch.Generator().manual_seed(seed)
    kk, v, q = 4, OGB_TREE_BUCKETS, 2000
    base = torch.rand((kk, tree_storage(v, 64)), generator=gen) * 50
    rows = torch.randint(0, kk, (q,), generator=gen)
    masked = torch.rand(q, generator=gen) < 0.25
    sign = torch.randint(0, 2, (q,), generator=gen) * 2.0 - 1.0
    if name == "sized counts":  # a sized chunk's bucket moves, a quarter skipped
        idx = torch.where(masked, -1, torch.randint(0, 400, (q,), generator=gen) * 97)
        case = (base, v, 64, rows, idx, sign)
    elif name == "sized values":
        idx = torch.where(masked, -1, torch.randint(0, 400, (q,), generator=gen) * 97)
        case = (base, v, 64, rows, idx, sign * 3 * torch.rand(q, generator=gen))
    elif name == "one node":  # a run of 2000 under one leaf of one tree
        case = (base, v, 64, torch.full((q,), 2), torch.full((q,), 40_000),
                torch.rand(q, generator=gen) * 4 - 2)
    elif name == "twelve decades":  # input order: +-1e8 cancelling around small deltas
        where = torch.randint(0, 16, (q // 4,), generator=gen)
        small = torch.randn(q // 2, generator=gen) * 10.0 ** (
            torch.rand(q // 2, generator=gen) * 12 - 14)
        big = torch.full((q // 4,), 1e8)
        delta = torch.stack([big, small[:q // 4], -big, small[q // 4:]], 1).reshape(-1)
        case = (torch.zeros_like(base), v, 64, (where % kk).repeat_interleave(4),
                ((where // kk) * 4099).repeat_interleave(4), delta)
    elif name == "nan and infinity":
        delta = torch.rand(q, generator=gen) * 2 - 1
        delta[[5, 900]] = float("nan")
        delta[[77, 1500]] = torch.tensor([float("inf"), -float("inf")])
        case = (base, v, 64, rows, torch.randint(0, 2000, (q,), generator=gen) * 31, delta)
    elif name == "out of range":  # ids past the leaves, rows past the trees
        idx = torch.randint(-5, v + 5, (q,), generator=gen)
        idx[:40] = v + torch.arange(40)
        case = (base, v, 64, torch.randint(-2, kk + 2, (q,), generator=gen), idx,
                torch.rand(q, generator=gen) * 4 - 2)
    elif name == "exactness edge":  # magnitudes over 2^(29 - log2 2000): any order
        field = torch.randint(90, 90 + 29 - 11 + 1, (q,), generator=gen)
        field[:2] = torch.tensor([90, 90 + 29 - 11])
        bits = (field << 23) | 0x7FFFFF
        delta = bits.to(torch.int32).view(torch.float32) * sign
        case = (base, v, 64, rows, torch.full((q,), 1234), delta)
    elif name == "past the shared workspace":  # ON_CHIP_DELTAS + 1 deltas: a global one
        q = ON_CHIP_DELTAS + 1
        case = (base, v, 64, torch.randint(0, kk, (q,), generator=gen),
                torch.randint(-1, v, (q,), generator=gen),
                torch.randint(0, 2, (q,), generator=gen) * 2.0 - 1.0)
    else:  # int32: 2000 deltas scattered over a ring's 262 144 leaves, nodes near the wrap
        m = 262_144
        tree = tree_build_ref(torch.randint(0, 2, (m,), dtype=torch.int32, generator=gen), 16)
        tree[m:] = 2**31 - 20
        case = (tree, m, 16, None, torch.randint(-1, m, (q,), generator=gen),
                torch.randint(-9, 10, (q,), dtype=torch.int32, generator=gen))
    trees, n, radix, rws, idx, delta = case
    return (trees, n, radix, None if rws is None else rws.to(index_dtype), idx.to(index_dtype),
            delta.to(trees.dtype))


def _same_bits_or_nan(a, b):
    """Equal, NaN where NaN (a NaN's payload is the device's own)."""
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(a, dtype=torch.bool)
    return torch.equal(nan, torch.isnan(b) if b.is_floating_point() else nan) and \
        torch.equal(a[~nan], b[~nan])


PLAN_CASES = ["sized counts", "sized values", "one node", "twelve decades", "nan and infinity",
              "out of range", "exactness edge", "past the shared workspace", "int32 scattered"]


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_the_hashed_runs_plan_equals_plain_bit_for_bit(card, name, index_dtype):
    """Each case in one launch, bit for bit the plain version on the card
    and on the CPU, in the order of the adds update_order names; two runs
    bit for bit; nodes no delta reaches unwritten."""
    trees, n, radix, rows, idx, delta = _plan_case(name, PLAN_CASES.index(name), index_dtype)
    want = (tree_update_ref(trees.clone(), n, radix, idx, delta) if rows is None else
            stacked_tree_update_ref(trees.clone(), n, radix, rows, idx, delta))
    args = [t.to(card) for t in (idx, delta)]
    if rows is not None:
        args.insert(0, rows.to(card))
    expected = INPUT_ORDER if name in ("twelve decades", "nan and infinity") else EXACT_ANY_ORDER
    assert update_order(n, idx, delta, rows, trees.shape[0] if rows is not None else 1) == expected

    def launch():
        out = trees.to(card)
        if rows is None:
            return tree_update_(out, n, radix, *args)
        return stacked_tree_update_(out, n, radix, *args)

    reset_launch_counts()
    got = launch()
    assert launch_counts()["tree_update"] == 1
    assert design_counts()["tree_update"] == {
        UPDATE_DESIGN if idx.numel() <= ON_CHIP_DELTAS else UPDATE_DESIGN_L2: 1}
    assert _same_bits_or_nan(got.cpu(), want)
    plain = (tree_update_ref(trees.to(card), n, radix, *args) if rows is None else
             stacked_tree_update_ref(trees.to(card), n, radix, *args))
    # PyTorch's accumulate on the card sums a long run of one index across a
    # warp, not in input order: where the deltas cancel (+-1e8) the plain
    # version on the card is not the CPU's, and the kernel is held to the CPU
    if name != "twelve decades":
        assert _same_bits_or_nan(got, plain)
    assert _same_bits_or_nan(launch(), got)
    reached = torch.zeros(trees.numel(), dtype=torch.bool)
    ok = (idx >= 0) & (idx < n)
    base = torch.zeros_like(idx, dtype=torch.int64)
    if rows is not None:
        ok &= (rows >= 0) & (rows < trees.shape[0])
        base = rows.long() * trees.shape[1]
    node = idx.long()
    for off in tree_offsets(n, radix):
        reached[(base + off + node)[ok]] = True
        node = node // radix
    assert torch.equal(got.cpu().view(-1)[~reached], trees.view(-1)[~reached])
    if name == "int32 scattered":
        assert bool((got.cpu()[n:] < 0).any())  # a node wrapped past 2^31 - 1


@pytest.mark.parametrize("name", ["sized counts", "twelve decades", "int32 scattered"])
def test_the_hashed_runs_plan_replays_in_a_cuda_graph(card, name):
    """A stacked (and an int32) update captured in a CUDA graph replays to
    the eager result, bit for bit: the plan keeps no scratch between calls."""
    trees, n, radix, rows, idx, delta = _plan_case(name, 3, torch.int64)
    args = [t.to(card) for t in (idx, delta)]
    if rows is not None:
        args.insert(0, rows.to(card))

    def launch(out):
        if rows is None:
            return tree_update_(out, n, radix, *args)
        return stacked_tree_update_(out, n, radix, *args)

    eager = launch(trees.to(card))
    work = trees.to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(trees.to(card))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch(work)
    for _ in range(2):
        work.copy_(trees.to(card))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work, eager)


def _sized_state(card, chunks, n=200_000, c=10_000, batch=1000):
    """A sized carry after ``chunks`` chunks of zipf on the CPU, and the
    same carry on the card."""
    from repro_torch.cachesim.scenarios import SIZE_SLABS

    sizes = np.asarray(SIZE_SLABS)[np.minimum(np.arange(n) * 4 // n, 3)]
    cap = int(round(c * float(sizes.mean())))
    trace = zipf(n, chunks * batch, alpha=0.9, seed=11)
    pd = repro_torch.policy_def("ogb_sized")
    res = repro_torch.run(pd, trace, n, cap, window=batch, sizes=sizes, device="cpu")
    cpu = res.carry
    return cpu, type(cpu)(*(x.to(card) for x in cpu.tensors())), sizes, cap


def test_solve_sized_matches_plain(card):
    """The sized solve at a mid-run state and with more busy groups than
    its shared memory holds (every bucket of every class non-empty): the
    card's iterate equal to the plain version's on the card and the CPU."""
    from repro_torch.kernels.prefix_tree.kernel import solve_sized
    from repro_torch.kernels.prefix_tree.ref import solve_sized_ref
    from repro_torch.kernels.prefix_tree.ops import tree_build

    cpu, dev, _, _ = _sized_state(card, 30)
    v = OGB_TREE_BUCKETS
    hi = dev.wb * float(v)
    reset_launch_counts()
    got = solve_sized(dev.ycnt, dev.ysum, v, dev.s, dev.cap, dev.rho, hi, 30)
    assert launch_counts()["bucket_mass"] == 1
    want = solve_sized_ref(cpu.ycnt[:, :v], cpu.ysum[:, :v], cpu.s, cpu.cap, cpu.rho, hi.cpu(), 30)
    assert torch.equal(got.cpu(), want)
    gen = torch.Generator().manual_seed(3)
    cnt = torch.randint(1, 5, (4, v), generator=gen).float()
    tot = cnt * torch.rand((4, v), generator=gen) * 3
    ycnt = torch.stack([tree_build(x, 64) for x in cnt]).to(card)
    ysum = torch.stack([tree_build(x, 64) for x in tot]).to(card)
    s = dev.s
    cap = torch.tensor(float(cnt.sum()) * 0.2, device=card)
    lo, hi = torch.zeros((), device=card), torch.tensor(50.0, device=card)
    got = solve_sized(ycnt, ysum, v, s, cap, lo, hi, 30)
    want = solve_sized_ref(cnt, tot, s.cpu(), cap.cpu(), lo.cpu(), hi.cpu(), 30)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("groups", [1, 6, 31, 32, 33, 200])
def test_solve_sized_plans_at_their_edges(card, groups):
    """Built instances with G groups of 64 buckets that hold an item (4
    classes of 65 536 buckets): the card's iterate at 0, 1 and 30 steps
    equal to the plain version's on the card and the CPU, in the plan G
    picks (a warp a group to 32 groups, the block past them), as its tally
    counts it."""
    from repro_torch.kernels.prefix_tree.kernel import (
        SIZED_FEW_GROUPS,
        read_sized_tally,
        solve_sized,
    )
    from repro_torch.kernels.prefix_tree.ref import sized_groups, solve_sized_ref

    v, kk = OGB_TREE_BUCKETS, 4
    gen = torch.Generator().manual_seed(groups)
    cnt = torch.zeros(kk, v)
    for p in torch.randperm(kk * (v // 64), generator=gen)[:groups].tolist():
        k, g = divmod(p, v // 64)
        c = torch.randint(0, 6, (64,), generator=gen).float()
        c[int(torch.randint(0, 64, (1,), generator=gen))] += 1.0
        cnt[k, g * 64:(g + 1) * 64] = c * 2.0 ** torch.randint(0, 40, (64,), generator=gen)
    tot = cnt * torch.rand((kk, v), generator=gen) * 3
    assert sized_groups(cnt).shape[0] == groups
    s = torch.tensor([1.0, 4.0, 16.0, 64.0])
    cap = torch.tensor(0.3 * float((cnt * s[:, None]).sum()))
    lo, hi = torch.tensor(0.0), torch.tensor(0.25)
    ycnt = torch.stack([tree_build(x, 64) for x in cnt]).to(card)
    ysum = torch.stack([tree_build(x, 64) for x in tot]).to(card)
    plan = "few groups" if groups <= SIZED_FEW_GROUPS else "block"
    for iters in (0, 1, 30):
        before = read_sized_tally(ycnt.device)
        got = solve_sized(ycnt, ysum, v, s.to(card), cap.to(card), lo.to(card), hi.to(card),
                          iters)
        after = read_sized_tally(ycnt.device)
        assert after[plan] == before[plan] + 1
        assert after["groups"].get(groups, 0) == before["groups"].get(groups, 0) + 1
        want = solve_sized_ref(cnt, tot, s, cap, lo, hi, iters)
        plain = solve_sized_ref(ycnt[:, :v], ysum[:, :v], s.to(card), cap.to(card), lo.to(card),
                                hi.to(card), iters)
        assert torch.equal(got.cpu(), want) and torch.equal(got, plain)


def test_ogb_sized_on_the_card_matches_the_cpu(card):
    """200 chunks of a sized run on the card: each chunk's hits, byte hits
    and step of rho equal to the CPU's, its reward and occupancy within
    float32 summation order (1e-6 relative); three stacked tree updates and
    one sized solve a chunk, and at most one read of the device in 20
    chunks."""
    from repro_torch.cachesim.scenarios import SIZE_SLABS

    n, c = 200_000, 10_000
    sizes = np.asarray(SIZE_SLABS)[np.minimum(np.arange(n) * 4 // n, 3)]
    cap = int(round(c * float(sizes.mean())))
    trace = zipf(n, 200_000, alpha=0.9, seed=12)
    pd = repro_torch.policy_def("ogb_sized")
    reset_launch_counts()
    got = repro_torch.run(pd, trace, n, cap, window=1000, sizes=sizes)
    counts = launch_counts()
    assert counts["tree_update"] == 600 and counts["bucket_mass"] == 200
    want = repro_torch.run(pd, trace, n, cap, window=1000, sizes=sizes, device="cpu")
    for field in ("hits", "aux", "byte_hits"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-6)
    np.testing.assert_allclose(got.occupancy, want.occupancy, rtol=1e-6)
    assert got.extras["host_syncs"] <= 200 // 20


@pytest.mark.parametrize("kind", ["gds", "fifo", "ogb_sized"])
def test_sized_runs_read_nothing_on_the_host_in_a_chunk(card, kind):
    """Steps of a started sized run under torch's sync debug mode "error"."""
    from repro_torch.cachesim.scenarios import SIZE_SLABS

    n, c = 20_000, 1000
    sizes = np.asarray(SIZE_SLABS)[np.minimum(np.arange(n) * 4 // n, 3)]
    trace = zipf(n, 40_000, alpha=0.9, seed=2).astype(np.int32)
    pd = repro_torch.policy_def(kind)
    cap = int(round(c * float(sizes.mean()))) if kind == "ogb_sized" else c
    carry = pd.start(pd.init(n, cap, horizon=len(trace), sizes=sizes), n)
    chunks = torch.from_numpy(trace.reshape(40, 1000)).to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(40):
            carry, out = pd.step(carry, chunks[i])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.byte_hits is not None


def test_sized_cdn_mini_on_the_card_matches_the_cpu(card):
    from repro_torch.cachesim.scenarios import run_scenario

    reset_launch_counts()
    res = run_scenario("sized_cdn", "mini")
    counts = launch_counts()
    assert counts["minpair_automaton"] == 3 * 20 and counts["tree_lru"] == 20
    assert counts["bucket_mass"] == 20 and counts["tree_update"] == 60
    cpu = run_scenario("sized_cdn", "mini", device="cpu")
    for row in ("LRU", "LFU", "FTPL", "GDS", "OPT(static)"):
        assert res.rows[row]["hit_ratio"] == cpu.rows[row]["hit_ratio"], row
        assert res.rows[row]["byte_hit_ratio"] == cpu.rows[row]["byte_hit_ratio"], row
    ogb, ogb_cpu = res.rows["OGB_sized_tree"], cpu.rows["OGB_sized_tree"]
    assert (ogb["hit_ratio"], ogb["byte_hit_ratio"]) == (ogb_cpu["hit_ratio"],
                                                         ogb_cpu["byte_hit_ratio"])
    assert ogb["byte_regret"] == pytest.approx(ogb_cpu["byte_regret"], rel=1e-6)


# -- the redesigned automaton kernels: the min-pair kernel's two plans (its
# least-leaf pointers in shared memory or in L2) and the tree LRU's shared
# levels ----------------------------------------------------------------------

#: slots whose least-leaf pointers no longer fit in shared memory (20 636
#: nodes above the leaves): the min-pair kernel's L2 plan
L2_SLOTS = 1_300_000


def _minpair_carry(kind, n, c, n_slots=None, seed=0):
    from repro_torch.cachesim import tree_engines as ttree

    if kind == "gds":
        rng = np.random.default_rng(seed)
        sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[rng.integers(0, 4, n)]
        costs = np.asarray([0.5, 1.0, 2.0, 4.0])[rng.integers(0, 4, n)]
        return ttree.init_tree_gds_carry(n, c, n_slots, sizes=sizes, costs=costs, device="cpu")
    return ttree.init_tree_engine_carry(kind, n, c, n_slots=n_slots, seed=seed,
                                        horizon=10**6, device="cpu")


def _minpair_case(kind, cpu, trace, parts, card):
    """One min-pair automaton from ``cpu``'s carry on the CPU and the card,
    chunk by chunk: hits, flags, stats and every carry leaf equal."""
    from repro_torch.cachesim import tree_engines as ttree

    dev = type(cpu)(*(x.to(card) for x in cpu))
    for part in np.array_split(trace, parts):
        ids = torch.from_numpy(np.ascontiguousarray(part))
        fc = torch.empty(ids.shape, dtype=torch.bool)
        fd = torch.empty(ids.shape, dtype=torch.bool, device=card)
        cpu, (hc, sc) = ttree.tree_chunk(kind, cpu, ids, fc)
        dev, (hd, sd) = ttree.tree_chunk(kind, dev, ids.to(card), fd)
        assert int(hd) == int(hc) and torch.equal(sd.cpu(), sc) and torch.equal(fd.cpu(), fc)
        for name, a, b in zip(cpu._fields, dev, cpu):
            assert torch.equal(a.cpu(), b), name
    return dev


@pytest.mark.parametrize("c,n_slots", [(64, None), (65, None), (4097, None), (65, 130),
                                       (4097, 4200)])
@pytest.mark.parametrize("kind", ["lfu", "ftpl", "gds"])
def test_minpair_at_its_radix_edges_matches_plain(card, kind, c, n_slots):
    """One level of 64 leaves, two levels from 65 (a top of 2 nodes), three
    from 4097 (a top of 2), and padded slots past each edge."""
    from repro_torch.kernels.minpair_automaton.ops import DESIGN, DESIGN_GDS

    n, trace = _evicting_trace(c, 11)
    reset_launch_counts()
    dev = _minpair_case(kind, _minpair_carry(kind, n, c, n_slots, seed=c), trace, 3, card)
    want = DESIGN_GDS if kind == "gds" else DESIGN
    assert design_counts()["minpair_automaton"] == {want: 3}
    if n_slots:
        assert bool((dev.slots[c:] == -2).all())


@pytest.mark.parametrize("c", [100, 5000])
@pytest.mark.parametrize("kind", ["lfu", "ftpl", "gds"])
def test_minpair_hits_on_their_groups_least_leaf_match_plain(card, kind, c):
    """C distinct items, then the same items over and over in the same order:
    every request hits, and for LFU (equal counts, the oldest tick least)
    each hit is on the least leaf of its group and of the tree, the path
    that recomputes the nodes above the leaf."""
    n = 4 * c
    fill = np.random.default_rng(c).permutation(n)[:c].astype(np.int32)
    trace = np.concatenate([fill] * 6)
    dev = _minpair_case(kind, _minpair_carry(kind, n, c, seed=c), trace, 4, card)
    assert int((dev.slots >= 0).sum()) == c


def test_gds_misses_that_lower_the_pair_match_plain(card):
    """Unit costs and sizes over an L of 1e8, where L + 1 rounds to L: every
    key has the same H, so the id orders them, and a newcomer of a smaller
    id than its victim takes a pair below the victim's.  Decreasing ids
    make every miss do so."""
    from repro_torch.cachesim import tree_engines as ttree

    n, c = 3000, 300
    cpu = ttree.init_tree_gds_carry(n, c, device="cpu")
    cpu.L.fill_(1e8)
    trace = np.concatenate([np.arange(n - 1, -1, -1)] * 2).astype(np.int32)
    dev = _minpair_case("gds", cpu, trace, 4, card)
    assert float(dev.L) == 1e8 and int((dev.slots >= 0).sum()) == c


@pytest.mark.parametrize("kind", ["lfu", "ftpl", "gds"])
def test_minpair_pointers_in_l2_match_plain(card, kind):
    """Slots padded past the shared-memory pointers: the L2 plan."""
    from repro_torch.kernels.minpair_automaton.ops import DESIGN_GDS_L2, DESIGN_L2, design

    c = 1000
    assert design(L2_SLOTS, kind == "gds") == (DESIGN_GDS_L2 if kind == "gds" else DESIGN_L2)
    n, trace = _evicting_trace(c, 12)
    reset_launch_counts()
    dev = _minpair_case(kind, _minpair_carry(kind, n, c, L2_SLOTS, seed=1), trace, 3, card)
    assert design_counts()["minpair_automaton"] == {design(L2_SLOTS, kind == "gds"): 3}
    assert bool((dev.slots[c:] == -2).all())


@pytest.mark.parametrize("ring", [2**12, 2**18, 2**21])
def test_tree_lru_rings_with_forced_compactions_match_plain(card, ring):
    """The ring's levels from 1 (2^12, 2^18) or 2 (2^21) up in shared
    memory: chunk by chunk from a position near the ring's end, so the first
    chunk compacts (and, at 2^12, every other), against the plain version on
    the CPU."""
    from repro_torch.cachesim import tree_engines as ttree
    from repro_torch.kernels.tree_lru.ops import CHUNK, COMPACTION, tree_lru

    c, window = (300, 1000) if ring == 2**12 else (5000, 20_000)
    n = 8 * c
    trace = zipf(n, 4 * window, alpha=0.8, seed=ring % 97).astype(np.int32)
    cpu = ttree.init_tree_engine_carry("lru", n, c, ring=ring, device="cpu")
    ttree.tree_chunk("lru", cpu, torch.from_numpy(trace[:window]))
    cpu.pos.fill_(ring - window // 2)  # the next chunk must compact
    dev = [x.to(card) for x in cpu.tensors()]
    reset_launch_counts()
    for i in range(1, 4):
        ids = torch.from_numpy(trace[i * window:(i + 1) * window])
        fc = torch.empty(window, dtype=torch.bool)
        fd = torch.empty(window, dtype=torch.bool, device=card)
        hc, sc = tree_lru(*cpu.tensors()[:5], ids, ring, flags=fc)
        hd, sd = tree_lru(*dev[:5], ids.to(card), ring, flags=fd)
        assert int(hd) == int(hc) and torch.equal(sd.cpu(), sc) and torch.equal(fd.cpu(), fc)
        for a, b in zip(dev, cpu.tensors()):
            assert torch.equal(a.cpu(), b)
    designs = design_counts()["tree_lru"]
    assert designs[CHUNK] == 3 and designs[COMPACTION] == 3


# ---------------------------------------------------------------------------
# a sweep's grid: each batched kernel, a launch for all combos, each row bit
# for bit its combo's own launch
# ---------------------------------------------------------------------------
GRID_SIZES = (1, 2, 7, 18)


def _warm_rows(s, n, seed, card):
    """(R, N) f rows of a mid-run shape, one histogram, and a combo's eta,
    capacity, bracket and seed each (row r's capacity and eta its own)."""
    gen = torch.Generator().manual_seed(seed)
    caps = torch.tensor([0.05 * n * (1 + r % 3) for r in range(s)])
    f = torch.rand((s, n), generator=gen) * (2.0 * caps[:, None] / n)
    b = max(1, n // 1000)
    counts = histogram(torch.randint(0, n, (b,), generator=gen, dtype=torch.int32).to(card), n)
    eta = 0.02 + 0.05 * torch.rand(s, generator=gen)
    hi = warm_bracket_hi(eta * float(b))
    tau0 = hi * torch.rand(s, generator=gen)
    return (f.to(card), counts, eta.to(card), caps.to(card), torch.zeros(s, device=card),
            hi.to(card), tau0.to(card))


@pytest.mark.parametrize("n", [20_000, 1_000_000])
@pytest.mark.parametrize("s", GRID_SIZES)
def test_batched_warm_solve_rows_equal_their_single_launches(card, s, n):
    """R rows in one launch (each plan: resident where every tile has a
    block, streaming past it, as at 2 or more rows of 1e6): each row's tau
    and f' bit for bit its own one-row launch, tau within 1e-6 of the plain
    version's row by row, f' the plain clip at the kernel's tau."""
    from repro_torch.kernels.capped_simplex.ops import warm_plan
    from repro_torch import kernels

    f, counts, eta, cap, lo, hi, tau0 = _warm_rows(s, n, s * 7 + n % 13, card)
    reset_launch_counts()
    got_f, got_tau = project_warm(f, counts, eta, cap, lo, hi, tau0, 5)
    assert launch_counts()["mass"] == 1 and got_tau.shape == (s,) and got_f.shape == (s, n)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    resident = s * -(-n // 8192) <= sms
    where = "in registers" if resident else "re-read from L2"
    assert kernels.design_counts()["mass"] == {f"persistent, y {where}": 1}
    assert warm_plan(n, 5, sms, 1, 1, rows=s)["resident"] == resident
    tau_only = project_warm_tau(f, counts, eta, cap, lo, hi, tau0, 5)
    assert torch.equal(tau_only, got_tau)
    for r in range(s):
        one_f, one_tau = project_warm(f[r].contiguous(), counts, eta[r], cap[r], lo[r], hi[r],
                                      tau0[r], 5)
        assert torch.equal(one_tau, got_tau[r]) and torch.equal(one_f, got_f[r])
        want = project_warm_tau_ref(f[r], counts, eta[r], cap[r], lo[r], hi[r], tau0[r], 5)
        assert abs(float(want) - float(got_tau[r])) <= 1e-6
        assert torch.equal(got_f[r], apply_ref(f[r], counts, eta[r], got_tau[r]))


def test_batched_warm_solve_past_one_launch(card):
    """Past the tiles one launch's streaming blocks take at 64 a block: a
    grid of rows of 1e6 too many for them runs a launch a group of rows,
    and one row past them alone takes its blocks' tiles in rounds of 64.
    Each row's tau and f' bit for bit its own one-row launch, tau within
    1e-6 of the plain version, f' the plain clip at the kernel's tau."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.capped_simplex.ops import (
        WARM_ITEMS, WARM_THREADS, WARM_TILES_PER_BLOCK, warm_groups, warm_plan)

    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    per_sm = _build.blocks_per_sm("mass", "repro_project_warm_occupancy", index, False)
    cap_tiles = sms * per_sm * WARM_TILES_PER_BLOCK
    tile = WARM_THREADS * WARM_ITEMS
    for s, n in ((cap_tiles // 123 + 2, 1_000_000), (2, cap_tiles * tile + 3 * tile + 5)):
        f, counts, eta, cap, lo, hi, tau0 = _warm_rows(s, n, s + n % 17, card)
        groups = warm_groups(n, sms, per_sm, s)
        assert len(groups) >= 2
        reset_launch_counts()
        got_f, got_tau = project_warm(f, counts, eta, cap, lo, hi, tau0, 5)
        assert launch_counts()["mass"] == len(groups)
        for r in range(s):
            one_f, one_tau = project_warm(f[r].contiguous(), counts, eta[r], cap[r], lo[r],
                                          hi[r], tau0[r], 5)
            assert torch.equal(one_tau, got_tau[r]) and torch.equal(one_f, got_f[r])
            want = project_warm_tau_ref(f[r], counts, eta[r], cap[r], lo[r], hi[r], tau0[r], 5)
            assert abs(float(want) - float(got_tau[r])) <= 1e-6
            assert torch.equal(got_f[r], apply_ref(f[r], counts, eta[r], got_tau[r]))
        if s == 2:  # one row a launch, its blocks past 64 tiles each
            assert warm_plan(n, 5, sms, 1, per_sm)["per_block"] > WARM_TILES_PER_BLOCK
        del f, got_f, one_f
        torch.cuda.empty_cache()


def _grid_sweep(kind, caps, seeds, trace, n, window, card, **init_kw):
    """``sweep`` on the card and the CPU and each combo's ``run`` on the
    card: the hits and every final carry leaf equal; returns the card's
    sweep and its launches."""
    pd = repro_torch.policy_def(kind)
    reset_launch_counts()
    got = repro_torch.sweep(pd, trace, n, caps, seeds=seeds, window=window, device=card,
                            track_opt=False, **init_kw)
    launches, designs = launch_counts(), design_counts()
    cpu = repro_torch.sweep(pd, trace, n, caps, seeds=seeds, window=window, device="cpu",
                            track_opt=False, **init_kw)
    assert pd.batched is not None and np.array_equal(got.hits, cpu.hits)
    for r, combo in enumerate(got.combos):
        one = repro_torch.run(pd, trace, n, combo["capacity"], window=window,
                              seed=combo["seed"], n_slots=max(caps), device=card,
                              track_opt=False, **init_kw)
        assert np.array_equal(one.hits, got.hits[r])
        for a, b, c in zip(got.carries[r], one.carry, cpu.carries[r]):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    return got, launches, designs


def _grid_caps(s, base):
    """s combos: capacities base, 2 base, ... (mixed), two seeds past 9."""
    caps = [base * (1 + r) for r in range(min(s, 9))]
    return caps, (0, 1) if s > 9 else (0,)


@pytest.mark.parametrize("s", GRID_SIZES)
@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl", "fifo"])
def test_batched_automata_rows_equal_their_single_runs(card, kind, s):
    """Mixed capacities padded to the largest, a launch a chunk for the
    grid (FIFO: one a plan, its combos below 32 active slots on the chain
    plan and the rest on the tile plan in one grid), each row's hits and
    final carry bit for bit its single run on the card and the CPU's."""
    from repro_torch.kernels.fifo_queue.ops import DESIGN, DESIGN_CHAIN

    caps, seeds = _grid_caps(s, 30 if kind == "fifo" else 23)
    n, trace = _evicting_trace(max(caps), s)
    window = len(trace) // 4
    got, launches, designs = _grid_sweep(kind, caps, seeds, trace, n, window, card)
    chunks = got.hits.shape[1]
    name = {"lru": "tree_lru", "fifo": "fifo_queue"}.get(kind, "minpair_automaton")
    if kind == "fifo":
        plans = {DESIGN_CHAIN: chunks} if max(caps) < 32 else {DESIGN: chunks}
        if min(caps) < 32 <= max(caps):
            plans = {DESIGN: chunks, DESIGN_CHAIN: chunks}
        assert designs["fifo_queue"] == plans
    elif kind == "lru":
        from repro_torch.kernels.tree_lru.ops import CHUNK

        assert designs["tree_lru"][CHUNK] == chunks
    else:
        assert launches[name] == chunks


@pytest.mark.parametrize("s", [2, 7])
def test_batched_tree_lru_with_forced_compactions(card, s):
    """A ring barely above 4C and long chunks: each combo's compactions,
    decided on the card, beside one chunk launch for the grid."""
    from repro_torch.kernels.tree_lru.ops import CHUNK, COMPACTION

    caps, seeds = _grid_caps(s, 23)
    n, trace = _evicting_trace(max(caps), 9)
    ring = 1 << max(8, (4 * max(caps) - 1).bit_length())
    window = 3 * ring // 4 - 16
    got, launches, designs = _grid_sweep("lru", caps, seeds, trace, n, window, card, ring=ring)
    assert designs["tree_lru"][CHUNK] == got.hits.shape[1]
    assert designs["tree_lru"].get(COMPACTION, 0) == launches["segsum"] >= 1


@pytest.mark.parametrize("kind", ["lfu", "ftpl"])
def test_batched_minpair_pointers_in_l2(card, kind):
    """Slots padded past the shared-memory pointers (the L2 plan), a
    pointer scratch a combo: the grid's chunks bit for bit each combo's
    single launch and the plain version's."""
    from repro_torch.cachesim import tree_engines as ttree
    from repro_torch.kernels.minpair_automaton.ops import DESIGN_L2

    n, trace = _evicting_trace(1000, 12)
    cpu = [_minpair_carry(kind, n, c, L2_SLOTS, seed=c) for c in (700, 1000, 300)]
    grid = ttree.grid_start([type(c)(*(x.to(card) for x in c)) for c in cpu])
    one = [type(c)(*(x.to(card) for x in c)) for c in cpu]
    reset_launch_counts()
    for part in np.array_split(trace, 3):
        ids = torch.from_numpy(np.ascontiguousarray(part))
        fg = torch.empty((3,) + ids.shape, dtype=torch.bool, device=card)
        grid, (hg, _) = ttree.tree_chunk(kind, grid, ids.to(card), fg)
        for r in range(3):
            fc = torch.empty(ids.shape, dtype=torch.bool)
            _, (hc, _) = ttree.tree_chunk(kind, cpu[r], ids, fc)
            _, (ho, _) = ttree.tree_chunk(kind, one[r], ids.to(card))
            assert int(hg[r]) == int(hc) == int(ho) and torch.equal(fg[r].cpu(), fc)
    for r, row in enumerate(ttree.grid_split(grid)):
        for a, b, c in zip(row, one[r], cpu[r]):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert design_counts()["minpair_automaton"] == {DESIGN_L2: 3 + 3 * 3}


@pytest.mark.parametrize("s", GRID_SIZES)
def test_batched_dense_ogb_rows_equal_their_single_runs(card, s):
    """Dense ogb (Poisson): one histogram and one warm projection a chunk
    for the grid, each row's f and tau bit for bit its single run, its hits
    equal, reward and occupancy within 1e-5 relative."""
    caps, seeds = _grid_caps(s, 40)
    etas, seeds = ([None, 0.05], (0,)) if s > 9 else ([None], seeds)
    n = 3000
    trace = zipf(n, 40_000, alpha=0.8, seed=s).astype(np.int32)
    pd = repro_torch.policy_def("ogb")
    reset_launch_counts()
    got = repro_torch.sweep(pd, trace, n, caps, etas=etas, seeds=seeds, window=500,
                            device=card, track_opt=False)
    launches = launch_counts()
    assert len(got.combos) == s
    chunks = got.hits.shape[1]
    assert launches["histogram"] == chunks and launches["mass"] == chunks
    for r, combo in enumerate(got.combos):
        one = repro_torch.run(pd, trace, n, combo["capacity"], window=500, seed=combo["seed"],
                              eta=combo["eta"], device=card, track_opt=False)
        assert torch.equal(one.carry.f, got.carries[r].f)
        assert torch.equal(one.carry.tau, got.carries[r].tau)
        assert np.array_equal(one.hits, got.hits[r]) and np.array_equal(one.aux, got.aux[r])
        np.testing.assert_allclose(got.reward[r], one.reward, rtol=1e-5)
        np.testing.assert_allclose(got.occupancy[r], one.occupancy, rtol=1e-5)


# -- a fleet's tenants: a row of ids a row of the grid ---------------------------

FLEET_SIZES = (1, 3, 40)


@pytest.mark.parametrize("n", [1, 4097, 100_000])
@pytest.mark.parametrize("e", FLEET_SIZES)
def test_histogram_rows_equal_their_one_row_calls(card, n, e):
    """(E, B) ids in one bin-tiles launch (rows off 16 bytes where n is no
    multiple of 4): each row bit for bit its own one-row call and the plain
    version's."""
    from repro_torch.kernels.scatter_counts.ops import BIN_TILES

    gen = torch.Generator().manual_seed(e * 7 + n % 11)
    ids = torch.randint(-2, n + 3, (e, 500), generator=gen, dtype=torch.int32).to(card)
    reset_launch_counts()
    got = histogram(ids, n)
    assert launch_counts()["histogram"] == 1 and design_counts()["histogram"] == {BIN_TILES: 1}
    assert got.shape == (e, n) and torch.equal(got.cpu(), histogram_ref(ids.cpu(), n))
    for r in range(e):
        assert torch.equal(got[r], histogram(ids[r].contiguous(), n))


@pytest.mark.parametrize("n", [20_000, 1_000_000])
@pytest.mark.parametrize("s", GRID_SIZES)
def test_warm_solve_over_a_counts_row_a_row(card, s, n):
    """(R, N) f over (R, N) counts, a row each (a fleet's tenants): one
    launch, each row's tau and f' bit for bit its own one-row launch over
    its counts row, tau within 1e-6 of the plain version."""
    f, _counts, eta, cap, lo, hi, tau0 = _warm_rows(s, n, s * 5 + n % 7, card)
    gen = torch.Generator().manual_seed(s)
    b = max(1, n // 1000)
    counts = histogram(torch.randint(0, n, (s, b), generator=gen, dtype=torch.int32).to(card), n)
    reset_launch_counts()
    got_f, got_tau = project_warm(f, counts, eta, cap, lo, hi, tau0, 5)
    assert launch_counts()["mass"] == 1
    assert torch.equal(project_warm_tau(f, counts, eta, cap, lo, hi, tau0, 5), got_tau)
    for r in range(s):
        one_f, one_tau = project_warm(f[r].contiguous(), counts[r].contiguous(), eta[r], cap[r],
                                      lo[r], hi[r], tau0[r], 5)
        assert torch.equal(one_tau, got_tau[r]) and torch.equal(one_f, got_f[r])
        want = project_warm_tau_ref(f[r], counts[r], eta[r], cap[r], lo[r], hi[r], tau0[r], 5)
        assert abs(float(want) - float(got_tau[r])) <= 1e-6


def _tenant_traces(e, n, t, seed):
    return np.stack([zipf(n, t, alpha=0.8, seed=seed + r) for r in range(e)]).astype(np.int32)


def _same_carries(got, want, cpu=None):
    for r, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f"tenant {r}"
        if cpu is not None:
            for x, z in zip(a, cpu[r]):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x.cpu(), z), f"tenant {r} against the CPU"


@pytest.mark.parametrize("e", FLEET_SIZES)
@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl", "fifo", "ogb"])
def test_fleet_rows_equal_their_tenants_runs(card, kind, e):
    """run_fleet on the card: one launch a chunk for every tenant of each
    kernel (FIFO: one a plan), each tenant's own ids; each row's hits,
    reward, aux, occupancy and final carry bit for bit its tenant's own run
    on the card, and the hits and carries the CPU fleet's."""
    from repro_torch.cachesim.fleet import run_fleet
    from repro_torch.kernels.tree_lru.ops import CHUNK

    n, window = 2000, 500
    caps = [20 + 37 * (r % 5) for r in range(e)]
    traces = _tenant_traces(e, n, 3000, 11 * e)
    pd = repro_torch.policy_def(kind)
    reset_launch_counts()
    fr = run_fleet(pd, traces, n, caps, window=window, device=card, track_opt=False)
    launches, designs = launch_counts(), design_counts()
    chunks = fr.hits.shape[1]
    if kind == "ogb":
        assert launches["histogram"] == chunks and launches["mass"] == chunks
    elif kind == "lru":
        assert designs["tree_lru"][CHUNK] == chunks
    elif kind == "fifo":
        assert max(designs["fifo_queue"].values()) == chunks
    else:
        assert launches["minpair_automaton"] == chunks
    cpu = run_fleet(pd, traces, n, caps, window=window, device="cpu", track_opt=False)
    assert np.array_equal(fr.hits, cpu.hits) or kind == "ogb"
    ones = []
    for r in range(e):
        one = repro_torch.run(pd, traces[r], n, caps[r], window=window, seed=r,
                              n_slots=max(caps), device=card, track_opt=False)
        for a in ("hits", "reward", "aux", "occupancy"):
            assert np.array_equal(getattr(fr, a)[r], getattr(one, a)), (r, a)
        ones.append(one.carry)
    _same_carries(fr.carry, ones, None if kind == "ogb" else cpu.carry)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("kind", ["ogb", "lru"])
def test_streams_on_the_card_equal_one_shot_runs(card, kind, prefetch):
    """run_stream over ragged prime-sized chunks and run_fleet_stream over
    ragged tenant sources, on the card: bit for bit the one-shot run and
    run_fleet, with the pipeline or without."""
    from repro_torch.cachesim.fleet import run_fleet, run_fleet_stream
    from repro_torch.cachesim.tracelab import run_stream

    n, c, window, t = 3000, 100, 250, 20_000
    trace = zipf(n, t, alpha=0.8, seed=3)
    pd = repro_torch.policy_def(kind)
    one = repro_torch.run(pd, trace, n, c, window=window, device=card, track_opt=False)
    st = run_stream(pd, (trace[i:i + 1009] for i in range(0, t, 1009)), n, c, window=window,
                    horizon=t, segment_len=3000, prefetch=prefetch, device=card)
    for a in ("hits", "reward", "aux", "occupancy"):
        assert np.array_equal(getattr(st, a), getattr(one, a)), a
    _same_carries([st.carry], [one.carry])
    traces = _tenant_traces(3, n, 6000, 5)
    fr = run_fleet(pd, traces, n, c, window=window, device=card, track_opt=False)
    fs = run_fleet_stream(pd, [[tr[i:i + 613] for i in range(0, 6000, 613)] for tr in traces],
                          n, c, window=window, horizons=6000, segment_len=1000,
                          prefetch=prefetch, device=card)
    assert np.array_equal(fs.hits, fr.hits) and np.array_equal(fs.reward, fr.reward)
    _same_carries(fs.carry, fr.carry)


def test_edge_fleet_mini_on_the_card_matches_the_cpu(card):
    """edge_fleet_cdn at mini on the card and the CPU: the edges exactly,
    the origin's hits equal and its reward within the dense path's limit."""
    from repro_torch.cachesim.fleet import run_edge_fleet_scenario

    got = run_edge_fleet_scenario("edge_fleet_cdn", "mini", device=card)
    cpu = run_edge_fleet_scenario("edge_fleet_cdn", "mini", device="cpu")
    assert np.array_equal(got.edges.hits, cpu.edges.hits)
    assert got.origin_requests == cpu.origin_requests and got.origin.T == cpu.origin.T
    np.testing.assert_allclose(got.origin.reward, cpu.origin.reward, rtol=1e-5)
    np.testing.assert_allclose(got.origin.aux, cpu.origin.aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1000, 262_144])
@pytest.mark.parametrize("e", FLEET_SIZES)
def test_int32_tree_builds_of_a_grid_match_their_builds(card, n, e):
    """R int32 trees in one launch (a ticket a row): each row bit for bit
    its own one-tree build and the plain version's, twice in a row (the
    tickets wrap back to 0)."""
    from repro_torch.kernels.prefix_tree.ops import WHOLE_TREES, tree_build_rows_

    gen = torch.Generator().manual_seed(e + n % 7)
    leaves = torch.randint(0, 9, (e, n + 2), generator=gen, dtype=torch.int32)[:, :n].to(card)
    tot = tree_storage(n, 16)
    out = torch.zeros((e, (tot + 3) & ~3), dtype=torch.int32, device=card)[:, :tot]
    for _ in range(2):
        reset_launch_counts()
        tree_build_rows_(leaves, 16, out)
        assert launch_counts()["segsum"] == 1
        assert design_counts()["segsum"] == {WHOLE_TREES: 1} or e == 0
        for r in range(e):
            assert torch.equal(out[r], tree_build(leaves[r].contiguous(), 16))
            assert torch.equal(out[r].cpu(), tree_build_ref(leaves[r].cpu(), 16))


# -- the MoE layer and the expert cache ---------------------------------------

def _moe_cfg(arch, **kw):
    import dataclasses

    from repro_torch.configs.base import get_smoke

    return dataclasses.replace(get_smoke(arch), **kw)


#: granite-moe's and kimi-k2's smoke layers (the dense mixture), and a
#: dispatch layer (E * F = 65 536) at capacity factors that drop tokens
MOE_CASES = {
    "granite-dense": ("granite-moe-1b-a400m", {}),
    "kimi-dense": ("kimi-k2-1t-a32b", {}),
    "dispatch-1.0": ("kimi-k2-1t-a32b", dict(n_experts=64, moe_d_ff=1024, capacity_factor=1.0)),
    "dispatch-0.5": ("kimi-k2-1t-a32b", dict(n_experts=64, moe_d_ff=1024, capacity_factor=0.5)),
}


@pytest.mark.parametrize("tokens", [(4, 64), (8, 1)], ids=["prefill", "decode"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_forward_card_matches_cpu(card, case, tokens):
    """Float32 weights: the card routes every token to the CPU's experts
    (the router in float32 with TF32 off) and its output and aux losses
    agree within 1e-5."""
    from repro_torch.models.moe import init_moe, moe_forward, route

    arch, kw = MOE_CASES[case]
    cfg = _moe_cfg(arch, **kw)
    p = init_moe(torch.Generator().manual_seed(7), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(tokens + (cfg.d_model,))
                         .astype(np.float32))
    pc = {k: v.to(card) for k, v in p.items()}
    assert torch.equal(route(pc, x.to(card).reshape(-1, cfg.d_model), 2).eidx.cpu(),
                       route(p, x.reshape(-1, cfg.d_model), 2).eidx)
    got, got_aux = moe_forward(pc, x.to(card), cfg)
    want, want_aux = moe_forward(p, x, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for k in want_aux:
        torch.testing.assert_close(got_aux[k].cpu(), want_aux[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,c", [(768, 192), (23424, 5856)])
def test_ogb_grad_step_card_matches_cpu_and_launches(card, n, c):
    """A step of ``ogb_grad`` on the card against the CPU from the same
    carry, 30 steps: tau and f within 1e-5, hits equal off |f - p| <= 1e-5;
    each step launches 50 K = 1 ``masses`` and one standalone ``apply``."""
    from repro_torch.kernels.capped_simplex.ops import STANDALONE

    pd = repro_torch.policy_def("ogb_grad")
    cpu = pd.init(n, c, seed=0, eta=0.5, device="cpu")
    gpu = type(cpu)(*(t.to(card) for t in cpu))
    rng = np.random.default_rng(n)
    for t in range(30):
        g = torch.from_numpy(rng.poisson(5.0, n).astype(np.float32))
        near = bool(((cpu.f - cpu.p).abs() <= 1e-5).any())
        reset_launch_counts()
        gpu, out = pd.step(gpu, g.to(card))
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["mass"] == 50 and counts["apply"] == 1
        assert design_counts()["apply"] == {STANDALONE: 1}
        assert sum(counts.values()) == 51
        cpu, want = pd.step(cpu, g)
        torch.testing.assert_close(gpu.f.cpu(), cpu.f, rtol=0, atol=1e-5)
        assert abs(float(gpu.tau) - float(cpu.tau)) <= 1e-5, t
        assert abs(float(out.reward) - float(want.reward)) <= 1e-5
        if not near:
            assert int(out.hits) == int(want.hits), t


def test_expert_cache_on_the_card_matches_the_cpu(card):
    from repro_torch.serve.expert_cache import ExpertCacheConfig, OGBExpertCache

    cfg = ExpertCacheConfig(n_layers=24, n_experts=32, horizon_steps=200, bytes_per_expert=7)
    cpu = OGBExpertCache(cfg, device="cpu")
    gpu = OGBExpertCache(cfg, carry=type(cpu.carry)(*(t.to(card) for t in cpu.carry)))
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(0)
    for t in range(100):
        counts = rng.poisson(5.0, (24, 32)).astype(np.float32)
        counts[:, (t // 50) * 8:(t // 50) * 8 + 8] += 60
        near = bool(((cpu.carry.f - cpu.carry.p).abs() <= 1e-5).any())
        got, want = gpu.step(counts), cpu.step(counts)
        near = near or bool(((cpu.carry.f - cpu.carry.p).abs() <= 1e-5).any())
        if not near:
            assert abs(got["resident_hit_ratio"] - want["resident_hit_ratio"]) <= 1e-5
            assert got == {**want, "resident_hit_ratio": got["resident_hit_ratio"]}, t
            np.testing.assert_array_equal(gpu.resident_mask(), cpu.resident_mask())
    torch.testing.assert_close(gpu.carry.f.cpu(), cpu.carry.f, rtol=0, atol=1e-5)
    assert abs(gpu.mean_hit_ratio - cpu.mean_hit_ratio) <= 1e-3
    assert gpu.mean_hit_ratio > 0.25  # above C / N: the hot experts are held


# -- the attention families: mistral-nemo's int8 cache, phi-3-vision, whisper --------

def _int8_cache(gen, card, B, S, Hkv, D):
    """Int8 codes and float32 scales of a normal K and V, as the model writes them."""
    from repro_torch.models.attention import _quantize_kv

    codes, scale = _quantize_kv(torch.randn(2, B, S, Hkv, D, generator=gen, device=card))
    return codes[0], codes[1], scale[0], scale[1]


#: (S, T) of the non-causal mode at whisper's heads (H = Hkv = 20, D = 64): a
#: decoded token, a 224-token prompt and the encoder's own 1500 rows, over the
#: encoder's 1500 rows and over key lengths around the 64-key tile (the
#: CUDA-core design's) and the 128-key tile (the wgmma design's)
NONCAUSAL_CASES = [
    pytest.param(S, T, dtype, id=f"{S}-{T}-{KINDS[dtype]}")
    for dtype in (torch.bfloat16, torch.float32) for S in (1, 224, 1500)
    for T in (1500, 1, 63, 65, 129)
]


@pytest.mark.parametrize("S,T,dtype", NONCAUSAL_CASES)
def test_non_causal_prefill_matches_plain(card, S, T, dtype):
    from repro_torch.kernels.flash_prefill.kernel import design, mode

    B, H, D = 2, 20, 64
    gen = torch.Generator(device=card).manual_seed(S * T)
    q = torch.randn(B, S, H, D, generator=gen, device=card).to(dtype)
    k = torch.randn(B, T, H, D, generator=gen, device=card).to(dtype)
    v = torch.randn(B, T, H, D, generator=gen, device=card).to(dtype)
    reset_launch_counts()
    got = flash_prefill(q, k, v, causal=False)
    want = flash_prefill_ref(q, k, v, causal=False)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))
    assert design_counts()["flash_prefill"] == {f"{design(dtype, D)}, {mode(q, k, False)}": 1}
    assert torch.equal(got, flash_prefill(q, k, v, causal=False))


@pytest.mark.parametrize("S,T,H,Hkv,D", [(130, 1500, 32, 32, 96), (224, 65, 32, 32, 96),
                                         (100, 333, 16, 16, 256), (129, 1000, 8, 2, 192),
                                         (300, 300, 8, 2, 128), (2, 70, 8, 2, 16)])
def test_non_causal_prefill_at_other_heads(card, S, T, H, Hkv, D):
    """bf16 at phi-3-vision's D = 96, the wgmma design's 64-key tiles (D =
    192, 256) and GQA groups, and a smoke head (the CUDA-core design)."""
    gen = torch.Generator(device=card).manual_seed(S + T + D)
    q = torch.randn(1, S, H, D, generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn(1, T, Hkv, D, generator=gen, device=card).to(torch.bfloat16)
    v = torch.randn(1, T, Hkv, D, generator=gen, device=card).to(torch.bfloat16)
    want = flash_prefill_ref(q, k, v, causal=False)
    torch.testing.assert_close(flash_prefill(q, k, v, causal=False).float(), want.float(), rtol=0,
                               atol=_attention_limit(torch.bfloat16, want))


#: (S, T, H, Hkv) of D = 96 calls: test_non_causal_prefill_at_other_heads's
#: shapes there, and an encoder's (S = T = 1500) and a cross call's (224 over
#: 1500) at phi-3-vision's heads
D96_NON_CAUSAL = [(130, 1500, 32, 32), (224, 65, 32, 32), (1500, 1500, 32, 32),
                  (224, 1500, 32, 32)]


def _d96_prefill_case(card, B, S, T, H, Hkv, causal):
    """A bf16 D = 96 call: within one ulp of the largest output of the plain
    version, bit for bit on repeat, counted once as the wgmma design's."""
    from repro_torch.kernels.flash_prefill.kernel import mode

    gen = torch.Generator(device=card).manual_seed(B * S + T + 96)
    q = torch.randn(B, S, H, 96, generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, 96, generator=gen, device=card).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, 96, generator=gen, device=card).to(torch.bfloat16)
    reset_launch_counts()
    got = flash_prefill(q, k, v, causal)
    assert design_counts()["flash_prefill"] == {f"wgmma+tma, {mode(q, k, causal)}": 1}
    want = flash_prefill_ref(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(torch.bfloat16, want))
    assert torch.equal(got, flash_prefill(q, k, v, causal))


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 2048, 2049])
def test_d96_causal_prefill_on_the_wgmma_design(card, S):
    """phi-3-vision's heads (B = 8, H = Hkv = 32, D = 96) causal at S around
    the design's 64-row warpgroup tiles and 128-key tiles, and its served
    2048 (TMA's zero fill past S, the diagonal tiles)."""
    _d96_prefill_case(card, 8, S, S, 32, 32, True)


@pytest.mark.parametrize("S,T,H,Hkv", D96_NON_CAUSAL)
def test_d96_non_causal_prefill_on_the_wgmma_design(card, S, T, H, Hkv):
    """D = 96 non-causal (T == S) and cross (T != S) calls on the wgmma design."""
    _d96_prefill_case(card, 1, S, T, H, Hkv, False)


#: the int8 mma design's own edges at mistral-nemo's served cache: a warp's
#: 16-position slices, and its plan's 384-position split (6 of them at S =
#: 2080 on 132 SMs, mma_grid_plan(..., int8=True))
INT8_EDGE_LENGTHS = {
    **EDGE_LENGTHS,
    "slices": [15, 16, 17, 31, 32, 33, 47, 49],
    "int8-split": [383, 384, 385, 767, 768, 769, 2079, 2080],
}
INT8_DECODE_CASES = [
    pytest.param(8, 32, 8, 128, 2080, dtype, lengths, id=f"mistral-{name}-{KINDS[dtype]}")
    for dtype in (torch.bfloat16, torch.float32) for name, lengths in INT8_EDGE_LENGTHS.items()
] + [
    pytest.param(B, H, Hkv, D, S, dtype, None, id=f"{B}-{H}-{Hkv}-{D}-{S}-{KINDS[dtype]}")
    for dtype in (torch.bfloat16, torch.float32) for S in (1, 130, 4096)
    # the smoke heads, phi-3-vision's D = 96 and whisper's D = 64
    for B, H, Hkv, D in ((2, 8, 2, 16), (4, 32, 32, 96), (3, 20, 20, 64))
]


@pytest.mark.parametrize("B,H,Hkv,D,S,dtype,lengths", INT8_DECODE_CASES)
def test_int8_decode_matches_plain(card, B, H, Hkv, D, S, dtype, lengths):
    from repro_torch.kernels.decode_attention.kernel import design

    gen = torch.Generator(device=card).manual_seed(B * S + D)
    q = torch.randn(B, H, D, generator=gen, device=card).to(dtype)
    k, v, ks, vs = _int8_cache(gen, card, B, S, Hkv, D)
    if lengths is None:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=card, dtype=torch.int32)
        lengths[0], lengths[-1] = 1, S
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    reset_launch_counts()
    got = decode_attention(q, k, v, lengths, ks, vs)
    want = decode_attention_ref(q, k, v, lengths, ks, vs)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))
    assert design_counts()["decode_attention"] == {f"{design(dtype, D)}, int8 cache": 1}
    assert torch.equal(got, decode_attention(q, k, v, lengths, ks, vs))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_decode_equals_the_compute_cache_kernel_on_exact_scales(card, dtype):
    """Scales that are powers of two: every dequantized value is exact in
    q's type, so the int8 call computes what the compute-type kernel
    computes over the dequantized cache (within its limit: the two may split
    the cache differently)."""
    from repro_torch.kernels.decode_attention.ref import dequantize

    B, H, Hkv, D, S = 8, 32, 8, 128, 2080
    gen = torch.Generator(device=card).manual_seed(11)
    q = torch.randn(B, H, D, generator=gen, device=card).to(dtype)
    codes = torch.randint(-127, 128, (2, B, S, Hkv, D), generator=gen, device=card,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.pow(2.0, torch.randint(-12, -4, (2, B, S, Hkv), generator=gen,
                                         device=card).float())
    lengths = torch.arange(2049, 2057, dtype=torch.int32, device=card)
    deq = [dequantize(codes[i], scale[i], dtype) for i in (0, 1)]
    assert torch.equal(deq[0].float(), codes[0].float() * scale[0][..., None])
    want = decode_attention(q, deq[0], deq[1], lengths)
    got = decode_attention(q, codes[0], codes[1], lengths, scale[0], scale[1])
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_whisper_cross_decode_matches_plain(card, dtype):
    """A decoded token's cross-attention: one query over all T = 1500 encoder
    rows, lengths T, at whisper's served B = 8 and heads."""
    B, H, D, T = 8, 20, 64, 1500
    gen = torch.Generator(device=card).manual_seed(T)
    q = torch.randn(B, H, D, generator=gen, device=card).to(dtype)
    k = torch.randn(B, T, H, D, generator=gen, device=card).to(dtype)
    v = torch.randn(B, T, H, D, generator=gen, device=card).to(dtype)
    lengths = torch.full((B,), T, dtype=torch.int32, device=card)
    want = decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(decode_attention(q, k, v, lengths).float(), want.float(), rtol=0,
                               atol=_attention_limit(dtype, want))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "phi-3-vision-4.2b", "whisper-large-v3"])
def test_families_on_the_card_match_the_cpu(card, arch):
    """The float32 smoke models (mistral-nemo with its int8 cache) on the card
    through the kernels against the CPU through the plain versions: prefill
    (with image embeddings or frames) and 4 decode steps within 1e-4, and
    each mode's launches: a whisper prefill runs its encoder's non-causal,
    its decoder's causal and cross launches, a step a self and a cross
    decode a layer."""
    import dataclasses

    from repro_torch.configs.base import get_smoke
    from repro_torch.models import model

    cfg = get_smoke(arch)
    if arch.startswith("mistral"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cpu_params = model.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    L = cfg.n_layers
    logits = {}
    for dev in ("cpu", card):
        params = _to(cpu_params, dev)
        reset_launch_counts()
        out, cache = model.prefill(cfg, params, {k: torch.from_numpy(v).to(dev)
                                                 for k, v in batch.items()}, 40, device=dev)
        tok = torch.argmax(out[:, :cfg.vocab_size], -1)
        steps = [out.cpu()]
        for _ in range(4):
            out, cache = model.decode_step(cfg, params, cache, tok, device=dev)
            steps.append(out.cpu())
        logits[str(dev)] = steps
        if dev == card:
            prefill_modes = ({"cuda-core, non-causal": cfg.n_encoder_layers,
                              "cuda-core, causal": L, "cuda-core, cross": L}
                             if cfg.family == "encdec" else {"cuda-core, causal": L})
            cache_kind = "int8 cache" if cfg.kv_cache_dtype == "int8" else "compute-type cache"
            per_step = 2 * L if cfg.family == "encdec" else L
            assert design_counts()["flash_prefill"] == prefill_modes
            assert design_counts()["decode_attention"] == {f"cuda-core, {cache_kind}":
                                                           4 * per_step}
    for a, b in zip(logits["cpu"], logits[str(card)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


# -- the SSM family: the WKV-6 recurrence ------------------------------------------

WKV_TOL = 1e-5  # of the largest |value| of y and of the state (chip_smoke.py's WKV_TOL)
#: w0 of each decay, w = exp(-exp(w0 + 0.12 N(0, 1))) (chip_smoke.py's WKV_DECAYS)
WKV_DECAYS = {"slow": -6.0, "near zero": 2.0, "near one": -12.0}


def _wkv_inputs(card, B, S, H, n, seed, mid_run, decay="slow"):
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(steps):
        r, k, v = (torch.randn(B, steps, H, n, generator=gen, device=card) for _ in range(3))
        w = torch.exp(-torch.exp(WKV_DECAYS[decay] + 0.12 * torch.randn(
            B, steps, H, n, generator=gen, device=card)))
        return r, k, v, w

    u = 0.1 * torch.randn(H, n, generator=gen, device=card)
    state = torch.zeros(B, H, n, n, device=card)
    if mid_run:
        state = wkv6_ref(*draw(256), u, state)[1].contiguous()
    return (*draw(S), u, state)


#: (n, S, mid-run state, B, H, decay): every head dim at 1, 7 and 2049 steps from
#: a zero and a mid-run state; w ~ exp(-e^2) (each step nearly forgets the
#: state) at rwkv6-1.6b's served layer and at n = 16; w ~ 1 - 6e-6 (it nearly
#: keeps all of it) at each head dim's plan (kernel.PLANS), two chunks and a step
WKV_CASES = [(n, S, mid_run, 2, 4, "slow") for n in (16, 32, 64) for S in (1, 7, 2049)
             for mid_run in (False, True)] + [
    (64, 2048, True, 8, 32, "near zero"), (16, 2049, True, 2, 4, "near zero"),
    (16, 33, True, 2, 4, "near one"), (32, 33, True, 2, 4, "near one"),
    (64, 33, True, 2, 4, "near one")]
WKV_IDS = [f"{n}-{S}-{'mid-run' if mid_run else 'zero'} state" if decay == "slow"
           else f"{n}-{S}-{B}x{H}-{decay} decay" for n, S, mid_run, B, H, decay in WKV_CASES]


@pytest.mark.parametrize("n, S, mid_run, B, H, decay", WKV_CASES, ids=WKV_IDS)
def test_wkv6_matches_plain_and_writes_the_state_in_place(card, n, S, mid_run, B, H, decay):
    r, k, v, w, u, state = _wkv_inputs(card, B, S, H, n, seed=n + S, mid_run=mid_run,
                                       decay=decay)
    want_y, want_s = wkv6_ref(r, k, v, w, u, state)
    got_s, again_s = state.clone(), state.clone()
    reset_launch_counts()
    got_y, same = wkv6(r, k, v, w, u, got_s)
    again_y, _ = wkv6(r, k, v, w, u, again_s)
    torch.cuda.synchronize()
    assert same is got_s and launch_counts()["wkv6"] == 2
    for got, want in ((got_y, want_y), (got_s, want_s)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= WKV_TOL * float(want.abs().max())
    assert torch.equal(got_y, again_y) and torch.equal(got_s, again_s)


def test_wkv6_raises_on_what_it_cannot_take(card):
    r, k, v, w, u, state = _wkv_inputs(card, 2, 5, 4, 16, seed=0, mid_run=False)
    odd = [t[..., :8].contiguous() for t in (r, k, v, w)]
    with pytest.raises(ValueError, match="head dim 8"):
        wkv6(*odd, u[:, :8].contiguous(), state[:, :, :8, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u, state)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r.double(), k, v, w, u, state)
    shifted = torch.empty(r.numel() + 1, device=card)[1:].view(r.shape)
    shifted.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        wkv6(shifted, k, v, w, u, state)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6(r, k, v, w, u.cpu(), state)


def test_rwkv_smoke_model_on_the_card_matches_the_cpu(card):
    """The float32 rwkv6 smoke model on the card through the kernel against
    the CPU through the plain version: prefill and 4 decode steps within
    1e-4, a wkv6 launch a layer in each and no attention launch."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.models import model

    cfg = get_smoke("rwkv6-1.6b")
    cpu_params = model.init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    logits = {}
    for dev in ("cpu", card):
        params = _to(cpu_params, dev)
        reset_launch_counts()
        out, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).to(dev)}, 0,
                                   device=dev)
        tok = torch.argmax(out[:, :cfg.vocab_size], -1)
        steps = [out.cpu()]
        for _ in range(4):
            out, cache = model.decode_step(cfg, params, cache, tok, device=dev)
            steps.append(out.cpu())
        logits[str(dev)] = steps + [cache["tm_s"].cpu()]
        if dev == card:
            counts = launch_counts()
            assert counts["wkv6"] == 5 * cfg.n_layers
            assert counts["flash_prefill"] == counts["decode_attention"] == 0
    for a, b in zip(logits["cpu"], logits[str(card)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


SCAN_TOL = 1e-5  # of the largest |value| of y and of the state (chip_smoke.py's SCAN_TOL)
#: dt = softplus(c + s N(0, 1)) for (c, s) (chip_smoke.py's SCAN_DT)
SCAN_DT = {"served": (0.0, 0.6), "slow": (math.log(math.expm1(1e-3)), 0.1), "fast": (5.0, 0.1)}


def _scan_inputs(card, B, S, d_in, n, seed, mid_run, dt="served"):
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card)

    c, spread = SCAN_DT[dt]

    def draw(steps):
        return (randn(B, steps, d_in), torch.nn.functional.softplus(
            c + spread * randn(B, steps, d_in)), randn(B, steps, n), randn(B, steps, n))

    A = -torch.arange(1, n + 1, dtype=torch.float32, device=card) * torch.exp(
        0.3 * randn(d_in, n))
    D = 1.0 + 0.1 * randn(d_in)
    state = torch.zeros(B, d_in, n, device=card)
    if mid_run:
        x, dt_, Bm, Cm = draw(256)
        state = selective_scan_ref(x, dt_, A, Bm, Cm, D, state)[1].contiguous()
    return (*draw(S), A, D, state)


#: (n, S, d_in, mid-run state, dt): each state dim at 1, 7 and 2049 steps from a
#: zero and a mid-run state at jamba's d_in; a ragged d_in (one block and a
#: part); slow (~1e-3) and fast (~5) dt, phase 27 (a)'s cases at B = 2
SCAN_CASES = [(n, S, 16384 if n == 16 else 4096, mid_run, "served") for n in (8, 16)
              for S in (1, 7, 2049) for mid_run in (False, True)] + [
    (16, 2049, 200, True, "served"), (8, 33, 200, False, "slow"),
    (16, 2048, 16384, True, "slow"), (16, 2048, 16384, True, "fast"), (8, 1, 4096, True, "fast"),
    (16, 1, 16384, True, "slow"), (8, 1, 4096, True, "slow"), (8, 2049, 4096, True, "slow"),
    (16, 2049, 130, True, "slow")]
SCAN_IDS = [f"n{n}-S{S}-d{d_in}-{dt} dt-{'mid-run' if mid_run else 'zero'} state"
            for n, S, d_in, mid_run, dt in SCAN_CASES]


@pytest.mark.parametrize("n, S, d_in, mid_run, dt", SCAN_CASES, ids=SCAN_IDS)
def test_selective_scan_matches_plain_and_writes_the_state_in_place(card, n, S, d_in, mid_run,
                                                                    dt):
    x, dts, Bm, Cm, A, D, state = _scan_inputs(card, 2, S, d_in, n, seed=n + S + d_in,
                                               mid_run=mid_run, dt=dt)
    want_y, want_s = selective_scan_ref(x, dts, A, Bm, Cm, D, state)
    got_s, again_s = state.clone(), state.clone()
    reset_launch_counts()
    got_y = selective_scan(x, dts, A, Bm, Cm, D, got_s)
    again_y = selective_scan(x, dts, A, Bm, Cm, D, again_s)
    torch.cuda.synchronize()
    assert launch_counts()["selective_scan"] == 2
    for got, want in ((got_y, want_y), (got_s, want_s)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= SCAN_TOL * float(want.abs().max())
    assert torch.equal(got_y, again_y) and torch.equal(got_s, again_s)


@pytest.mark.parametrize("n", [8, 16])
def test_selective_scan_decode_step_continues_the_prefill_bit_for_bit(card, n):
    """A decode step (its own kernel) from a prompt's state is that prompt
    one step longer: the same arithmetic a step in both designs.  Counted
    by design: the prefill's and the decode step's."""
    from repro_torch.kernels.selective_scan.kernel import DESIGN, DESIGN_STEP

    x, dts, Bm, Cm, A, D, state = _scan_inputs(card, 2, 9, 16384 if n == 16 else 4096, n,
                                               seed=5 + n, mid_run=True, dt="slow")
    reset_launch_counts()
    whole = state.clone()
    y9 = selective_scan(x, dts, A, Bm, Cm, D, whole)
    part = state.clone()
    y8 = selective_scan(x[:, :8].contiguous(), dts[:, :8].contiguous(), A,
                        Bm[:, :8].contiguous(), Cm[:, :8].contiguous(), D, part)
    y1 = selective_scan(x[:, 8:].contiguous(), dts[:, 8:].contiguous(), A,
                        Bm[:, 8:].contiguous(), Cm[:, 8:].contiguous(), D, part)
    torch.cuda.synchronize()
    assert design_counts()["selective_scan"] == {DESIGN: 2, DESIGN_STEP: 1}
    assert torch.equal(torch.cat([y8, y1], dim=1), y9) and torch.equal(part, whole)
    want_y, want_s = selective_scan_ref(x, dts, A, Bm, Cm, D, state)
    for got, want in ((y9, want_y), (whole, want_s)):
        assert float((got - want).abs().max()) <= SCAN_TOL * float(want.abs().max())


@pytest.mark.parametrize("S, dt", [(33, "served"), (1, "slow"), (2049, "slow")])
def test_selective_scan_earlier_design_still_matches_plain(card, S, dt):
    """The earlier design, built from the text tools/time_selective_scan_designs.py
    keeps, against the plain version: the yardstick the new design is timed
    beside."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "time_selective_scan_designs.py"
    spec = importlib.util.spec_from_file_location("time_selective_scan_designs", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    x, dts, Bm, Cm, A, D, state = _scan_inputs(card, 2, S, 4096, 16, seed=S, mid_run=True, dt=dt)
    want_y, want_s = selective_scan_ref(x, dts, A, Bm, Cm, D, state)
    got_s = state.clone()
    got_y = tool._call(tool.earlier_entry(), x, dts, A, Bm, Cm, D, got_s, torch.empty_like(x))
    torch.cuda.synchronize()
    for got, want in ((got_y, want_y), (got_s, want_s)):
        assert float((got - want).abs().max()) <= SCAN_TOL * float(want.abs().max())


def test_selective_scan_raises_on_what_it_cannot_take(card):
    x, dts, Bm, Cm, A, D, state = _scan_inputs(card, 2, 5, 64, 16, seed=0, mid_run=False)
    wide = [t.repeat(*([1] * (t.dim() - 1)), 2) for t in (A, Bm, Cm, state)]
    with pytest.raises(ValueError, match="state dim 32"):
        selective_scan(x, dts, wide[0], wide[1], wide[2], D, wide[3])
    with pytest.raises(TypeError, match="float32"):
        selective_scan(x.double(), dts, A, Bm, Cm, D, state)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(x, dts, A, Bm, Cm, D, state.transpose(1, 2).contiguous().transpose(1, 2))
    shifted = torch.empty(x.numel() + 1, device=card)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        selective_scan(shifted, dts, A, Bm, Cm, D, state)
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan(x, dts, A, Bm, Cm, D.cpu(), state)


def test_jamba_smoke_model_on_the_card_matches_the_cpu(card):
    """The float32 jamba smoke model on the card through the kernels against
    the CPU through the plain versions: prefill and 4 decode steps within
    1e-4, a selective_scan launch a Mamba layer, a flash_prefill launch a
    prefill and a decode_attention launch a step for its attention layer."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.models import model

    cfg = get_smoke("jamba-1.5-large-398b")
    cpu_params = model.init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    out_by = {}
    for dev in ("cpu", card):
        params = _to(cpu_params, dev)
        reset_launch_counts()
        out, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).to(dev)}, 48,
                                   device=dev)
        tok = torch.argmax(out[:, :cfg.vocab_size], -1)
        steps = [out.cpu()]
        for _ in range(4):
            out, cache = model.decode_step(cfg, params, cache, tok, device=dev)
            steps.append(out.cpu())
        out_by[str(dev)] = steps + [cache[name].cpu() for name in ("k", "v", "conv", "ssm")]
        if dev == card:
            counts = launch_counts()
            assert counts["selective_scan"] == 5 * 3
            assert counts["flash_prefill"] == 1 and counts["decode_attention"] == 4
    for a, b in zip(out_by["cpu"], out_by[str(card)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


# -- training's attention: the backward kernel, the forward's lse, the guards -----

#: (B, S, T, H, Hkv, D, causal): every mode, ragged S around the 64-row tiles,
#: groups of 1, 4 and 16 query heads a KV head, the trained families' D
BWD_SHAPES = [(2, 65, 65, 8, 2, 16, True), (1, 127, 127, 4, 4, 64, True),
              (2, 129, 129, 32, 2, 128, True), (1, 200, 200, 32, 32, 96, True),
              (2, 100, 100, 4, 4, 64, False), (2, 37, 150, 8, 2, 64, False),
              (1, 1, 1, 16, 1, 128, True), (2, 300, 70, 16, 8, 16, False),
              (1, 300, 300, 4, 2, 256, True), (2, 129, 129, 4, 4, 256, True),
              (1, 37, 150, 4, 2, 256, False), (1, 200, 200, 4, 1, 192, True),
              (1, 1, 1, 2, 1, 256, True)]
BWD_CASES = [pytest.param(*shape, dtype, id="-".join(map(str, shape)) + f"-{KINDS[dtype]}")
             for shape in BWD_SHAPES for dtype in (torch.bfloat16, torch.float32)]


def _bwd_inputs(card, B, S, T, H, Hkv, D, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn(B, S, H, D, generator=gen, device=card).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=card).to(dtype) for _ in range(2))
    return q, k, v, do


def _bwd_limit(dtype, want, cancel=0.0):
    """8 bf16 ulps of the largest output (float32: 1e-4 of it), and never
    under ``cancel``."""
    top = float(want.float().abs().max())
    limit = 1e-4 * top if dtype == torch.float32 else 8 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return max(limit, cancel)


def _cancel_floor(do, v):
    """The float32 rounding of dS = P (dP - delta), a difference of two sums
    of D products: where they cancel (one key, S = 1: dS = 0) that rounding
    is all that is left of dq and dk."""
    return 1e-6 * float(do.float().abs().max()) * float(v.float().abs().max()) * v.shape[3]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,dtype", BWD_CASES)
def test_flash_prefill_bwd_matches_plain(card, B, S, T, H, Hkv, D, causal, dtype):
    from repro_torch.kernels.flash_prefill.kernel import BWD_LAUNCHES, bwd_design, mode
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_bwd, flash_prefill_lse
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref, flash_prefill_lse_ref

    q, k, v, do = _bwd_inputs(card, B, S, T, H, Hkv, D, dtype, seed=S * T + D)
    reset_launch_counts()
    out, lse = flash_prefill_lse(q, k, v, causal)
    want_out, want_lse = flash_prefill_lse_ref(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=_bwd_limit(dtype, want_out))
    got = flash_prefill_bwd(q, k, v, out, do, lse, causal)
    n = BWD_LAUNCHES[bwd_design(dtype, D)]
    assert launch_counts()["flash_prefill_bwd"] == n and launch_counts()["flash_prefill"] == 1
    assert design_counts()["flash_prefill_bwd"] == {
        f"{bwd_design(dtype, D)}, {mode(q, k, causal)}": n}
    want = flash_prefill_bwd_ref(q, k, v, out, do, lse, causal)
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == like.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=_bwd_limit(dtype, w, _cancel_floor(do, v)))
    again = flash_prefill_bwd(q, k, v, out, do, lse, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _flash_bwd_tool():
    """tools/time_flash_bwd_designs.py, which keeps the earlier mma.sync
    design as text and builds it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "time_flash_bwd_designs.py"
    spec = importlib.util.spec_from_file_location("time_flash_bwd_designs", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", [(2, 129, 129, 32, 2, 128, True),
                                                   (2, 37, 150, 8, 2, 64, False),
                                                   (1, 200, 200, 32, 32, 96, True)])
def test_flash_prefill_bwd_cuda_core_design_takes_bf16_too(card, B, S, T, H, Hkv, D, causal):
    """The CUDA-core design at the shapes that take the wgmma design, and the
    earlier mma.sync design (kept as text by tools/time_flash_bwd_designs.py):
    each within the limits of the plain version."""
    from repro_torch.kernels.flash_prefill.kernel import (
        CUDA_CORE,
        WGMMA,
        bwd_design,
        grid_prefill_bwd,
    )
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_lse
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref
    earlier_bwd = _flash_bwd_tool().earlier_bwd

    dtype = torch.bfloat16
    assert bwd_design(dtype, D) == WGMMA
    q, k, v, do = _bwd_inputs(card, B, S, T, H, Hkv, D, dtype, seed=D + S)
    out, lse = flash_prefill_lse(q, k, v, causal)
    want = flash_prefill_bwd_ref(q, k, v, out, do, lse, causal)
    runs = [grid_prefill_bwd(q, k, v, out, do, lse, causal, which=which)
            for which in (CUDA_CORE, WGMMA)] + [earlier_bwd(q, k, v, out, do, lse, causal)]
    for got in runs:
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_bwd_limit(dtype, w))
    with pytest.raises(ValueError, match="wgmma"):
        grid_prefill_bwd(q.float(), k.float(), v.float(), out.float(), do.float(), lse, causal,
                         which=WGMMA)


#: (B, S, T, H, Hkv, D, causal): chip_smoke.py phase 28's wgmma shapes (glm4-9b's
#: training microbatch, granite-moe, phi-3-vision's D = 96, whisper's encoder and
#: cross calls), one row and one key, ragged S and T around the 128- and 64-row
#: tiles
BWD_WGMMA_SHAPES = [(2, 4096, 4096, 32, 2, 128, True), (2, 2048, 2048, 16, 8, 64, True),
                    (1, 2048, 2048, 32, 32, 96, True), (2, 1500, 1500, 20, 20, 64, False),
                    (2, 224, 1500, 20, 20, 64, False), (1, 1, 1, 16, 1, 128, True),
                    (2, 193, 193, 16, 2, 128, True), (1, 65, 65, 4, 1, 64, True),
                    (2, 37, 150, 8, 2, 64, False), (1, 300, 70, 8, 2, 128, False),
                    (2, 150, 150, 8, 4, 96, False), (1, 1, 1, 4, 2, 96, True)]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", BWD_WGMMA_SHAPES,
                         ids=["-".join(map(str, s)) for s in BWD_WGMMA_SHAPES])
def test_flash_prefill_bwd_wgmma_design_at_every_head_group(card, B, S, T, H, Hkv, D, causal):
    """The wgmma design at every divisor hg of H / Hkv (the query heads of a
    dK/dV block, whose float32 partials the third launch sums in head
    order): within 8 bf16 ulps of each output's largest, two runs bit for
    bit, dq the same at every hg."""
    from repro_torch.kernels.flash_prefill.kernel import (
        WGMMA,
        _entry_bwd_wgmma,
        bwd_design,
        launch_bwd_wgmma,
    )
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_lse
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref

    dtype = torch.bfloat16
    assert bwd_design(dtype, D) == WGMMA
    q, k, v, do = _bwd_inputs(card, B, S, T, H, Hkv, D, dtype, seed=S + T + D)
    out, lse = flash_prefill_lse(q, k, v, causal)
    want = [flash_prefill_bwd_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], out[b:b + 1],
                                  do[b:b + 1], lse[b:b + 1], causal) for b in range(B)]
    want = [torch.cat([w[i] for w in want]) for i in range(3)]
    g = H // Hkv
    dq_first = None
    for hg in [d for d in range(1, g + 1) if g % d == 0]:
        runs = []
        for _ in range(2):
            delta = torch.empty(B, H, S, dtype=torch.float32, device=card)
            got = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
            launch_bwd_wgmma(_entry_bwd_wgmma(), q, k, v, out, do, lse, delta, *got, causal,
                             hg=hg)
            runs.append(got)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), hg
        for a, w in zip(runs[0], want):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                       atol=_bwd_limit(dtype, w, _cancel_floor(do, v)))
        dq_first = runs[0][0] if dq_first is None else dq_first
        assert torch.equal(runs[0][0], dq_first)


def test_flash_prefill_bwd_designs_by_name_and_what_they_refuse(card):
    from repro_torch.kernels.flash_prefill.kernel import (
        BWD_LAUNCHES,
        WGMMA,
        _entry_bwd_wgmma,
        bwd_plan,
        grid_prefill_bwd,
        launch_bwd_wgmma,
    )
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_lse
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref

    q, k, v, do = _bwd_inputs(card, 2, 100, 100, 8, 2, 128, torch.bfloat16, seed=3)
    out, lse = flash_prefill_lse(q, k, v)
    want = flash_prefill_bwd_ref(q, k, v, out, do, lse)
    reset_launch_counts()
    for which in BWD_LAUNCHES:
        for g, w in zip(grid_prefill_bwd(q, k, v, out, do, lse, which=which), want):
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=_bwd_limit(torch.bfloat16, w))
    assert launch_counts()["flash_prefill_bwd"] == 0  # grid_prefill_bwd itself counts nothing
    with pytest.raises(ValueError, match="no backward design"):
        grid_prefill_bwd(q, k, v, out, do, lse, which="wgmma")
    with pytest.raises(ValueError, match="wgmma"):  # float32: no wgmma without TF32's loss
        grid_prefill_bwd(q.float(), k.float(), v.float(), out.float(), do.float(), lse,
                         which=WGMMA)
    q16, k16, v16, do16 = _bwd_inputs(card, 1, 64, 64, 4, 2, 16, torch.bfloat16, seed=4)
    out16, lse16 = flash_prefill_lse(q16, k16, v16)
    with pytest.raises(ValueError, match="wgmma"):  # D = 16: the CUDA-core design's alone
        grid_prefill_bwd(q16, k16, v16, out16, do16, lse16, which=WGMMA)
    delta = torch.empty(2, 8, 100, dtype=torch.float32, device=card)
    got = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    with pytest.raises(RuntimeError, match="CUDA error"):  # hg must divide H / Hkv = 4
        launch_bwd_wgmma(_entry_bwd_wgmma(), q, k, v, out, do, lse, delta, *got, True, hg=3)
    with pytest.raises(RuntimeError, match="CUDA error"):  # a plan the library does not hold
        launch_bwd_wgmma(_entry_bwd_wgmma(), q, k, v, out, do, lse, delta, *got, True,
                         plan={**bwd_plan(128), "dq_stages": 7})


@pytest.mark.parametrize("D", [64, 96, 128, 192, 256])
def test_wgmma_design_writes_the_lse_and_splits_p_for_training(card, D):
    from repro_torch.kernels.flash_prefill.kernel import WGMMA, design, grid_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_lse_ref

    q, k, v, _ = _bwd_inputs(card, 2, 300, 300, 8, 2, D, torch.bfloat16, seed=D)
    assert design(q.dtype, D) == WGMMA
    reset_launch_counts()
    served = flash_prefill(q, k, v)
    lse = torch.empty(2, 8, 300, dtype=torch.float32, device=card)
    assert torch.equal(grid_prefill(q, k, v, True, lse=lse), served)
    assert launch_counts()["flash_prefill"] == 1  # grid_prefill itself counts nothing
    want_out, want_lse = flash_prefill_lse_ref(q, k, v, True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    # training's form: P split into bf16 hi + lo for the P V product
    split_lse = torch.empty_like(lse)
    split = grid_prefill(q, k, v, True, lse=split_lse, split_p=True)
    torch.testing.assert_close(split_lse, want_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(split.float(), want_out.float(), rtol=0,
                               atol=_attention_limit(torch.bfloat16, want_out))


def test_flash_prefill_bwd_refuses_what_it_cannot_take(card):
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_bwd, flash_prefill_lse

    q, k, v, do = _bwd_inputs(card, 1, 64, 64, 4, 2, 264, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="head_dim"):  # past 256, the forward's largest too
        flash_prefill_bwd(q, k, v, q.clone(), do, torch.zeros(1, 4, 64, device=card))
    q, k, v, do = _bwd_inputs(card, 1, 64, 64, 4, 2, 64, torch.bfloat16, seed=1)
    out, lse = flash_prefill_lse(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_prefill_bwd(q, k, v, out, do.transpose(1, 2).contiguous().transpose(1, 2), lse)
    with pytest.raises(ValueError, match="lse"):
        flash_prefill_bwd(q, k, v, out, do, lse[:, :, :10].contiguous())


def test_wrappers_without_a_backward_raise_under_autograd(card):
    from repro_torch.kernels.selective_scan.ops import selective_scan

    bf = torch.bfloat16
    q = torch.randn(2, 8, 128, device=card, dtype=bf, requires_grad=True)
    k = torch.randn(2, 64, 2, 128, device=card, dtype=bf)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=card)
    x = torch.randn(1, 4, 128, device=card, requires_grad=True)
    calls = [lambda: decode_attention(q, k, k, lengths),
             lambda: flash_prefill(torch.randn(1, 64, 8, 128, device=card, dtype=bf), k[:1],
                                   k[:1].detach().requires_grad_(True)),
             lambda: selective_scan(x, x.detach(), torch.randn(128, 16, device=card),
                                    torch.randn(1, 4, 16, device=card),
                                    torch.randn(1, 4, 16, device=card),
                                    torch.randn(128, device=card),
                                    torch.zeros(1, 128, 16, device=card))]
    reset_launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()  # the same call without autograd runs
    counts = launch_counts()
    assert [counts[n] for n in ("decode_attention", "flash_prefill",
                                "selective_scan")] == [1, 1, 1]


def test_smoke_training_step_on_the_card_matches_the_cpu(card):
    """Two steps of the float32 glm4-9b smoke model, 2 microbatches: the card
    through the kernels (a CUDA-core training forward and the backward
    kernel) against the CPU through the plain versions."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWState, OptimizerConfig, tree_leaves, tree_map
    from repro_torch.train.train_step import TrainState, create_train_state, make_train_step

    cfg = get_smoke("glm4-9b")
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    batches = [SyntheticLM(DataConfig(cfg.vocab_size, 64, 4)).next_batch() for _ in range(2)]
    out = {}
    start = create_train_state(cfg, opt_cfg, seed=0, device="cpu")
    for dev in ("cpu", card):
        copy = lambda t: t.detach().to(dev).clone()
        state = TrainState(tree_map(lambda t: copy(t).requires_grad_(True), start.params),
                           AdamWState(0, tree_map(copy, start.opt.m), tree_map(copy, start.opt.v)))
        step = make_train_step(cfg, opt_cfg, n_microbatches=2)
        reset_launch_counts()
        losses = []
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out[str(dev)] = (losses, [p.detach().cpu() for _, p in tree_leaves(state.params)])
        if dev == card:
            L = cfg.n_layers
            assert launch_counts()["flash_prefill"] == 2 * L * 2 * 2
            assert launch_counts()["flash_prefill_bwd"] == 2 * L * 2 * 2
    (lc, pc), (lk, pk) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(lk, lc, rtol=1e-5)
    for a, b in zip(pc, pk):
        torch.testing.assert_close(b, a, rtol=0, atol=0.1 * opt_cfg.lr)


#: (n, S, w0, nonzero start state): every head dim at S of one step, one short
#: of the backward's 16-step chunk, one chunk, one past it and 2049; slow decay
#: (rwkv6's w0 = -6, w ~ 0.9975) from zero, fast (w ~ 1e-3) from a nonzero state
WKV_BWD_CASES = [(n, S, w0, nonzero) for n in (16, 32, 64) for S in (1, 15, 16, 17, 2049)
                 for w0, nonzero in ((-6.0, False), (math.log(-math.log(1e-3)), True))]


def _wkv_bwd_inputs(card, B, S, H, n, w0, nonzero, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v, dy = (torch.randn(B, S, H, n, generator=gen, device=card) for _ in range(4))
    w = torch.exp(-torch.exp(w0 + 0.12 * torch.randn(B, S, H, n, generator=gen, device=card)))
    u = 0.1 * torch.randn(H, n, generator=gen, device=card)
    s0 = (torch.randn(B, H, n, n, generator=gen, device=card) if nonzero
          else torch.zeros(B, H, n, n, device=card))
    return r, k, v, w, u, s0, dy


@pytest.mark.parametrize("n,S,w0,nonzero", WKV_BWD_CASES,
                         ids=[f"n{n}-S{S}-{'fast' if nz else 'slow'}" for n, S, _, nz in
                              WKV_BWD_CASES])
def test_wkv6_bwd_matches_plain(card, n, S, w0, nonzero):
    """dr, dk, dv, dw and du within 1e-4 of each one's largest (chip_smoke.py's
    WKV_BWD_TOL), two runs bit for bit, two launches a call by design."""
    from repro_torch.kernels.wkv6.kernel import BWD_DESIGN, BWD_LAUNCHES
    from repro_torch.kernels.wkv6.ops import wkv6_bwd
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref

    r, k, v, w, u, s0, dy = _wkv_bwd_inputs(card, 2, S, 4, n, w0, nonzero, seed=n + S)
    reset_launch_counts()
    got = wkv6_bwd(r, k, v, w, u, s0, dy)
    assert launch_counts()["wkv6_bwd"] == BWD_LAUNCHES
    assert design_counts()["wkv6_bwd"] == {BWD_DESIGN: BWD_LAUNCHES}
    again = wkv6_bwd(r, k, v, w, u, s0, dy)
    want = wkv6_bwd_ref(r, k, v, w, u, s0, dy)
    for g, w_, like in zip(got, want, (r, r, r, r, u)):
        assert g.shape == like.shape and bool(torch.isfinite(g).all())
        assert float((g - w_).abs().max()) <= 1e-4 * float(w_.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wkv6_bwd_raises_on_what_it_cannot_take(card):
    from repro_torch.kernels.wkv6.ops import wkv6_bwd

    r, k, v, w, u, s0, dy = _wkv_bwd_inputs(card, 1, 5, 2, 64, -6.0, False, seed=1)
    odd = [t[..., :8].contiguous() for t in (r, k, v, w)]
    with pytest.raises(ValueError, match="head dim"):
        wkv6_bwd(*odd, u[:, :8].contiguous(), s0[:, :, :8, :8].contiguous(), dy[..., :8])
    with pytest.raises(ValueError, match="dy"):
        wkv6_bwd(r, k, v, w, u, s0, dy[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_bwd(r, k, v, w, u, s0, dy.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):
        wkv6_bwd(r, k, v, w, u, s0, dy.double())


def test_wkv6_function_on_the_card(card):
    """``wkv6`` under autograd on CUDA tensors: the forward kernel on a fresh
    state (the start state left as it was), the backward kernel's outputs as
    the inputs' gradients, one launch of each kernel's call; a start state
    that requires grad and a gradient into the final state raise."""
    from repro_torch.kernels.wkv6.kernel import BWD_LAUNCHES
    from repro_torch.kernels.wkv6.ops import wkv6_bwd

    r, k, v, w, u, s0, dy = _wkv_bwd_inputs(card, 2, 40, 4, 64, -6.0, True, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    state = s0.clone()
    reset_launch_counts()
    y, final = wkv6(*leaves, state)
    want_y, want_final = wkv6_ref(r, k, v, w, u, s0)
    assert torch.equal(state, s0)
    assert float((y.detach() - want_y).abs().max()) <= 1e-5 * float(want_y.abs().max())
    assert float((final - want_final).abs().max()) <= 1e-5 * float(want_final.abs().max())
    y.backward(dy)
    assert launch_counts()["wkv6"] == 1 and launch_counts()["wkv6_bwd"] == BWD_LAUNCHES
    for leaf, want in zip(leaves, wkv6_bwd(r, k, v, w, u, s0, dy)):
        assert torch.equal(leaf.grad, want)
    with pytest.raises(RuntimeError, match="start state"):
        wkv6(leaves[0], k, v, w, u, s0.clone().requires_grad_(True))
    y, final = wkv6(*leaves, s0)
    with pytest.raises(RuntimeError, match="final state"):
        ((y * dy).sum() + final.sum()).backward()


def _step_grads(cfg, params, batch, names):
    """loss, grad_norm and a copy of each block weight's gradient named in
    ``names``, by (layer, path), of one forward and backward."""
    from repro_torch.models.model import forward_train
    from repro_torch.train.optimizer import global_norm, tree_map

    tree_map(lambda p: setattr(p, "grad", None), params)
    loss, _ = forward_train(cfg, params, batch)
    loss.backward()
    picked = {}

    def walk(tree, i, path):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, i, f"{path}{key}/")
            elif key in names:
                picked[(i, path + key)] = leaf.grad.clone()

    for i, p in enumerate(params["blocks"]):
        walk(p, i, "")
    assert len(picked) == cfg.n_layers * len(names)
    return float(loss.detach()), float(global_norm(tree_map(lambda p: p.grad, params))), picked


#: (arch, depth, block weights compared): gemma-7b's attention at head_dim 256,
#: rwkv6's time mix
FULL_WIDTH_STEPS = [("gemma-7b", 1, ("wq", "wk", "wv", "wo")),
                    ("rwkv6-1.6b", 2, ("w_r", "w_k", "w_v", "w_g", "w_o", "w_lora_a", "w_lora_b",
                                       "w0", "u", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))]


@pytest.mark.parametrize("arch,depth,names", FULL_WIDTH_STEPS,
                         ids=[f"{a}-depth{d}" for a, d, _ in FULL_WIDTH_STEPS])
def test_full_width_training_step_kernels_match_plain(card, monkeypatch, arch, depth, names):
    """One forward and backward at full width (random weights from seed 0,
    1 x 512 SyntheticLM tokens) through the kernels against the same through
    the plain versions on the card: the loss within 1e-3, grad_norm within
    1e-2, each compared weight's gradient within 2e-2 relative Frobenius
    (chip_smoke.py's training gates); two launches of the forward kernel a
    layer (remat) and one backward call.  gemma-7b in bf16; rwkv6 in
    float32 compute, where its time-mix gradients are not bf16 rounding
    noise (chip_smoke.py's TIME_MIX_WEIGHTS)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_prefill import ref as attn_ref
    from repro_torch.kernels.flash_prefill.kernel import BWD_LAUNCHES, bwd_design
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import BWD_LAUNCHES as WKV_BWD_LAUNCHES
    from repro_torch.models import attention
    from repro_torch.models.model import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import tree_map

    cfg = dataclasses.replace(get_arch(arch), n_layers=depth)
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = tree_map(lambda t: t.requires_grad_(True), init_params(cfg, seed=0, device=card))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 512, 1)).next_batch()
    reset_launch_counts()
    loss_k, gnorm_k, grads_k = _step_grads(cfg, params, batch, names)
    counts = launch_counts()
    with monkeypatch.context() as patch:
        if cfg.family == "ssm":
            assert counts["wkv6"] == 2 * depth and counts["wkv6_bwd"] == WKV_BWD_LAUNCHES * depth
            assert counts["flash_prefill"] == counts["flash_prefill_bwd"] == 0

            def forward(r, k, v, w, u, state):
                y, final = wkv6_ref(r, k, v, w, u, state)
                state.copy_(final)
                return y

            patch.setattr(wkv_ops, "_forward", forward)
            patch.setattr(wkv_ops, "wkv6_bwd", wkv_ops.wkv6_bwd_ref)
        else:
            n_bwd = BWD_LAUNCHES[bwd_design(torch.bfloat16, cfg.head_dim)]
            assert counts["flash_prefill"] == 2 * depth
            assert counts["flash_prefill_bwd"] == n_bwd * depth
            patch.setattr(attention, "flash_prefill_lse", attn_ref.flash_prefill_lse_ref)
            patch.setattr(attention, "flash_prefill_bwd", attn_ref.flash_prefill_bwd_ref)
        loss_p, gnorm_p, grads_p = _step_grads(cfg, params, batch, names)
    assert launch_counts() == counts
    assert math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    assert abs(gnorm_k - gnorm_p) <= 1e-2 * gnorm_p
    for key, want in grads_p.items():
        err = float(torch.linalg.vector_norm(grads_k[key] - want) / torch.linalg.vector_norm(want))
        assert err <= 2e-2, key
