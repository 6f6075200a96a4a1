#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit, and builds the kernels from the checkout's sources on first use
(into build/repro_torch/).  Phases, in order; the first failure stops the
script with a non-zero exit:

1. versions, and the card's name and power limit (nvidia-smi);
2. build every kernel;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (N = 1e6 items, B = 1000 ids, mass at K = 1 and 64;
   segsum 1e6 -> 15 625 and 65 536 -> 1024, bucket_mass at K = 63 and 64
   over a real mid-run ogb_tree histogram), and its time beside its bound,
   the plain version's and a library call's; the histogram in both its
   plans, at the chunk's shape (bin tiles) and at a re-anchor's (id slices:
   the bucket ids of that mid-run state's y and y - p, 1e6 ids over 65 536
   buckets), one device kernel a call, and the floor of a time taken this
   way (one block that writes one float); the standalone apply, and the
   clip in the warm projection's epilogue (project_warm less
   project_warm_tau);
   and the two persistent threshold solves the main paths launch (the warm
   projection, 5 sweeps from a mid-run tau, and ogb_tree's bucket solve, 30
   halvings over that histogram), cold and warm in L2, beside its
   whole-solve bound, its plain version and the earlier design (the K-way
   kernel and PyTorch's scalar ops, a launch at a time); the tree's two
   sums: the whole-tree build in one launch (1e6 leaves, and the 65 536
   buckets) beside the per-level design it replaced, and the batched tree
   update at a real chunk's three calls (recorded from that mid-run state)
   and at a run of 2000 deltas under one node, each bit for bit its plain
   version on the card and on the CPU;
4. the dense main path: run(policy_def("ogb")) over zipf(0.8) with
   N = 1e6, T = 1e7, C = 50 000, window 1000, every kernel's launches
   counted, the histogram's all bin tiles and the clip's all in the
   projection's epilogue;
5. the card against the CPU (the plain versions) over the first 200 chunks;
6. resume: 2000 chunks in two calls equal one call, bit for bit;
7. where a chunk's time goes, from torch.profiler over 300 chunks;
8. the lazy main path: run(policy_def("ogb_tree")) over the same trace,
   launches, host syncs and re-anchors counted (3 tree builds at init and
   a re-anchor, 3 tree updates and a bin-tiles histogram a chunk), its
   fractional hit ratio held to the JAX reference's for this trace and eta;
9. ogb_tree on the card against the CPU over 200 chunks, two runs and a
   resumed run bit for bit, and a re-anchor in every chunk (batch_hint=1:
   200 chunks on the card, 50 against the CPU), two id-slices histograms
   a re-anchor;
10. Madow sampling (madow, madow_tree): 2000 chunks each, occupancy exactly
   C in every chunk (madow_tree: one tree build a chunk), the card against
   the CPU over 100 chunks;
11. where an ogb_tree chunk's time goes, from torch.profiler over 300 chunks:
   no PyTorch accumulate (indexing_backward_kernel*) left on it;
12. the attention kernels against their plain versions, in bf16 and f32,
   each line naming the design that ran (bf16: wgmma+tma prefill and
   mma.sync+cp.async decode; f32: the CUDA-core designs): flash-decode at
   glm4-9b's B=8, H=32, Hkv=2, D=128 over S = 32 768 (lengths from a seed,
   with 1, S and a length that is no multiple of the tile), at serving's
   S = 2080 (lengths 2049..2055 and 2080), at qwen3-14b's and gemma-7b's
   heads, at phi-3-vision's D = 96 and at a q-group of 32;
   flash-prefill at glm4-9b B=1, S=4096, a ragged S=4000, serving's B=8,
   S=2048, gemma-7b's D=256 and D=192; two runs bit for bit;
13. their times cold and warm in L2, beside the plain versions, one
   scaled_dot_product_attention call each and their bounds, at glm4-9b's
   long shapes (prefill B=1, S=4096; decode B=8, S=32 768) and at the
   shapes the served model launches them (prefill B=8, S=2048; decode B=8,
   S=2080, lengths 2049..2056); and the bf16 decode design at split
   lengths around split_plan's;
14. serving at glm4-9b's full width: ServeEngine with random bf16 weights
   drawn on the card, an OGB PagedKVPool, 4 generate calls of 8 prompts of
   2048 tokens and 32 new tokens, half of each batch hot prompts; every
   prefill and decode launch counted;
   14b. where a prefill and a decode step go, from torch.profiler;
15. the served model through the kernels against the same model through
   the plain versions on the card: last-token logits and the first greedy
   token after prefill (beside a run with float64 prefill attention, the
   yardstick of how far rounding alone moves the logits), 8 teacher-forced
   decode steps, and two generate calls on equal prompts;
16. the slot automaton (LRU, FIFO, LFU, FTPL; impl="dense") against its plain version:
   each kind at C = 25, 250, 1000 and the design's largest (16 384), zipf
   and adversarial ids (10 000 a case in 2 launches, from empty slots),
   and padded carries; hits, stats and the whole carry bit for bit on the
   card and against the CPU; a larger carry raises; its time a request,
   cold, at each C, and at the quick scenarios' shape beside its bound and
   its plain version on the card;
17. every unsized scenario with a policy set (fig2_adversarial, fig7_ms_ex,
   fig7_systor, fig8_cdn, fig8_twitter, real_like_cdn, real_like_twitter)
   through run_scenario on the card: at mini every automaton, ARC and
   OPT(static) row equal to the committed golden (tests/cachesim/golden,
   read as data) and the OGB and OMD regrets within its tolerance; at quick
   every row against the port's CPU run, made meanwhile in worker
   processes (the automata exactly), and the LRU, LFU and FTPL rows (the
   tree automata, their default) equal to the dense slot kernel's runs of
   the same trace; a launch a chunk of each automaton row (slot_automaton
   for FIFO, tree_lru for LRU, minpair_automaton for LFU and FTPL; the
   LRU's possible ring compactions a compaction launch and an int32 tree
   build each), the OGB row's histogram, mass and apply and the OMD row's
   histogram once a chunk;
18. paper scale: fig2_adversarial at full (N = 1000, T = 1e6, C = 250,
   every row, ARC on the host), held to the figure's claims; fig8_cdn at
   full (N = 1e6, T = 2e7, C = 50 000, B = 1000, a window of 1e6) for OGB,
   OMD and the tree LRU, LFU and FTPL, OGB held to a share of OPT(static)
   and above LRU (Fig. 8-left), each row's hit ratio and us a request
   printed, every tree kernel launched, three chunks of each automaton row
   run again under torch's sync debug mode "error" (no read of the device
   in a chunk), and FIFO at C = 50 000 raising (no tree form; past the slot
   kernel's 16 384);
19. the tree automata's kernels against their plain versions on the card,
   bit for bit and against the CPU: tree_lru and minpair_automaton (LFU,
   FTPL) at C = 23, 1000, 16 384 and 50 000 from empty slots, every case
   evicting, a forced ring compaction and padded slots; the int32 tree
   build at 262 144 and 2^21 leaves; each kernel's time cold from a full
   carry at quick's shape (C = 1000, N = 20 000, a 10 000-request chunk)
   and fig8_cdn full's (C = 50 000, N = 1e6, a 1e6-request chunk) beside
   its bound and its plain version on the card, and a ring compaction's.

The line before the last is the card and its power limit again, preceded
by one JSON line of per-kernel numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, T, C, W = 1_000_000, 10_000_000, 50_000, 1000
ALPHA = 0.8
CPU_CHUNKS, RESUME_CHUNKS, PROFILE_CHUNKS = 200, 2000, 300
MADOW_CHUNKS, MADOW_CPU_CHUNKS, REANCHOR_CHUNKS, REANCHOR_CPU_CHUNKS = 2000, 100, 200, 50
V = 65536  # ogb_tree's buckets
#: fractional hit ratio of the JAX reference's ogb_tree (repro.cachesim.api)
#: over this trace at this eta, on the CPU
REF_TREE_FRAC_HIT_RATIO = 0.4842919
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense, same source
#: us a request of the two replay paths at this N and T before the serving
#: path was added: this script at commit e3b81f4 (NVIDIA H100 80GB HBM3, 700 W)
EARLIER_US_PER_REQUEST = {"ogb": 1.6159251664000003, "ogb_tree": 5.9824}
ARCH = "glm4-9b"  # the served model, at full width
SERVE_B, SERVE_S, SERVE_NEW, SERVE_CALLS = 8, 2048, 32, 4
PAGE_SIZE, POOL_PAGES, HOT_PROMPTS = 64, 4096, 6  # a 262 144-token prefix pool
TEACHER_STEPS = 8
MASS_TOL = 1e-6 * N  # float32 summation order over N items
SWEEPS = 5  # the warm projection's Newton sweeps a chunk (replay's default)
TREE_ITERS = 30  # ogb_tree's halvings a chunk (OGB_TREE_ITERS)
HOLD_CYCLES = 2_000_000  # about 1 ms of device time at the H100's clock
REPLACES = {
    "histogram": "src/repro/kernels/scatter_counts/kernel.py:28",
    "mass": "src/repro/kernels/capped_simplex/kernel.py:59",
    "apply": "src/repro/kernels/capped_simplex/kernel.py:97",
    "segsum": "src/repro/kernels/prefix_tree/kernel.py:43",
    # the tree's second sum: the reference computes it outside Pallas
    # (src/repro/kernels/prefix_tree/ops.py:89, tree_update); it is row 4's
    # redesign, beside the segsum levels of the build
    "tree_update": "src/repro/kernels/prefix_tree/kernel.py:43",
    "bucket_mass": "src/repro/kernels/prefix_tree/kernel.py:69",
    "flash_prefill": "src/repro/kernels/flash_prefill/kernel.py:29",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:29",
    # no Pallas kernel: the reference scans the automata's steps with lax.scan
    "slot_automaton": "src/repro/cachesim/engines.py:160",
    "tree_lru": "src/repro/cachesim/tree_engines.py:151",
    "minpair_automaton": "src/repro/cachesim/tree_engines.py:375",
}
SOURCES = {
    "histogram": "src/repro_torch/kernels/scatter_counts/csrc/histogram.cu",
    "mass": "src/repro_torch/kernels/capped_simplex/csrc/mass.cu",
    "apply": "src/repro_torch/kernels/capped_simplex/csrc/apply.cu",
    "segsum": "src/repro_torch/kernels/prefix_tree/csrc/segsum.cu",
    "tree_update": "src/repro_torch/kernels/prefix_tree/csrc/tree_update.cu",
    "bucket_mass": "src/repro_torch/kernels/prefix_tree/csrc/bucket_mass.cu",
    "flash_prefill": "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
    "decode_attention": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "slot_automaton": "src/repro_torch/kernels/slot_automaton/csrc/slot_automaton.cu",
    "tree_lru": "src/repro_torch/kernels/tree_lru/csrc/tree_lru.cu",
    "minpair_automaton": "src/repro_torch/kernels/minpair_automaton/csrc/minpair_automaton.cu",
}
KERNELS = ("histogram", "mass", "apply", "segsum", "tree_update", "bucket_mass",
           "flash_prefill", "decode_attention", "slot_automaton", "tree_lru",
           "minpair_automaton")
#: the one design of each kernel that has one (the others name theirs in
#: their rows: the attention kernels by design(), the histogram, the clip
#: and the two threshold solves by the launches of their main path)
DESIGNS = {
    "segsum": "whole tree, one launch: a block a tile of 4096 leaves (levels 1-2 in shared "
              "memory), the last block by atomic ticket the levels above; each node one warp, "
              "fixed-order shuffles",
    "tree_update": "a block a level: each node's first delta by atomicMin into an int32 scratch, "
                   "then a warp a node sums its deltas 32 at a time in float64 (in any order where "
                   "every partial sum is exact, checked on the card; else in input order) and "
                   "rounds it once; no sort, untouched nodes unwritten",
    "slot_automaton": "one block a chunk: the slots spread over its threads in shared memory "
                      "beside their eviction keys, the requests in order, one block-wide argmin "
                      "over (key, slot) a request (redux.sync, one __syncthreads; none on one "
                      "warp); counts a tile of requests at a time",
    "tree_lru": "one block a chunk, a thread a request of a 256-request sub-chunk: previous "
                "request by a scan of the sub-chunk's ids in shared memory or last[j], reuse "
                "distance = the tree's marks after it (total less an unrolled prefix read "
                "through L2) + the sub-chunk's dominance term; marks moved once an item by "
                "integer atomics; a possible ring compaction a grid launch (ranks by prefix "
                "count) and an int32 tree build",
    "minpair_automaton": "one warp a chunk, the requests in order, a tile of 32 read at once "
                         "(counts by rank in the tile, imap kept current by broadcast); root "
                         "and argmin by warp-wide lexicographic reductions (redux.sync) over "
                         "64 children a level, levels above the leaves in shared memory, "
                         "leaves and slots in L2; ancestors recomputed up to the first "
                         "unchanged node",
}
#: the design of the standalone apply kernel, which phase 3 times (the dense
#: main path's clip is the projection's epilogue)
APPLY_STANDALONE = "standalone: 16-byte body, 2 float4 of f and c in flight a thread"
DENSE_KERNELS = 21  # device kernels a dense chunk launches (phase 7)
#: kernels off the replay paths: serving's attention, the scenario path's automata
OFF_PATH = {"flash_prefill": 0, "decode_attention": 0, "slot_automaton": 0, "tree_lru": 0,
            "minpair_automaton": 0}
#: the port's kernels in the profiler's rows, by the names of their functions
PORT_KERNEL_NAMES = ("tree_update_kernel", "tree_build_kernel", "bin_tiles_kernel",
                     "solve_buckets_kernel", "project_warm_kernel")
#: device_kernels: profiled calls, and the most while every one shows none
PROFILE_TRIES, PROFILE_MOST_TRIES = 3, 10
FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores, NVIDIA's data sheet
AUTOMATA = ("lru", "fifo", "lfu", "ftpl")
#: phase 16's capacities (and the design's largest), ids a case and launches
AUTOMATON_CS, AUTOMATON_IDS, AUTOMATON_CHUNKS = (25, 250, 1000), 10_000, 2
#: the quick scenarios' shape: N = 20 000, C = 1000, a window of T / 20
QUICK_N, QUICK_C, QUICK_WINDOW = 20_000, 1000, 10_000
#: the seven unsized scenarios with a policy set, and their device rows
SCENARIO_NAMES = ("fig2_adversarial", "fig7_ms_ex", "fig7_systor", "fig8_cdn", "fig8_twitter",
                  "real_like_cdn", "real_like_twitter")
DEVICE_POLICIES = ("ogb", "omd", "ftpl", "lru", "lfu", "fifo")
FRACTIONAL_ROWS = ("OGB", "OMD")
#: tests/cachesim/test_golden.py's tolerances
GOLDEN_EXACT, GOLDEN_FLOAT = 1e-12, 5e-3
#: card against CPU at quick, OGB and OMD: Poisson hits flip where f lies
#: within rounding of p (at most 1 in 1000 requests), and the fractional
#: reward sums float32 f's in another order (1e-4 relative)
QUICK_HIT_TOL, QUICK_FRAC_TOL = 1e-3, 1e-4
#: fig8_cdn at full: OGB's hit ratio at least this share of OPT(static)'s
FIG8_OGB_FLOOR = 0.85
#: fig8_cdn at full: the rows, and the automaton rows' chunks run again under
#: torch's sync debug mode "error"
FIG8_POLICIES, FIG8_SYNC_CHUNKS = ("ogb", "omd", "lru", "lfu", "ftpl"), 3
TREE_AUTOMATA = ("lru", "lfu", "ftpl")
#: phase 19's capacities, ids a case after the fill, and the two timed shapes
#: (C: catalog, chunk): quick's and fig8_cdn full's
TREE_CS, TREE_IDS = (23, 1000, 16384, 50000), 20_000
TREE_TIMED = {1000: (20_000, 10_000), 50000: (1_000_000, 1_000_000)}
#: the int32 tree build's timed leaves: a ring of C = 50 000 (ring_size), and
#: fig8_cdn full's ring (a window of 1e6)
INT32_BUILD_LEAVES = (262_144, 2_097_152)


class Failed(Exception):
    pass


def need(cond, what):
    if not cond:
        raise Failed(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """The least time for the work: bytes over HBM rate or ops over the peak
    (float32 outside the tensor cores unless another is given)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timed_ms(torch, fn, reps, flush=None, hold=HOLD_CYCLES, reset=None):
    """Mean device time of one fn() call, by CUDA events around each call.

    Before each call the device is held busy (torch.cuda._sleep, ``hold``
    cycles) until the host has enqueued the whole call, so the events time
    the device and not the host's launch overhead.  Cold (L2 flushed before
    each call) when ``flush`` is given, else warm in L2 from the previous
    call.  ``reset``, when given, runs before each call outside the events
    (and before the flush): a call that updates its inputs in place then
    runs on the same inputs every time."""
    if reset is not None:
        reset()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if reset is not None:
            reset()
        if flush is not None:
            flush()
        torch.cuda._sleep(hold)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def root_tau(y, cap):
    """The tau with sum(clip(y - tau, 0, 1)) = cap, by float64 bisection."""
    import numpy as np

    lo, hi = float(y.min()) - 1.0, float(y.max())
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if np.clip(y - mid, 0.0, 1.0).sum() >= cap:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def dense_tau(trace, eta, chunks=500):
    """A real mid-run tau of the dense main path: the carry's after ``chunks``."""
    from repro_torch import policy_def, run

    res = run(policy_def("ogb"), trace[: chunks * W], N, C, window=W, eta=eta, track_opt=False)
    return float(res.carry.tau)


def time_both(torch, label, kern, flush, reps=50, hold=HOLD_CYCLES):
    """Cold and warm device ms of ``kern``, printed."""
    cold, warm = timed_ms(torch, kern, reps, flush, hold), timed_ms(torch, kern, reps, None, hold)
    print(f"  {label}: cold {cold * 1e3:.2f} us, warm in L2 {warm * 1e3:.2f} us")
    return cold, warm


def earlier_warm_tau(torch, f, counts, eta, cap, lo, hi, tau0, sweeps):
    """The warm projection as the main path ran it before it was one launch:
    a K = 1 masses launch and PyTorch's 0-d ops a sweep (timed in phase 3
    as the earlier design of the same solve)."""
    from repro_torch.kernels.capped_simplex.ops import masses

    t = torch.clamp(tau0, lo, hi)
    for _ in range(sweeps):
        mass, cnt = masses(f, counts, eta, t.reshape(1))
        mass, cnt = mass[0], cnt[0]
        too_much = mass >= cap
        lo = torch.where(too_much, t, lo)
        hi = torch.where(too_much, hi, t)
        t_newton = t + (mass - cap) / torch.clamp(cnt, min=1.0)
        t_mid = 0.5 * (lo + hi)
        ok = (cnt > 0.0) & (t_newton >= lo) & (t_newton <= hi)
        t = torch.where(ok, t_newton, t_mid)
    return t


def earlier_solve(torch, cnt, total, cap, lo, hi, iters):
    """ogb_tree's bucket solve as its chunk ran it before it was one launch:
    a K-way bucket_masses launch and PyTorch's bracket ops a round.  Returns
    the call, with the grid fractions made once, as the chunk cached them."""
    from repro_torch.kernels.prefix_tree.kernel import bucket_masses
    from repro_torch.kernels.prefix_tree.ref import solve_rounds

    rounds = solve_rounds(iters)
    fractions = {h: torch.arange(1, 1 << h, dtype=torch.float32, device=lo.device) / (1 << h)
                 for h in set(rounds)}

    def call():
        a, b = lo, hi
        for h in rounds:
            taus = a + (b - a) * fractions[h]
            mass = bucket_masses(cnt, total, taus)
            c = (mass >= cap).sum().reshape(1)
            grid = torch.cat([a.reshape(1), taus, b.reshape(1)])
            a, b = grid.index_select(0, torch.cat([c, c + 1])).unbind()
        return a

    return call


def device_kernels(torch, fn):
    """Device kernels that one fn() call runs, from torch.profiler: the most
    that any of PROFILE_TRIES profiled calls shows, trying on (up to
    PROFILE_MOST_TRIES) while every try has shown none.  The profiler now
    and then drops a call's kernel records (PERF.md §7; three tries in a row
    once), which can only lower one try's count; a kernel too many shows in
    every try."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    seen = 0
    for attempt in range(PROFILE_MOST_TRIES):
        if attempt >= PROFILE_TRIES and seen:
            break
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = max(seen, sum(e.count for e in prof.key_averages()
                             if e.device_type == cuda and e.self_device_time_total > 0))
    return seen


def check_reanchor_histograms(torch, carry, flush, earlier):
    """Phase 3, the histogram at a re-anchor's shape: the bucket ids of a
    mid-run ogb_tree state's y (ycnt) and y - p (dcnt) over V buckets, as
    the re-anchor of tree_engines makes them, against the plain version,
    one device kernel a call, timed beside its bound, torch.bincount and
    ``earlier``, the design it replaced."""
    from repro_torch.cachesim.tree_engines import _ogb_bucket
    from repro_torch.kernels.scatter_counts.ops import ID_SLICES, design, histogram
    from repro_torch.kernels.scatter_counts.ref import histogram_ref

    y = torch.clamp(carry.y - carry.rho, 0.0, 1.0)
    sets = {"ycnt": _ogb_bucket(y, carry.w, V).to(torch.int32),
            "dcnt": _ogb_bucket(y - carry.p, carry.w, V).to(torch.int32)}
    out = {}
    for label, ids in sets.items():
        b = ids.numel()
        need(design(b, V) == ID_SLICES, f"histogram {label}: plan {design(b, V)}, not id slices")
        got, want = histogram(ids, V), histogram_ref(ids, V)
        need(torch.equal(got, want), f"histogram {label} differs from its plain version")
        need(torch.equal(histogram(ids, V), got), f"histogram {label}: two runs differ")
        kernels = device_kernels(torch, lambda ids=ids: histogram(ids, V))
        need(kernels == 1, f"histogram {label}: {kernels} device kernels a call, not 1")
        ms, warm = time_both(torch, f"histogram {label}, {ID_SLICES}",
                             lambda ids=ids: histogram(ids, V), flush)
        need(torch.equal(earlier(ids, V), want), f"histogram {label}: the earlier design differs")
        earlier_ms, earlier_warm = time_both(torch, f"histogram {label}, the earlier design",
                                             lambda ids=ids: earlier(ids, V), flush)
        plain = timed_ms(torch, lambda ids=ids: histogram_ref(ids, V), 20, flush)
        ids64 = ids.long()
        lib = timed_ms(torch, lambda ids64=ids64: torch.bincount(ids64, minlength=V), 20, flush)
        bound, by = bound_ms(4 * b + 4 * V, b)
        nnz, top = int(got.gt(0).sum()), int(got.max())
        print(f"histogram {label} ({b} ids over {V} buckets, {nnz} non-empty, the largest "
              f"{top}): exact, 1 device kernel a call; plain {plain * 1e3:.2f} us, "
              f"torch.bincount {lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {by}")
        out[label] = {"design": ID_SLICES, "ids": b, "bins": V, "non_empty": nnz, "ms": ms,
                      "warm_ms": warm, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                      "library_ms": lib, "max_abs_err": float((got - want).abs().max()),
                      "earlier_ms": earlier_ms, "earlier_warm_ms": earlier_warm}
    return out


def check_kernels(torch, dev, trace, eta, tau0, carry):
    """Phase 3: each kernel against its plain version, then timings."""
    from repro_torch.jaxcache.fractional import warm_bracket_hi
    from repro_torch.kernels.capped_simplex.ops import (
        apply,
        masses,
        project_warm,
        project_warm_tau,
    )
    from repro_torch.kernels.capped_simplex.ref import apply_ref, masses_ref, project_warm_tau_ref
    from repro_torch.kernels.scatter_counts.ops import BIN_TILES, design, histogram
    from repro_torch.kernels.scatter_counts.ref import histogram_ref

    gen = torch.Generator().manual_seed(1)
    f = (torch.rand(N, generator=gen) * (2.0 * C / N)).to(dev)
    ids = torch.from_numpy(trace[:W].astype("int32")).to(dev)
    eta_t = torch.tensor(eta, dtype=torch.float32, device=dev)
    need(design(W, N) == BIN_TILES, f"histogram: the chunk's plan is {design(W, N)}")
    counts = histogram(ids, N)
    want = histogram_ref(ids, N)
    need(torch.equal(counts, want), "histogram differs from its plain version")
    hist_err = float((counts - want).abs().max())
    kernels = device_kernels(torch, lambda: histogram(ids, N))
    need(kernels == 1, f"histogram: {kernels} device kernels a call, not 1")
    print(f"histogram, {BIN_TILES}: exact ({int(counts.gt(0).sum())} distinct ids of {W}), "
          f"1 device kernel a call")

    # Thresholds inside the range of y = f + eta * counts, so that every
    # check sees items on each side of the clip: the projection's root for
    # (f, counts), and K = 64 spread over [0, max(y)].
    y = (f.double() + eta * counts.double()).cpu().numpy()
    tau_root = root_tau(y, C)
    taus = {1: torch.tensor([tau_root], dtype=torch.float32, device=dev),
            64: torch.linspace(0.0, float(y.max()), 64, device=dev)}
    print(f"thresholds: max y {y.max():.6f}, root tau {tau_root:.9e}")
    errs = {}
    for k, tk in taus.items():
        mass, cnt = masses(f, counts, eta_t, tk)
        rmass, rcnt = masses_ref(f, counts, eta_t, tk)
        need(bool(mass[0] > 0) and bool(cnt.gt(0).any()),
             f"mass K={k}: no mass or no interior item, the check would be vacuous")
        need(torch.equal(cnt, rcnt), f"mass K={k}: interior counts differ")
        err = float((mass.double() - rmass.double()).abs().max())
        need(err <= MASS_TOL, f"mass K={k}: |mass - plain| = {err} > {MASS_TOL}")
        errs[k] = err
        print(f"mass K={k}: counts exact (interior {int(cnt.max())} items at most), "
              f"max |mass - plain| = {err:.3e} (limit {MASS_TOL:.1e})")
    root_mass = float(masses(f, counts, eta_t, taus[1])[0][0])
    need(abs(root_mass - C) <= MASS_TOL, f"mass at the root tau is {root_mass}, not C = {C}")
    tau = taus[1][0]
    out = apply(f, counts, eta_t, tau)
    out_ref = apply_ref(f, counts, eta_t, tau)
    need(torch.equal(out, out_ref), "apply differs from its plain version")
    apply_err = float((out - out_ref).abs().max())
    kept, total = int(out.gt(0).sum()), float(out.double().sum())
    need(kept > 0 and abs(total - C) <= MASS_TOL, f"apply kept {kept} items, sum {total}, not C")
    print(f"apply: exact ({kept} items above 0, sum {total:.6f}; mass at root {root_mass:.6f})")

    # the warm projection as the main path calls it: lo = 0, hi from the
    # chunk's step, tau0 a mid-run tau, SWEEPS sweeps, in one launch
    cap_t = torch.tensor(float(C), device=dev)
    lo, hi = torch.zeros((), device=dev), warm_bracket_hi(eta_t * float(W))
    tau0_t = torch.tensor(tau0, dtype=torch.float32, device=dev)
    warm = (f, counts, eta_t, cap_t, lo, hi, tau0_t, SWEEPS)
    proj = project_warm_tau(*warm)
    need(torch.equal(project_warm_tau(*warm), proj), "project_warm_tau: two runs differ")
    tau_k = float(proj)
    tau_plain = float(project_warm_tau_ref(*warm))
    tau_earlier = float(earlier_warm_tau(torch, *warm))
    dtau = abs(tau_k - tau_plain)
    need(math.isfinite(tau_k) and dtau <= 1e-6,
         f"project_warm_tau: |kernel - plain| = {dtau} > 1e-6")
    warm_mass = float(masses_ref(f, counts, eta_t, proj.reshape(1))[0][0])
    print(f"project_warm_tau, {SWEEPS} sweeps from tau0 {tau0:.9e} over [0, {float(hi):.6f}]: "
          f"tau {tau_k:.9e}, plain {tau_plain:.9e} (|d| {dtau:.3e}, limit 1e-6), earlier design "
          f"{tau_earlier:.9e}, float64 root {tau_root:.9e}; plain mass there {warm_mass:.4f} "
          f"(C = {C}); two runs bit for bit")
    # the projection with the clip in its epilogue, as the dense main path
    # calls it: project_warm_tau's tau, and f' the plain clip at it
    f_new, tau_e = project_warm(*warm)
    need(torch.equal(tau_e, proj), "project_warm: tau differs from project_warm_tau's")
    f_want = apply_ref(f, counts, eta_t, tau_e)
    need(torch.equal(f_new, f_want), "project_warm: f' differs from the plain clip at its tau")
    need(all(torch.equal(a, b) for a, b in zip(project_warm(*warm), (f_new, tau_e))),
         "project_warm: two runs differ")
    epi_err = float((f_new - f_want).abs().max())
    print(f"project_warm: tau equal to project_warm_tau's, f' equal to the plain clip at it, "
          f"bit for bit ({int(f_new.gt(0).sum())} items above 0, sum "
          f"{float(f_new.double().sum()):.6f}); two runs bit for bit")

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    ids64 = ids.long()
    t1 = taus[1]
    kernels = device_kernels(torch, lambda: project_warm(*warm))
    need(kernels == 1, f"project_warm: {kernels} device kernels a call, not 1")
    jobs = {
        "histogram": (lambda: histogram(ids, N), lambda: histogram_ref(ids, N),
                      lambda: torch.bincount(ids64, minlength=N)),
        "mass": (lambda: project_warm_tau(*warm), lambda: project_warm_tau_ref(*warm), None),
        "apply": (lambda: apply(f, counts, eta_t, tau), lambda: apply_ref(f, counts, eta_t, tau),
                  None),
    }
    bounds = {
        # ids read, the dense counts written; the B atomic adds are no bound
        "histogram": bound_ms(4 * W + 4 * N, W),
        # the whole solve: f and counts read once, five scalars read, tau
        # written; 9 operations an item a sweep
        "mass": bound_ms(8 * N + 5 * 4 + 4, SWEEPS * 9 * N),
        # f and counts read, f' written; 5 ops per item
        "apply": bound_ms(12 * N + 8, 5 * N),
    }
    errors = {"histogram": hist_err, "mass": dtau, "apply": apply_err}
    rows = {}
    for name, (kern, plain, lib) in jobs.items():
        ms = timed_ms(torch, kern, 50, flush)
        warm_ms = timed_ms(torch, kern, 50)
        plain_ms = timed_ms(torch, plain, 20, flush)
        lib_ms = timed_ms(torch, lib, 20, flush) if lib else None
        b, by = bounds[name]
        rows[name] = {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b,
                      "bound_by": by, "library_ms": lib_ms, "max_abs_err": errors[name]}
        lib_s = f", library {lib_ms * 1e3:.2f} us" if lib else ""
        print(f"{name}: cold {ms * 1e3:.2f} us, warm in L2 {warm_ms * 1e3:.2f} us "
              f"(plain {plain_ms * 1e3:.2f} us{lib_s}, bound {b * 1e3:.3f} us by {by})")
    # the earlier design of the same solve: SWEEPS K-way mass launches and
    # PyTorch's 0-d ops, a launch at a time; ~70 launches, so a longer hold
    # keeps the host's enqueueing out of the time
    # the clip in the projection's epilogue: project_warm less
    # project_warm_tau, both cold, timed one after the other; its bound is
    # f' written (f and c are read by the solve either way)
    tau_only, tau_only_warm = time_both(torch, "project_warm_tau (tau alone)",
                                        lambda: project_warm_tau(*warm), flush)
    fused, fused_warm = time_both(torch, "project_warm (tau and f' in one launch)",
                                  lambda: project_warm(*warm), flush)
    epi_bound, epi_by = bound_ms(4 * N, 3 * N)
    rows["apply"].update({
        "timed_design": APPLY_STANDALONE,
        "epilogue": {"design": "projection epilogue", "ms": fused - tau_only,
                     "warm_ms": fused_warm - tau_only_warm, "project_warm_ms": fused,
                     "project_warm_tau_ms": tau_only, "bound_ms": epi_bound, "bound_by": epi_by,
                     "max_abs_err": epi_err}})
    print(f"apply in the projection's epilogue: {(fused - tau_only) * 1e3:.2f} us cold, "
          f"{(fused_warm - tau_only_warm) * 1e3:.2f} us warm (bound {epi_bound * 1e3:.3f} us by "
          f"{epi_by}: f' written); one launch where the parent launched two")
    # the design the histogram replaced (a zero fill, then a global atomic
    # add an id; two launches), built from tools/time_histogram_designs.py
    from tools.time_histogram_designs import earlier_histogram

    earlier_hist = earlier_histogram()
    need(torch.equal(earlier_hist(ids, N), counts), "histogram: the earlier design differs")
    hist_earlier, hist_earlier_warm = time_both(torch, "histogram, the earlier design",
                                                lambda: earlier_hist(ids, N), flush)
    rows["histogram"].update({"earlier_design": "zero fill, then a global atomic add an id",
                              "earlier_ms": hist_earlier, "earlier_warm_ms": hist_earlier_warm})
    rows["histogram"]["reanchor"] = check_reanchor_histograms(torch, carry, flush, earlier_hist)
    # the floor of a time taken this way: one block that writes one float
    none = torch.empty(0, dtype=torch.int32, device=dev)
    floor, floor_warm = time_both(torch, "floor: histogram of 0 ids over 1 bin, one block",
                                  lambda: histogram(none, 1), flush)
    rows["histogram"].update({"floor_ms": floor, "floor_warm_ms": floor_warm})
    earlier, earlier_warm = time_both(
        torch, f"earlier design: {SWEEPS} x masses (K=1) + 0-d ops",
        lambda: earlier_warm_tau(torch, *warm), flush, hold=10 * HOLD_CYCLES)
    kway, kway_warm = time_both(torch, "masses K=1 (one K-way pass)",
                                lambda: masses(f, counts, eta_t, t1), flush)
    rows["mass"].update({
        "earlier_design": f"{SWEEPS} x K-way masses + 0-d PyTorch ops",
        "earlier_ms": earlier, "earlier_warm_ms": earlier_warm,
        "kway_k1_ms": kway, "kway_k1_warm_ms": kway_warm, "kway_k1_max_abs_err": errs[1]})
    t64 = taus[64]
    ms64 = timed_ms(torch, lambda: masses(f, counts, eta_t, t64), 50, flush)
    plain64 = timed_ms(torch, lambda: masses_ref(f, counts, eta_t, t64), 10, flush)
    b64, by64 = bound_ms(8 * N + 12 * 64, N * (2 + 7 * 64))
    print(f"mass K=64: cold {ms64 * 1e3:.2f} us (plain {plain64 * 1e3:.2f} us, "
          f"bound {b64 * 1e3:.3f} us by {by64}), max |mass - plain| = {errs[64]:.3e}")
    return rows


def check_main_path(torch, trace, eta):
    """Phase 4: the main path, every launch counted."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts

    pd = policy_def("ogb")
    reset_launch_counts()
    res = run(pd, trace, N, C, window=W)
    launches = launch_counts()
    designs = design_counts()
    m = T // W
    want = {"histogram": m, "mass": m, "apply": m, "segsum": 0, "tree_update": 0,
            "bucket_mass": 0, **OFF_PATH}
    f = res.final_f.astype(np.float64)
    print(f"main path: hit_ratio {res.hit_ratio}, frac_hit_ratio {res.frac_hit_ratio}, "
          f"regret {res.regret}, opt_hits {res.opt_hits}, us_per_request "
          f"{res.us_per_request}, wall {res.wall_seconds} s, sum f {f.sum()}, "
          f"eta {res.extras['eta']}, launches {launches}")
    print(f"ogb: {res.us_per_request} us a request at T={T} (at e3b81f4: "
          f"{EARLIER_US_PER_REQUEST['ogb']}); launches by design: mass {designs['mass']}, "
          f"histogram {designs['histogram']}, apply {designs['apply']}")
    need(res.extras["eta"] == eta, "main path resolved another eta")
    need(launches == want, f"launches {launches}, expected {want}")
    need(designs["histogram"] == {"bin tiles": m}, f"histogram designs {designs['histogram']}")
    need(designs["apply"] == {"projection epilogue": m}, f"apply designs {designs['apply']}")
    need(np.all(np.isfinite(res.reward)) and np.all(np.isfinite(res.aux)), "non-finite output")
    need(f.min() >= 0.0 and f.max() <= 1.0, "final f leaves [0, 1]")
    need(abs(f.sum() - C) <= 1e-4 * C, f"sum f = {f.sum()} is not C = {C}")
    need(0.0 < res.hit_ratio < 1.0, f"hit ratio {res.hit_ratio} out of range")
    return launches, designs


def check_card_against_cpu(trace, eta):
    """Phase 5: the same chunks through the kernels and the plain versions."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb")
    part = trace[: CPU_CHUNKS * W]
    card = run(pd, part, N, C, window=W, eta=eta)
    cpu = run(pd, part, N, C, window=W, eta=eta, device="cpu")
    dtau = float(np.abs(card.aux - cpu.aux).max())
    drew = float(np.max(np.abs(card.reward - cpu.reward) / np.abs(cpu.reward)))
    dhits = abs(int(card.hits.sum()) - int(cpu.hits.sum()))
    print(f"card vs CPU, {CPU_CHUNKS} chunks: max |dtau| {dtau:.3e}, max reward rel "
          f"{drew:.3e}, hits {int(card.hits.sum())} vs {int(cpu.hits.sum())}")
    need(dtau <= 1e-6, f"card and CPU tau differ by {dtau}")
    need(drew <= 1e-5, f"card and CPU reward differ by {drew} relative")
    need(dhits <= len(part) // 10_000, f"card and CPU hits differ by {dhits}")


def check_resume(torch, trace, eta):
    """Phase 6: two calls equal one, bit for bit."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb")
    part = trace[: RESUME_CHUNKS * W]
    half = len(part) // 2
    whole = run(pd, part, N, C, window=W, eta=eta)
    first = run(pd, part[:half], N, C, window=W, eta=eta)
    second = run(pd, part[half:], capacity=C, window=W, carry=first.carry)
    for name in ("reward", "hits", "aux", "occupancy"):
        joined = np.concatenate([getattr(first, name), getattr(second, name)])
        need(np.array_equal(joined, getattr(whole, name)), f"resume: {name} differs")
    need(all(torch.equal(a, b) for a, b in zip(second.carry, whole.carry)), "resume: carry differs")
    print(f"resume: {RESUME_CHUNKS} chunks in two calls == one call, bit for bit")


def breakdown(torch, trace, eta, kind="ogb"):
    """Phases 7 and 11: device busy share and kernel time by name over a
    short run of policy ``kind``; returns the numbers a chunk, and those of
    the port's kernels by name.  ogb_tree's chunk must run no PyTorch
    accumulate (its tree updates and request count are kernels of the
    port)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import policy_def, run

    pd = policy_def(kind)
    part = trace[: PROFILE_CHUNKS * W]
    plain = run(pd, part, N, C, window=W, eta=eta)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = run(pd, part, N, C, window=W, eta=eta)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / PROFILE_CHUNKS
    launches = sum(e.count for e in rows) / PROFILE_CHUNKS
    wall_us = plain.wall_seconds * 1e6 / PROFILE_CHUNKS
    prof_wall_us = profiled.wall_seconds * 1e6 / PROFILE_CHUNKS
    need(busy_us > 0, "breakdown: the profiler saw no device time")
    expected = f" (expected {DENSE_KERNELS})" if kind == "ogb" else ""
    print(f"breakdown {kind}, {PROFILE_CHUNKS} chunks: wall {wall_us:.1f} us/chunk "
          f"(profiled {prof_wall_us:.1f}), device busy {busy_us:.1f} us/chunk, "
          f"{launches:.1f} device kernels/chunk{expected}, device idle share "
          f"{1 - busy_us / wall_us:.3f} (profiled {1 - busy_us / prof_wall_us:.3f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / PROFILE_CHUNKS:8.2f} us/chunk "
              f"{e.count / PROFILE_CHUNKS:6.2f}/chunk  {e.key[:90]}")
    ours = {}
    for e in rows:
        name = next((k for k in PORT_KERNEL_NAMES if k in e.key), None)
        if name:
            us, per = e.self_device_time_total / PROFILE_CHUNKS, e.count / PROFILE_CHUNKS
            ours[name] = {"us_a_chunk": us, "launches_a_chunk": per}
            print(f"  port kernel {name}: {us:.2f} us/chunk, {per:.2f} launches/chunk")
    accumulate = [e.key for e in rows if "indexing_backward" in e.key]
    if kind == "ogb_tree":
        sorts = sum(e.self_device_time_total for e in rows if "RadixSort" in e.key)
        print(f"  PyTorch's accumulate: {len(accumulate)} rows; radix sorts "
              f"{sorts / PROFILE_CHUNKS:.2f} us/chunk")
        need(not accumulate, f"ogb_tree still runs PyTorch's accumulate: {accumulate}")
    return {"wall_us_a_chunk": wall_us, "busy_us_a_chunk": busy_us,
            "device_kernels_a_chunk": launches, "idle_share": 1 - busy_us / wall_us,
            "port_kernels": ours}


def tree_state(trace, eta, chunks=1000):
    """A real mid-run ogb_tree state: the carry after ``chunks`` chunks."""
    from repro_torch import policy_def, run

    res = run(policy_def("ogb_tree"), trace[: chunks * W], N, C, window=W, eta=eta,
              track_opt=False)
    return res.carry


def bucket_root(cnt, tot, cap, lo, hi):
    """The threshold in [lo, hi] where the bucket mass falls to cap, by
    float64 bisection over the same means."""
    import numpy as np

    c, t = cnt.double().cpu().numpy(), tot.double().cpu().numpy()
    mean = np.where(c > 0, t / np.maximum(c, 1.0), 0.0)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if (c * np.clip(mean - mid, 0.0, 1.0)).sum() >= cap else (lo, mid)
    return 0.5 * (lo + hi)


def check_tree_kernels(torch, dev, carry, eta):
    """Phase 3, prefix-tree kernels: segsum and bucket_mass against their
    plain versions on a real mid-run ogb_tree state, then timings."""
    from repro_torch.kernels.prefix_tree.kernel import (
        block_segment_sums,
        bucket_masses,
        solve_buckets,
    )
    from repro_torch.kernels.prefix_tree.ref import (
        bucket_masses_ref,
        segment_sums_ref,
        solve_buckets_ref,
        solve_rounds,
    )

    cnt, tot = carry.ycnt[:V], carry.ysum[:V]
    f = torch.clamp(carry.y - carry.rho, 0.0, 1.0)  # the fractional state of 1e6 items
    gen = torch.Generator().manual_seed(2)
    ints = torch.randint(0, 1000, (N,), generator=gen).to(torch.float32).to(dev)
    # integer-valued inputs: exact whatever the order of the sums
    for label, x, out in (("1e6 -> 15625, integers", ints, N // 64),
                          ("65536 -> 1024, bucket counts", cnt, V // 64)):
        got = block_segment_sums(x, out, 64)
        need(torch.equal(got, segment_sums_ref(x, out, 64)), f"segsum {label} differs")
        need(float(got.double().sum()) == float(x.double().sum()) > 0, f"segsum {label}: wrong total")
        print(f"segsum {label}: exact, total {float(got.double().sum())}")
    seg_errs = []
    for label, x, out in (("1e6 -> 15625, f", f, N // 64), ("65536 -> 1024, bucket sums", tot, V // 64)):
        got, want = block_segment_sums(x, out, 64), segment_sums_ref(x, out, 64)
        err = float((got.double() - want.double()).abs().max())
        rel = err / max(1.0, float(want.abs().max()))
        need(rel <= 1e-6 and float(got.abs().sum()) > 0, f"segsum {label}: |d| {err}")
        seg_errs.append(err)
        print(f"segsum {label}: max |kernel - plain| = {err:.3e} (relative {rel:.3e}, limit 1e-6)")

    total = float(cnt.double().sum())
    nz = cnt > 0
    means = (tot[nz] / cnt[nz]).double()
    taus = {63: torch.linspace(float(means.min()), float(means.max()), 63, device=dev),
            64: torch.linspace(float(carry.rho), float(carry.rho) + 1.0, 64, device=dev)}
    print(f"bucket histogram: {int(nz.sum())} of {V} buckets non-empty, {total} items, "
          f"means in [{float(means.min()):.6f}, {float(means.max()):.6f}], rho {float(carry.rho):.6f}")
    mass_errs = {}
    for k, tk in taus.items():
        got, want = bucket_masses(cnt, tot, tk), bucket_masses_ref(cnt, tot, tk)
        need(bool(got.max() > 0) and bool(got.min() < total), f"bucket_mass K={k}: vacuous check")
        need(bool(((got > 0) & (got < total)).any()), f"bucket_mass K={k}: no mass strictly inside")
        need(bool((got[1:] <= got[:-1]).all()), f"bucket_mass K={k}: not non-increasing in tau")
        err = float((got.double() - want.double()).abs().max())
        need(err <= 1e-6 * total, f"bucket_mass K={k}: |d| {err} > {1e-6 * total}")
        mass_errs[k] = err
        print(f"bucket_mass K={k}: masses {float(got.max()):.3f} .. {float(got.min()):.3f}, "
              f"max |kernel - plain| = {err:.3e} (limit {1e-6 * total:.3e})")

    # the whole solve as the chunk launches it, over a bracket of the chunk's
    # width on each side of this state's rho, so that the root is inside
    rho, half = float(carry.rho), max(eta * W, 4.0 * float(carry.w))
    lo, hi = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (rho - half, rho + half))
    solve = (cnt, tot, torch.tensor(float(C), device=dev), lo, hi, TREE_ITERS)
    got = solve_buckets(*solve)
    need(torch.equal(solve_buckets(*solve), got), "solve_buckets: two runs differ")
    want = solve_buckets_ref(*solve)
    earlier = earlier_solve(torch, *solve)
    earlier_lo = earlier()
    need(torch.equal(got, want), f"solve_buckets {float(got)!r} is not the plain version's "
         f"{float(want)!r}")
    solve_err = float((got - want).abs())
    root = bucket_root(cnt, tot, float(C), float(lo), float(hi))
    print(f"solve_buckets, {TREE_ITERS} halvings over [{float(lo):.6f}, {float(hi):.6f}]: "
          f"{float(got):.9e}, equal to the plain version bit for bit (earlier design "
          f"{float(earlier_lo):.9e}, float64 root {root:.9e}, |d| "
          f"{abs(float(got) - root):.3e}); two runs bit for bit")

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    t63 = taus[63]
    jobs = {
        "segsum": (lambda: block_segment_sums(f, N // 64, 64),
                   lambda: segment_sums_ref(f, N // 64, 64),
                   lambda: f.view(N // 64, 64).sum(1)),
        "bucket_mass": (lambda: solve_buckets(*solve), lambda: solve_buckets_ref(*solve), None),
    }
    # the whole solve's work follows the histogram: every count read once,
    # the sums of the non-empty buckets, three scalars read, the threshold
    # written; 2 + 5K ops a non-empty bucket a round of K = 2^h - 1 points
    # (an empty bucket adds an exact 0)
    nnz = int(nz.sum())
    ops_a_bucket = sum(2 + 5 * ((1 << h) - 1) for h in solve_rounds(TREE_ITERS))
    bounds = {
        # children read once, nodes written once; one add a child
        "segsum": bound_ms(4 * N + 4 * (N // 64), N),
        "bucket_mass": bound_ms(4 * V + 4 * nnz + 3 * 4 + 4, nnz * ops_a_bucket),
    }
    dense_b, dense_by = bound_ms(8 * V + 3 * 4 + 4, V * ops_a_bucket)
    print(f"solve_buckets bound: {nnz} non-empty buckets x {ops_a_bucket} ops; were every "
          f"bucket non-empty: {dense_b * 1e3:.3f} us by {dense_by}")
    errors = {"segsum": seg_errs[0], "bucket_mass": solve_err}
    rows = {}
    for name, (kern, plain, lib) in jobs.items():
        ms = timed_ms(torch, kern, 50, flush)
        warm = timed_ms(torch, kern, 50)
        plain_ms = timed_ms(torch, plain, 20, flush)
        lib_ms = timed_ms(torch, lib, 20, flush) if lib else None
        b, by = bounds[name]
        rows[name] = {"ms": ms, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b,
                      "bound_by": by, "library_ms": lib_ms, "max_abs_err": errors[name]}
        lib_s = f", library {lib_ms * 1e3:.2f} us" if lib else ""
        print(f"{name}: cold {ms * 1e3:.2f} us, warm in L2 {warm * 1e3:.2f} us "
              f"(plain {plain_ms * 1e3:.2f} us{lib_s}, bound {b * 1e3:.3f} us by {by})")
    # the earlier design of the same solve: a K-way bucket_masses launch and
    # PyTorch's bracket ops a round
    rounds = len(solve_rounds(TREE_ITERS))
    earlier_ms, earlier_warm = time_both(
        torch, f"earlier design: {rounds} x bucket_masses + bracket ops", earlier, flush,
        hold=10 * HOLD_CYCLES)
    kway, kway_warm = time_both(torch, "bucket_masses K=63 (one K-way pass)",
                                lambda: bucket_masses(cnt, tot, t63), flush)
    rows["bucket_mass"].update({
        "earlier_design": f"{rounds} x K-way bucket_masses + bracket ops",
        "earlier_ms": earlier_ms, "earlier_warm_ms": earlier_warm,
        "kway_k63_ms": kway, "kway_k63_warm_ms": kway_warm,
        "kway_k63_max_abs_err": mass_errs[63]})
    small = timed_ms(torch, lambda: block_segment_sums(cnt, V // 64, 64), 50, flush)
    b_small, _ = bound_ms(4 * V + 4 * (V // 64), V)
    t64 = taus[64]
    m64 = timed_ms(torch, lambda: bucket_masses(cnt, tot, t64), 50, flush)
    print(f"segsum 65536 -> 1024: cold {small * 1e3:.2f} us (bound {b_small * 1e3:.3f} us); "
          f"bucket_mass K=64: cold {m64 * 1e3:.2f} us")
    return rows


def per_level_build(torch, leaves, radix=64):
    """The whole tree as the design it replaced built it: one
    block_segment_sums launch a level, then a concatenation."""
    from repro_torch.kernels.prefix_tree.kernel import block_segment_sums
    from repro_torch.kernels.prefix_tree.ops import tree_sizes

    parts, cur = [leaves], leaves
    for size in tree_sizes(leaves.numel(), radix)[1:]:
        cur = block_segment_sums(cur, size, radix)
        parts.append(cur)
    return torch.cat(parts)


def record_chunk_updates(trace, carry, chunk=1000):
    """The three tree updates of one real ogb_tree chunk, the one after
    ``carry``'s: {tree: (tree before, n, radix, idx, delta)}."""
    from repro_torch import policy_def, run
    from repro_torch.cachesim import tree_engines

    calls, real = [], tree_engines.tree_update_

    def record(tree, n, radix, idx, delta):
        calls.append((tree.clone(), n, radix, idx.clone(), delta.clone()))
        return real(tree, n, radix, idx, delta)

    tree_engines.tree_update_ = record
    try:
        run(policy_def("ogb_tree"), trace[chunk * W:(chunk + 1) * W], capacity=C, window=W,
            carry=carry, track_opt=False)
    finally:
        tree_engines.tree_update_ = real
    need(len(calls) == 3, f"an ogb_tree chunk made {len(calls)} tree updates, not 3")
    return dict(zip(("ycnt", "ysum", "dcnt"), calls))


def update_work(torch, n, radix, idx):
    """What one update's data asks of the card: the deltas that add (idx >=
    0), the nodes they touch, and the longest run of deltas under one node,
    the chain of dependent float64 adds that no order but the input's may
    shorten."""
    from repro_torch.kernels.prefix_tree.ops import tree_offsets

    node = idx[idx >= 0].long()
    adds, touched, longest = int(node.numel()) * len(tree_offsets(n, radix)), 0, 0
    for _ in tree_offsets(n, radix):
        _, counts = torch.unique(node, return_counts=True)
        touched += int(counts.numel())
        longest = max(longest, int(counts.max()) if counts.numel() else 0)
        node = node // radix
    return {"deltas": int(idx.numel()), "adding": int((idx >= 0).sum()), "float64_adds": adds,
            "touched_nodes": touched, "longest_run": longest}


def check_tree_sums(torch, dev, carry, trace, one_level):
    """Phase 3, the tree's two sums: the whole-tree build and the batched
    tree update, against their plain versions (and the build against the
    per-level design it replaced, bit for bit), then timings.  The update at
    a real chunk's three calls and at a run of 2000 deltas under one node.
    ``one_level`` is the one-level segsum kernel's row, kept in the build's."""
    from repro_torch.kernels.prefix_tree.ops import (
        tree_build,
        tree_offsets,
        tree_storage,
        tree_update_,
        update_order,
    )
    from repro_torch.kernels.prefix_tree.ref import tree_build_ref, tree_update_ref

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    gen = torch.Generator().manual_seed(6)
    ints = torch.randint(0, 16, (N,), generator=gen).to(torch.float32).to(dev)  # sums < 2^24
    f = torch.clamp(carry.y - carry.rho, 0.0, 1.0)
    cnt, tot = carry.ycnt[:V], carry.ysum[:V]
    builds = {}
    for label, x, exact in (("1e6 leaves, integers", ints, True), ("1e6 leaves, f", f, False),
                            ("65536 buckets, counts", cnt, True),
                            ("65536 buckets, sums", tot, False)):
        got, want = tree_build(x, 64), tree_build_ref(x, 64)
        err = float((got.double() - want.double()).abs().max())
        rel = err / max(1.0, float(want.abs().max()))
        need(torch.equal(got, want) if exact else rel <= 1e-6,
             f"tree_build {label}: |kernel - plain| {err}")
        need(torch.equal(got, per_level_build(torch, x)),
             f"tree_build {label}: not the per-level design's tree bit for bit")
        need(torch.equal(tree_build(x, 64), got), f"tree_build {label}: two runs differ")
        need(float(got.abs().sum()) > 0, f"tree_build {label}: an empty tree, a vacuous check")
        kernels = device_kernels(torch, lambda x=x: tree_build(x, 64))
        need(kernels == 1, f"tree_build {label}: {kernels} device kernels a call, not 1")
        builds[label] = err
        held = "exact" if exact else f"max |kernel - plain| {err:.3e} (relative {rel:.3e}, limit 1e-6)"
        print(f"tree_build {label}: {held}, the per-level design's tree bit for bit, 1 device "
              f"kernel a call, {tree_storage(x.numel(), 64)} nodes")
    rows = {}
    for key, x in (("segsum", f), ("buckets", tot)):
        n = x.numel()
        ms, warm = time_both(torch, f"tree_build over {n} leaves", lambda x=x: tree_build(x, 64),
                             flush)
        plain = timed_ms(torch, lambda x=x: tree_build_ref(x, 64), 20, flush)
        lv, lv_warm = time_both(torch, f"per-level design over {n} leaves",
                                lambda x=x: per_level_build(torch, x), flush)
        storage = tree_storage(n, 64)
        # the leaves read once, the tree written once; one add a node below the top
        b, by = bound_ms(4 * n + 4 * storage, storage - 4)
        print(f"tree_build {n} leaves: cold {ms * 1e3:.2f} us, warm {warm * 1e3:.2f} us (plain "
              f"{plain * 1e3:.2f} us, per-level design {lv * 1e3:.2f} / {lv_warm * 1e3:.2f} us, "
              f"bound {b * 1e3:.3f} us by {by})")
        rows[key] = {"leaves": n, "ms": ms, "warm_ms": warm, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by, "library_ms": None,
                     "max_abs_err": builds["1e6 leaves, f" if n == N else "65536 buckets, sums"],
                     "per_level_ms": lv, "per_level_warm_ms": lv_warm}
    segsum = {**rows["segsum"], "buckets": rows["buckets"],
              "one_level": {**one_level, "design": "one level a launch (block_segment_sums)"}}

    calls = record_chunk_updates(trace, carry)
    tree, n, radix, idx, delta = calls["ysum"]
    one = torch.full_like(idx, int(idx[idx >= 0][0]))  # every delta under one leaf
    calls["one node"] = (tree, n, radix, one, delta)
    # deltas over twelve decades, which the card adds in input order
    wide = torch.randn(idx.numel(), generator=gen) * 10.0 ** (
        torch.rand(idx.numel(), generator=gen) * 12 - 8)
    calls["one node, wide deltas"] = (tree, n, radix, one, wide.to(dev))
    updates = {}
    for label, (tree, n, radix, idx, delta) in calls.items():
        got = tree_update_(tree.clone(), n, radix, idx, delta)
        need(torch.equal(got, tree_update_ref(tree.clone(), n, radix, idx, delta)),
             f"tree_update {label} differs from its plain version on the card")
        cpu = tree_update_ref(tree.to("cpu", copy=True), n, radix, idx.cpu(), delta.cpu())
        need(torch.equal(got.cpu(), cpu), f"tree_update {label} differs from the CPU's")
        need(torch.equal(tree_update_(tree.clone(), n, radix, idx, delta), got),
             f"tree_update {label}: two runs differ")
        work = tree.clone()
        kernels = device_kernels(torch, lambda: tree_update_(work, n, radix, idx, delta))
        need(kernels == 1, f"tree_update {label}: {kernels} device kernels a call, not 1")
        stats = {**update_work(torch, n, radix, idx), "order": update_order(n, idx, delta)}
        need(stats["adding"] > 0, f"tree_update {label}: no delta adds, a vacuous check")
        ms, warm = time_both(torch, f"tree_update {label}",
                             lambda: tree_update_(work, n, radix, idx, delta), flush)
        plain_work = tree.clone()
        plain = timed_ms(torch, lambda: tree_update_ref(plain_work, n, radix, idx, delta), 20,
                         flush)
        # the library call: PyTorch's float64 accumulate over the (node, delta)
        # pairs the plain version forms, timed alone
        ok, levels = idx >= 0, tree_offsets(n, radix)
        node, nodes = torch.where(ok, idx, torch.zeros_like(idx)).long(), []
        for off in levels:
            nodes.append(off + node)
            node = node // radix
        nodes = torch.cat(nodes)
        vals = torch.where(ok, delta, torch.zeros_like(delta)).double().repeat(len(levels))
        acc = torch.zeros(tree.numel(), dtype=torch.float64, device=dev)
        lib = timed_ms(torch, lambda: acc.index_put_((nodes,), vals, accumulate=True), 20, flush)
        n_bytes = (idx.element_size() + 4) * idx.numel() + 8 * stats["touched_nodes"]
        b, by = bound_ms(n_bytes, stats["float64_adds"], FP64_OPS_PER_S)
        print(f"tree_update {label}: bit for bit the plain version on the card and on the CPU, "
              f"1 device kernel a call; {stats}; cold {ms * 1e3:.2f} us, warm {warm * 1e3:.2f} us "
              f"(plain {plain * 1e3:.2f} us, index_put_(accumulate=True) alone {lib * 1e3:.2f} "
              f"us, bound {b * 1e3:.4f} us by {by}; its longest run, {stats['longest_run']} "
              f"deltas, is as many dependent float64 adds in input order)")
        updates[label] = {"ms": ms, "warm_ms": warm, "plain_ms": plain, "bound_ms": b,
                          "bound_by": by, "library_ms": lib, "max_abs_err": 0.0, **stats}
    del flush_buf
    row = {**updates["ysum"], "tree": "ysum, a real chunk's",
           "calls": {k: v for k, v in updates.items() if k != "ysum"}}
    return {"segsum": segsum, "tree_update": row}


def check_tree_main_path(trace, eta):
    """Phase 8: the lazy main path, every launch and host read counted."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.prefix_tree.ops import WHOLE_TREE

    pd = policy_def("ogb_tree")
    reset_launch_counts()
    res = run(pd, trace, N, C, window=W)
    launches = launch_counts()
    designs = design_counts()
    m = T // W
    reanchors, syncs = int(res.extras["reanchors"]), int(res.extras["host_syncs"])
    # the three trees are built at init and rebuilt at each re-anchor, one
    # launch each, from leaves whose counts come from the histogram kernel
    # (two id-slices launches); a chunk updates the three trees and counts
    # its requests by lead lane (one bin-tiles histogram)
    want = {"histogram": m + 2 * reanchors, "mass": 0, "apply": 0,
            "segsum": 3 * (1 + reanchors), "tree_update": 3 * m, "bucket_mass": m,
            **OFF_PATH}
    print(f"ogb_tree main path: hit_ratio {res.hit_ratio}, frac_hit_ratio {res.frac_hit_ratio} "
          f"(reference {REF_TREE_FRAC_HIT_RATIO}), regret {res.regret}, us_per_request "
          f"{res.us_per_request}, wall {res.wall_seconds} s, final rho {float(res.carry.rho)}, "
          f"mean occupancy {float(np.mean(res.occupancy))}, re-anchors {reanchors}, host syncs "
          f"{syncs}, launches {launches}")
    print(f"ogb_tree: {res.us_per_request} us a request at T={T} (at e3b81f4: "
          f"{EARLIER_US_PER_REQUEST['ogb_tree']}); launches by design: bucket_mass "
          f"{designs['bucket_mass']}, segsum {designs['segsum']}, histogram "
          f"{designs['histogram']}")
    need(res.extras["eta"] == eta, "ogb_tree main path resolved another eta")
    need(launches == want, f"ogb_tree launches {launches}, expected {want}")
    want_hist = {"bin tiles": m, **({"id slices": 2 * reanchors} if reanchors else {})}
    need(designs["histogram"] == want_hist, f"ogb_tree histogram designs {designs['histogram']}")
    need(designs["segsum"] == {WHOLE_TREE: 3 * (1 + reanchors)},
         f"ogb_tree segsum designs {designs['segsum']}")
    need(np.all(np.isfinite(res.reward)) and np.all(np.isfinite(res.aux)), "non-finite output")
    need(abs(res.frac_hit_ratio - REF_TREE_FRAC_HIT_RATIO) <= 1e-4,
         f"ogb_tree fractional hit ratio {res.frac_hit_ratio} is not the reference's")
    need(0.0 < res.hit_ratio < 1.0, f"ogb_tree hit ratio {res.hit_ratio} out of range")
    need(abs(float(np.mean(res.occupancy)) - C) < 0.2 * C, "ogb_tree occupancy far from C")
    need(syncs <= m // 20, f"ogb_tree read the device in {syncs} of {m} chunks")
    return launches, designs


def _close_to_cpu(card, cpu, label):
    """Card against CPU: hits within 1 per 10 000 requests, |d rho| <= 1e-5
    in every chunk (rho_t = the sum of the steps since the last re-anchor)."""
    import numpy as np

    dtau = float(np.abs(card.aux - cpu.aux).max())
    dhits = abs(int(card.hits.sum()) - int(cpu.hits.sum()))
    print(f"{label}: max |d dtau| {dtau:.3e}, hits {int(card.hits.sum())} vs "
          f"{int(cpu.hits.sum())}, re-anchors {card.extras.get('reanchors')} vs "
          f"{cpu.extras.get('reanchors')}")
    need(card.extras.get("reanchors") == cpu.extras.get("reanchors"), f"{label}: re-anchors differ")
    need(dtau <= 1e-5, f"{label}: dtau differs by {dtau}")
    need(dhits <= card.T // 10_000, f"{label}: hits differ by {dhits}")
    return dtau


def check_tree_card_against_cpu(trace, eta):
    """Phase 9a: 200 ogb_tree chunks through the kernels and the plain versions."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb_tree")
    part = trace[: CPU_CHUNKS * W]
    card = run(pd, part, N, C, window=W, eta=eta)
    cpu = run(pd, part, N, C, window=W, eta=eta, device="cpu")
    _close_to_cpu(card, cpu, f"ogb_tree card vs CPU, {CPU_CHUNKS} chunks")
    need(card.extras["reanchors"] == 0, "a re-anchor fired: rho is not a plain sum of steps")
    drho = float(np.abs(np.cumsum(card.aux) - np.cumsum(cpu.aux)).max())
    print(f"ogb_tree card vs CPU: max |d rho| over the chunks {drho:.3e}")
    need(drho <= 1e-5, f"ogb_tree card and CPU rho differ by {drho}")


def _same_runs(torch, a, b, label):
    import numpy as np

    for name in ("reward", "hits", "aux", "occupancy"):
        need(np.array_equal(getattr(a, name), getattr(b, name)), f"{label}: {name} differs")
    need(all(torch.equal(x, y) for x, y in zip(a.carry.tensors(), b.carry.tensors())),
         f"{label}: carry differs")


def check_tree_repeat_and_resume(torch, trace, eta):
    """Phase 9b: two ogb_tree runs on the card, and a resumed one, bit for bit."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb_tree")
    part = trace[: RESUME_CHUNKS * W]
    half = len(part) // 2
    whole = run(pd, part, N, C, window=W, eta=eta)
    again = run(pd, part, N, C, window=W, eta=eta)
    _same_runs(torch, whole, again, "ogb_tree two runs")
    first = run(pd, part[:half], N, C, window=W, eta=eta)
    second = run(pd, part[half:], capacity=C, window=W, carry=first.carry)
    for name in ("reward", "hits", "aux", "occupancy"):
        cat = np.concatenate([getattr(first, name), getattr(second, name)])
        need(np.array_equal(cat, getattr(whole, name)), f"ogb_tree resume: {name} differs")
    need(all(torch.equal(x, y) for x, y in zip(second.carry.tensors(), whole.carry.tensors())),
         "ogb_tree resume: carry differs")
    print(f"ogb_tree: two runs of {RESUME_CHUNKS} chunks equal, and two calls equal one, "
          f"bit for bit (host syncs {whole.extras['host_syncs']:.0f}, re-anchors "
          f"{whole.extras['reanchors']:.0f})")


def check_reanchor(torch, trace, eta):
    """Phase 9c: batch_hint=1 sizes the value grid for one request a chunk,
    so at this eta every chunk of 1000 re-anchors.  Returns the histogram's
    launches by design."""
    from repro_torch import policy_def, run
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts

    pd = policy_def("ogb_tree", batch_hint=1)
    part = trace[: REANCHOR_CHUNKS * W]
    reset_launch_counts()
    t0 = time.perf_counter()
    one = run(pd, part, N, C, window=W, eta=eta)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hist_designs = design_counts()["histogram"]
    two = run(pd, part, N, C, window=W, eta=eta)
    n_re = int(one.extras["reanchors"])
    print(f"forced re-anchor, {REANCHOR_CHUNKS} chunks: re-anchors {n_re}, host syncs "
          f"{one.extras['host_syncs']:.0f}, {wall * 1e3 / REANCHOR_CHUNKS:.2f} ms a chunk, "
          f"launches {launches}, histogram launches by design {hist_designs}")
    need(hist_designs == {"bin tiles": REANCHOR_CHUNKS, "id slices": 2 * n_re},
         f"forced re-anchor histogram designs {hist_designs}")
    need(n_re == REANCHOR_CHUNKS, f"forced re-anchor fired {n_re} times")
    want = {"histogram": REANCHOR_CHUNKS + 2 * n_re, "mass": 0, "apply": 0,
            "segsum": 3 * (1 + n_re), "tree_update": 3 * REANCHOR_CHUNKS,
            "bucket_mass": REANCHOR_CHUNKS, **OFF_PATH}
    need(launches == want, f"forced re-anchor launches {launches}, expected {want}")
    _same_runs(torch, one, two, "forced re-anchor two runs")
    short = part[: REANCHOR_CPU_CHUNKS * W]
    card = run(pd, short, N, C, window=W, eta=eta)
    cpu = run(pd, short, N, C, window=W, eta=eta, device="cpu")
    _close_to_cpu(card, cpu, f"forced re-anchor card vs CPU, {REANCHOR_CPU_CHUNKS} chunks")
    return hist_designs


def check_madow(trace, eta):
    """Phase 10: Madow sampling on the dense path, occupancy exactly C."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.kernels import launch_counts, reset_launch_counts

    segsum = None
    for sample in ("madow", "madow_tree"):
        pd = policy_def("ogb", sample=sample, madow_capacity=C)
        reset_launch_counts()
        res = run(pd, trace[: MADOW_CHUNKS * W], N, C, window=W, eta=eta)
        launches = launch_counts()
        print(f"{sample}, {MADOW_CHUNKS} chunks: hit_ratio {res.hit_ratio}, frac_hit_ratio "
              f"{res.frac_hit_ratio}, us_per_request {res.us_per_request}, occupancy "
              f"{res.occupancy.min()} .. {res.occupancy.max()}, launches {launches}")
        need(np.all(res.occupancy == C), f"{sample}: occupancy is not C in every chunk")
        want_seg = MADOW_CHUNKS if sample == "madow_tree" else 0  # one tree build a chunk
        need(launches["segsum"] == want_seg, f"{sample}: segsum launched {launches['segsum']}")
        need(launches["tree_update"] == 0, f"{sample}: tree_update launched")
        part = trace[: MADOW_CPU_CHUNKS * W]
        card = run(pd, part, N, C, window=W, eta=eta)
        cpu = run(pd, part, N, C, window=W, eta=eta, device="cpu")
        d = abs(card.hit_ratio - cpu.hit_ratio)
        print(f"{sample} card vs CPU, {MADOW_CPU_CHUNKS} chunks: hit ratio {card.hit_ratio} vs "
              f"{cpu.hit_ratio} (|d| {d:.3e}, limit 2e-3)")
        need(d <= 2e-3 and np.all(cpu.occupancy == C), f"{sample}: card and CPU differ")
        if sample == "madow_tree":
            segsum = launches["segsum"]
    return segsum




def _held(torch, label, got, again, want, dtype):
    """Kernel against plain: float32 within 2e-5 (the JAX package's kernel
    tests' tolerance); bf16 within one ulp of the largest output (2^-7 of it:
    both round a float32 result once).  Not empty, not all zero, two runs
    bit for bit."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7 * top
    print(f"{label}: max |kernel - plain| = {err:.3e} (limit {tol:.3e}), max |out| {top:.4f}")
    need(got.numel() > 0 and bool(torch.isfinite(got).all()), f"{label}: empty or non-finite")
    need(float(got.float().abs().max()) > 0, f"{label}: all zero")
    need(err <= tol, f"{label}: |kernel - plain| = {err} > {tol}")
    need(torch.equal(got, again), f"{label}: two runs differ")
    return err


def check_attention_kernels(torch, dev):
    """Phase 12: both attention kernels against their plain versions."""
    from repro_torch.kernels.decode_attention.kernel import design as decode_design
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_prefill.kernel import design as prefill_design
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for arch, B, H, Hkv, D, S in (("glm4-9b", 8, 32, 2, 128, 32768),
                                      ("glm4-9b", 8, 32, 2, 128, SERVE_S + SERVE_NEW),
                                      ("qwen3-14b", 8, 40, 8, 128, 8192),
                                      ("gemma-7b", 8, 16, 16, 256, 8192),
                                      ("phi-3-vision D=96", 8, 32, 32, 96, 8192),
                                      ("q-group 32", 8, 64, 2, 128, 8192)):
            q, k, v = randn(B, H, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype), \
                randn(B, S, Hkv, D, dtype=dtype)
            if S == SERVE_S + SERVE_NEW:  # the served cache: lengths SERVE_S + 1 .. S
                lengths = torch.arange(SERVE_S + 1, SERVE_S + 1 + B, device=dev,
                                       dtype=torch.int32).clamp(max=S)
                lengths[-1] = S
            else:
                lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                                        dtype=torch.int32)
                lengths[:3] = torch.tensor([1, S, 4001], dtype=torch.int32)  # 4001 = 62 * 64 + 33
            label = (f"decode {arch} {kind} B={B} H={H} Hkv={Hkv} D={D} S={S} "
                     f"[{decode_design(dtype, D)}]")
            errs[("decode", arch, kind, S)] = _held(
                torch, label, decode_attention(q, k, v, lengths), decode_attention(q, k, v, lengths),
                decode_attention_ref(q, k, v, lengths), dtype)
        for arch, B, S, H, Hkv, D in (("glm4-9b", 1, 4096, 32, 2, 128),
                                      ("glm4-9b", 1, 4000, 32, 2, 128),
                                      ("glm4-9b", SERVE_B, SERVE_S, 32, 2, 128),
                                      ("gemma-7b", 1, 2048, 16, 16, 256),
                                      ("D=192", 1, 2048, 16, 2, 192)):
            q = randn(B, S, H, D, dtype=dtype)
            k, v = randn(B, S, Hkv, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype)
            label = (f"prefill {arch} {kind} B={B} S={S} H={H} Hkv={Hkv} D={D} "
                     f"[{prefill_design(dtype, D)}]")
            errs[("prefill", arch, kind, S)] = _held(
                torch, label, flash_prefill(q, k, v), flash_prefill(q, k, v),
                flash_prefill_ref(q, k, v), dtype)
        torch.cuda.empty_cache()
    return {"decode_attention": errs[("decode", "glm4-9b", "bf16", 32768)],
            "flash_prefill": errs[("prefill", "glm4-9b", "bf16", 4096)]}


def time_attention_kernels(torch, dev, errs):
    """Phase 13: each attention kernel in bf16, cold and warm in L2, beside
    its plain version, one scaled_dot_product_attention call (timed as a
    yardstick only: the port never calls it) and its bound, at glm4-9b's
    long shapes and at the shapes the served model launches it."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import design as decode_design
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_prefill.kernel import design as prefill_design
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    H, Hkv, D = 32, 2, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def decode_job(B, S, lengths):
        q, k, v = randn(B, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        qd, kd, vd = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, enable_gqa=True)[:, :, 0]
        print(f"decode B={B} S={S}: max |kernel - scaled_dot_product_attention| = "
              f"{float((decode_attention(q, k, v, lengths).float() - lib.float()).abs().max()):.3e}")
        # K and V of every valid position read once, q read and out written once;
        # 4 operations per (query head, position, dim): the two dot products
        valid = int(lengths.sum())
        n_bytes = 2 * 2 * valid * Hkv * D + 2 * 2 * B * H * D + 4 * B
        return (lambda: decode_attention(q, k, v, lengths),
                lambda: decode_attention_ref(q, k, v, lengths),
                lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, enable_gqa=True),
                bound_ms(n_bytes, 4 * valid * H * D, BF16_OPS_PER_S))

    def prefill_job(B, S):
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        print(f"prefill B={B} S={S}: max |kernel - scaled_dot_product_attention| = "
              f"{float((flash_prefill(q, k, v).float() - lib.transpose(1, 2).float()).abs().max()):.3e}")
        # 4 B H (S^2 / 2) D operations over the bf16 tensor-core peak
        n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        return (lambda: flash_prefill(q, k, v),
                lambda: flash_prefill_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                bound_ms(n_bytes, 4 * B * H * (S * S / 2) * D, BF16_OPS_PER_S))

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    def measure(name, label, job, plain_reps):
        kern, plain, lib_fn, (b, by) = job
        ms = timed_ms(torch, kern, 20, flush)
        warm = timed_ms(torch, kern, 20)
        plain_ms = timed_ms(torch, plain, plain_reps, flush)
        lib_ms = timed_ms(torch, lib_fn, 20, flush)
        print(f"{name} {label}: cold {ms * 1e3:.2f} us, warm in L2 {warm * 1e3:.2f} us (plain "
              f"{plain_ms * 1e3:.2f} us, scaled_dot_product_attention {lib_ms * 1e3:.2f} us, "
              f"bound {b * 1e3:.3f} us by {by}; kernel / library {ms / lib_ms:.2f})")
        return {"ms": ms, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": lib_ms}

    rows = {}
    S = 32768  # decode_32k's cache length, every sequence full
    full = torch.full((8,), S, dtype=torch.int32, device=dev)
    rows["decode_attention"] = {
        **measure("decode_attention", f"B=8 S={S}", decode_job(8, S, full), 5),
        "max_abs_err": errs["decode_attention"], "design": decode_design(bf, D)}
    torch.cuda.empty_cache()
    rows["flash_prefill"] = {
        **measure("flash_prefill", "B=1 S=4096", prefill_job(1, 4096), 5),
        "max_abs_err": errs["flash_prefill"], "design": prefill_design(bf, D)}
    torch.cuda.empty_cache()
    # the served model's shapes: a prefill of SERVE_B prompts of SERVE_S tokens,
    # and a decode step over the SERVE_S + SERVE_NEW cache, lengths SERVE_S + 1 ..
    S = SERVE_S + SERVE_NEW
    served = torch.arange(SERVE_S + 1, SERVE_S + 1 + SERVE_B, device=dev,
                          dtype=torch.int32).clamp(max=S)
    rows["decode_attention"]["serving"] = {
        "shape": f"B={SERVE_B} S={S} lengths {int(served.min())}..{int(served.max())}",
        **measure("decode_attention", f"serving B={SERVE_B} S={S}",
                  decode_job(SERVE_B, S, served), 10)}
    torch.cuda.empty_cache()
    rows["flash_prefill"]["serving"] = {
        "shape": f"B={SERVE_B} S={SERVE_S}",
        **measure("flash_prefill", f"serving B={SERVE_B} S={SERVE_S}",
                  prefill_job(SERVE_B, SERVE_S), 3)}
    sweep_decode_splits(torch, dev, flush)
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def sweep_decode_splits(torch, dev, flush):
    """Phase 13, last: the bf16 decode design (split and combine passes) at
    split lengths around split_plan's (marked), cold, at serving's cache and
    at S = 32 768: the measurement behind the plan.  Launched through the C
    entry point, beside the wrapper: no launch is counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    B, H, Hkv, D = SERVE_B, 32, 2, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = dk.decode_plan(D)["smem_bytes"]
    for S, first, tiles in ((SERVE_S + SERVE_NEW, SERVE_S + 1, (1, 3, 5)),
                            (32768, 32768, (16, 32, 64))):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.arange(first, first + B, device=dev, dtype=torch.int32).clamp(max=S)
        want = decode_attention_ref(q, k, v, lengths)
        plan_len = dk.mma_grid_plan(B, H, Hkv, S, D, sms)[1]
        for t in tiles:
            split_len = dk.TILE * t
            n_splits = -(-S // split_len)
            part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=dev)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=dev)
            out = torch.empty_like(q)

            def call():
                _build.check(dk._entry_mma()(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), B, H, Hkv, D, S,
                    n_splits, split_len, 1.0 / math.sqrt(D), smem, part_m.data_ptr(),
                    part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), "decode split sweep")

            call()
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            need(err <= 2.0 ** -7 * float(want.float().abs().max()),
                 f"decode split sweep S={S}, {t} tiles a split: |kernel - plain| = {err}")
            ms = timed_ms(torch, call, 20, flush)
            mark = " [split_plan]" if split_len == plan_len else ""
            print(f"decode split sweep S={S} lengths {first}..{int(lengths.max())}: {t} tiles a "
                  f"split, {n_splits} splits, {B * Hkv * n_splits} blocks{mark}: cold "
                  f"{ms * 1e3:.2f} us (both passes), max |kernel - plain| {err:.3e}")
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_full_width(torch, dev):
    """Phase 14: glm4-9b at full width behind an OGB page pool, 4 generate
    calls, every attention launch counted."""
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool

    cfg = get_arch(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads} / KV "
          f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params} parameters (ArchConfig.param_count {cfg.param_count()} + norms) drawn in "
          f"bf16 on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    need(n_params == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
         "the served model is not glm4-9b's full width")
    pages = SERVE_S // PAGE_SIZE
    policy = make_policy("ogb", 1 << 18, POOL_PAGES, horizon=SERVE_CALLS * SERVE_B * pages,
                         batch_size=SERVE_B * pages)
    pool = PagedKVPool(policy, page_size=PAGE_SIZE)
    engine = ServeEngine(cfg, params, pool=pool, max_len=SERVE_S + SERVE_NEW, device=dev)
    print(f"page pool: OGB over 2^18 page ids, {POOL_PAGES} pages of {PAGE_SIZE} tokens, "
          f"eta {policy.eta:.6f}, horizon {SERVE_CALLS * SERVE_B * pages} page touches, "
          f"batch {SERVE_B * pages}")
    rng = np.random.default_rng(0)
    hot = [rng.integers(1, cfg.vocab_size, SERVE_S) for _ in range(HOT_PROMPTS)]
    reset_launch_counts()
    batches, outs, steady = [], [], []
    for step in range(SERVE_CALLS):
        prompts = np.stack([hot[(step + b) % HOT_PROMPTS] if b < SERVE_B // 2
                            else rng.integers(1, cfg.vocab_size, SERVE_S)
                            for b in range(SERVE_B)]).astype(np.int32)
        wp, wd = engine.stats.wall_prefill, engine.stats.wall_decode
        out = engine.generate(prompts, SERVE_NEW)
        wp, wd = engine.stats.wall_prefill - wp, engine.stats.wall_decode - wd
        print(f"generate {step + 1}: prefill {wp:.4f} s ({SERVE_B * SERVE_S / wp:.1f} tokens/s), "
              f"decode {wd * 1e3 / SERVE_NEW:.3f} ms a step ({SERVE_B * SERVE_NEW / wd:.2f} "
              f"tokens/s), prefix reuse {engine.stats.prefix_reuse:.6f}, page hit ratio "
              f"{pool.stats.page_hit_ratio:.6f}, occupancy {pool.occupancy():.1f}")
        need(out.shape == (SERVE_B, SERVE_NEW) and out.min() >= 0 and out.max() < cfg.vocab_size,
             f"generate {step + 1}: tokens out of range or of the wrong shape")
        batches.append(prompts)
        outs.append(out)
        if step:
            steady.append((wp, wd))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {name: 0 for name in launches}
    want["flash_prefill"] = cfg.n_layers * SERVE_CALLS
    want["decode_attention"] = cfg.n_layers * SERVE_NEW * SERVE_CALLS
    wp = sum(w for w, _ in steady) / len(steady)
    wd = sum(w for _, w in steady) / len(steady)
    print(f"serving, calls 2-{SERVE_CALLS}: prefill {SERVE_B * SERVE_S / wp:.1f} tokens/s, "
          f"decode {wd * 1e3 / SERVE_NEW:.3f} ms a step, {SERVE_B * SERVE_NEW / wd:.2f} tokens/s; "
          f"peak memory {peak / 1e9:.3f} GB (max_memory_allocated); prefix reuse "
          f"{engine.stats.prefix_reuse:.6f}, page hit ratio {pool.stats.page_hit_ratio:.6f}, "
          f"pool stats {pool.stats}; launches {launches} (a decode_attention launch is its "
          f"split pass and its combine pass together)")
    need(launches == want, f"serving launches {launches}, expected {want}")
    need(engine.stats.prefix_reuse > 0 and pool.stats.page_hit_ratio > 0,
         "the page pool reused nothing by the last call")
    return engine, batches[0], outs[0], launches


def serve_breakdown(torch, engine, prompts, steps=4):
    """Phase 14b: where a prefill and a decode step of the served model go,
    from torch.profiler: device busy time, device kernels, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import decode_step, prefill

    cfg, params, dev = engine.cfg, engine.params, engine.device
    tokens = torch.from_numpy(prompts).to(dev)
    for label in ("prefill", "decode"):
        logits, cache = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
        torch.cuda.synchronize()
        n = 1 if label == "prefill" else steps
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if label == "prefill":
                    prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
                else:
                    logits, cache = decode_step(cfg, params, cache, tok, dev)
                    tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in rows) / n / 1e3
        kernels = sum(e.count for e in rows) / n
        need(busy_ms > 0, f"serving breakdown: the profiler saw no device time in {label}")
        print(f"breakdown {label}: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
              f"{kernels:.1f} device kernels, device idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / n / 1e3:9.3f} ms {e.count / n:7.1f}x "
                  f"{e.self_device_time_total / e.count:9.2f} us a launch  {e.key[:80]}")


class plain_attention:
    """Within this block the served model runs the plain PyTorch versions on
    the card (or ``prefill`` in place of the plain prefill version): the
    attention module's two kernel wrappers are swapped for them, and put
    back on leaving."""

    def __init__(self, prefill=None):
        self.prefill = prefill

    def __enter__(self):
        from repro_torch.kernels.decode_attention.ref import decode_attention_ref
        from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
        from repro_torch.models import attention

        self.saved = attention.flash_prefill, attention.decode_attention
        attention.flash_prefill = self.prefill or flash_prefill_ref
        attention.decode_attention = decode_attention_ref

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_prefill, attention.decode_attention = self.saved


def _prefill_f64(q, k, v):
    """Causal GQA attention in float64, one sequence at a time: what the
    float32 plain version approximates, for a yardstick of how far the served
    model's logits move when attention is rounded differently."""
    import torch

    B, S, H, D = q.shape
    g = H // k.shape[2]
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    out = torch.empty_like(q)
    for b in range(B):
        kf = k[b].double().repeat_interleave(g, dim=1)
        vf = v[b].double().repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kf) / math.sqrt(D)
        s.masked_fill_(future, -1e30)
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), vf).to(q.dtype)
    return out


def bf16_ulp(x):
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check_served_against_plain(torch, engine, prompts, first_out):
    """Phase 15: the served model through the kernels against the plain
    versions on the card, and two generate calls on equal prompts."""
    import numpy as np

    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import decode_step, prefill

    cfg, params, dev, V = engine.cfg, engine.params, engine.device, engine.cfg.vocab_size
    tokens = torch.from_numpy(prompts).to(dev)
    lk, ck = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    before = launch_counts()
    with plain_attention():
        lp, cp = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    need(launch_counts() == before, "the plain run launched a kernel")

    def compare(label, a, b):
        """Logits within 8 bf16 ulps of the largest |logit|: each layer's
        attention output may round one ulp apart, and 40 layers carry it."""
        a, b = a[:, :V].float(), b[:, :V].float()
        top = float(b.abs().max())
        tol = 8 * bf16_ulp(top)
        err = float((a - b).abs().max())
        print(f"{label}: max |logit kernels - plain| = {err:.4e} (limit {tol:.4e}, 8 bf16 ulps "
              f"of the largest |logit| {top:.4f})")
        need(bool(torch.isfinite(a).all()) and err <= tol, f"{label}: logits differ by {err}")
        return tol

    tol = compare("prefill, last token", lk, lp)
    with plain_attention(prefill=_prefill_f64):
        l64, _ = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    d32 = float((lp[:, :V].float() - l64[:, :V].float()).abs().max())
    dk = float((lk[:, :V].float() - l64[:, :V].float()).abs().max())
    print(f"yardstick, prefill attention in float64: max |logit plain - float64| = {d32:.4e}, "
          f"max |logit kernels - float64| = {dk:.4e}")
    tk, tp = torch.argmax(lk[:, :V], -1), torch.argmax(lp[:, :V], -1)
    t64 = torch.argmax(l64[:, :V], -1)
    top2 = lp[:, :V].float().topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decided = gap > 2 * tol  # there the tolerance fixes the argmax
    print(f"first greedy token: {int((tk == tp).sum())} of {len(tk)} equal; "
          f"{int(decided.sum())} rows with a top-2 gap over twice the limit")
    for b in range(len(tk)):
        print(f"  row {b}: kernels {int(tk[b])}, plain {int(tp[b])}, float64 {int(t64[b])}, "
              f"plain top-2 gap {float(gap[b]):.4f}")
    need(torch.equal(tk[decided], tp[decided]), "the first greedy token differs")
    top2 = l64[:, :V].float().topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    print(f"first greedy token against float64 attention: kernels {int((tk == t64).sum())}, "
          f"plain {int((tp == t64).sum())} of {len(tk)} equal; {int(decided.sum())} rows decided")
    need(torch.equal(tk[decided], t64[decided]), "the first greedy token differs from float64's")
    need(np.array_equal(tk.cpu().numpy(), first_out[:, 0]), "prefill does not repeat generate")
    tok = tk
    for step in range(TEACHER_STEPS):
        lk, ck = decode_step(cfg, params, ck, tok, dev)
        with plain_attention():
            lp, cp = decode_step(cfg, params, cp, tok, dev)
        compare(f"decode step {step + 1}, teacher-forced", lk, lp)
        tok = torch.argmax(lk[:, :V], -1)
    again = engine.generate(prompts, SERVE_NEW)
    need(np.array_equal(again, first_out), "two generate calls on equal prompts differ")
    print(f"two generate calls on equal prompts: equal tokens ({again.size})")


# -- the scenario path (phases 16-18) ---------------------------------------

def cpu_quick_rows(name):
    """Phase 17's CPU side, in a worker process: ``run_scenario`` at quick
    on the CPU (every kernel's plain version), the device rows only."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    from repro_torch.cachesim.scenarios import run_scenario

    return run_scenario(name, "quick", policies=DEVICE_POLICIES, device="cpu").rows


def start_cpu_quick():
    """Start phase 17's CPU runs, one worker process a scenario (spawned:
    no CUDA in them), so that they overlap the card's phases 16-17."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(SCENARIO_NAMES), mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(cpu_quick_rows, name) for name in SCENARIO_NAMES}


def automaton_case(kind, n, c, n_slots, trace, dev):
    """The initial carry (empty slots; FTPL its noise's top C) of one case,
    on the CPU and on ``dev``."""
    from repro_torch.cachesim.engines import init_engine_carry

    cpu = init_engine_carry(kind, n, c, n_slots=n_slots, horizon=len(trace), device="cpu")
    return cpu, type(cpu)(*(x.to(dev, copy=True) for x in cpu))


def automaton_trace(name, c, seed):
    """A phase-16 case's ids: a round robin of C distinct items over 4C,
    which fills every slot from empty, then AUTOMATON_IDS of the named
    trace (zipf over max(4C, 2000) items, or a round robin over 4C), so
    that every kind evicts at every C."""
    import numpy as np

    from repro_torch.cachesim.traces import adversarial, zipf

    body = (zipf(max(4 * c, 2000), AUTOMATON_IDS, alpha=0.9, seed=seed) if name == "zipf"
            else adversarial(4 * c, AUTOMATON_IDS, seed=seed))
    return np.concatenate([adversarial(4 * c, c, seed=seed + 1), body])


def run_automaton(fn, kind, carry, ids, fill, chunks):
    """Launches of ``fn`` (the wrapper or its plain version) over ``ids``:
    the first ``fill`` ids in one, the rest in ``chunks``; the launches'
    hits and stats, and the evictions seen (items in the slots before a
    launch and not after it, summed over the launches)."""
    from repro_torch.cachesim.engines import automaton_args

    out, evicted = [], 0
    for part in (ids[:fill], *ids[fill:].chunk(chunks)):
        before = set(carry.slots.tolist())
        hits, stats = fn(kind, *automaton_args(kind, carry), part)
        out.append((int(hits), float(stats[0]), float(stats[1]), float(stats[2])))
        evicted += len(before - set(carry.slots.tolist()) - {-1, -2})
    return out, evicted


def automaton_bytes(torch, kind, slots, ids):
    """Bytes one chunk must move, from its inputs: the ids read; the slots
    and their stamps or ticks (not ftpl) read and written; the counts (lfu,
    ftpl) of the slots' items and of the requested ids read once and of the
    requested ids written once; the noise (ftpl) of the same items read
    once; the clock (not ftpl) read and written, and the three outputs."""
    keyed = kind != "ftpl"
    n_bytes = 4 * ids.numel() + 2 * 4 * slots.numel() * (1 + keyed) + 8 * keyed + 16
    if kind in ("lfu", "ftpl"):
        requested = torch.unique(ids)
        touched = torch.unique(torch.cat([requested, slots[slots >= 0]])).numel()
        n_bytes += 4 * touched * (1 + (kind == "ftpl")) + 4 * requested.numel()
    return n_bytes


def max_abs_diff(torch, got, want):
    """The largest |got - want| over pairs of tensors of one shape (a pair
    of equal values, infinities too, counts 0)."""
    err = 0.0
    for a, b in zip(got, want):
        need(a.shape == b.shape, f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
        d = (a.double() - b.double()).abs()
        if d.numel():
            err = max(err, float(torch.where(a == b, torch.zeros_like(d), d).max()))
    return err


def check_slot_automaton(torch, dev):
    """Phase 16: the slot automaton against its plain version, bit for bit,
    on the card and against the CPU, every case filling its slots and
    every kind evicting at every C; then its time a request, cold, in the steady state: from a
    full carry, the timed chunk first held against the plain version."""
    import numpy as np

    from repro_torch.cachesim.engines import automaton_args
    from repro_torch.cachesim.traces import adversarial, zipf
    from repro_torch.kernels.slot_automaton.ops import MAX_SLOTS, plan, slot_automaton
    from repro_torch.kernels.slot_automaton.ref import slot_automaton_ref

    cases = []
    for kind in AUTOMATA:
        for c in AUTOMATON_CS + (MAX_SLOTS,):
            cases.append((kind, c, None, "zipf", automaton_trace("zipf", c, c)))
            cases.append((kind, c, None, "adversarial", automaton_trace("adversarial", c, c)))
        for c in (250, 1000):  # padded: n_slots > C, the inactive slots never touched
            cases.append((kind, c, c + 37, "zipf", automaton_trace("zipf", c, 7)))
    n_hits, evictions = 0, {}
    for kind, c, n_slots, name, trace in cases:
        n = int(trace.max()) + 1
        cpu, card = automaton_case(kind, n, c, n_slots, trace, dev)
        _, plain = automaton_case(kind, n, c, n_slots, trace, dev)
        ids = torch.from_numpy(trace.astype("int32"))
        runs = [run_automaton(fn, kind, carry, x, c, AUTOMATON_CHUNKS)
                for fn, carry, x in ((slot_automaton, card, ids.to(dev)),
                                     (slot_automaton_ref, plain, ids.to(dev)),
                                     (slot_automaton, cpu, ids))]
        (got, evicted), (want, _), (on_cpu, _) = runs
        label = f"slot_automaton {kind} C={c} n_slots={n_slots or c} {name}"
        need(got == want == on_cpu, f"{label}: hits or stats differ: {got} {want} {on_cpu}")
        for field, a, b, h in zip(card._fields, card, plain, cpu):
            need(torch.equal(a, b) and torch.equal(a.cpu(), h), f"{label}: carry {field} differs")
        if n_slots:
            need(bool((card.slots[c:] == -2).all()), f"{label}: an inactive slot was written")
        n_hits += sum(h for h, *_ in got)
        evictions[kind, c] = evictions.get((kind, c), 0) + evicted
    for (kind, c), evicted in evictions.items():
        need(evicted > 0, f"slot_automaton {kind} C={c}: no case evicted a slot")
    print(f"slot_automaton: {len(cases)} cases (4 kinds x C in {AUTOMATON_CS + (MAX_SLOTS,)}, "
          f"zipf and adversarial, and padded carries), a launch of C distinct ids filling the "
          f"slots from empty, then {AUTOMATON_IDS} ids in {AUTOMATON_CHUNKS}: hits, stats "
          f"and the whole carry bit for bit against the plain version on the card and on the "
          f"CPU ({n_hits} hits); every kind evicts at every C (at least "
          f"{min(evictions.values())} evictions between launches)")
    too_big = automaton_case("lru", 2 * MAX_SLOTS, MAX_SLOTS + 1, None, [0], dev)[1]
    try:
        slot_automaton("lru", too_big.slots, too_big.stamps, None, None, too_big.t,
                       torch.zeros(4, dtype=torch.int32, device=dev))
    except ValueError as exc:
        need("tree automata" in str(exc), f"the size limit's message: {exc}")
        print(f"C = {MAX_SLOTS + 1} on the card raises: {exc}")
    else:
        raise Failed(f"slot_automaton took {MAX_SLOTS + 1} slots")

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    def restorer(carry, start):
        def reset():
            for x, x0 in zip(carry, start):
                x.copy_(x0)
        return reset

    rows, by_c, bounds, timed_evictions, err = {}, {}, {}, {}, 0.0
    w = QUICK_WINDOW
    for kind in AUTOMATA:
        for c in AUTOMATON_CS + (MAX_SLOTS,):
            n = QUICK_N if c <= 1000 else 4 * MAX_SLOTS
            trace = np.concatenate([adversarial(n, c, seed=5), zipf(n, 2 * w, alpha=0.9, seed=5)])
            _, card = automaton_case(kind, n, c, None, trace, dev)
            # the steady state: C distinct ids fill the slots, a chunk runs on
            slot_automaton(kind, *automaton_args(kind, card),
                           torch.from_numpy(trace[:c + w].astype("int32")).to(dev))
            ids = torch.from_numpy(trace[c + w:].astype("int32")).to(dev)
            start = type(card)(*(x.clone() for x in card))
            plain = type(card)(*(x.clone() for x in card))
            got = slot_automaton(kind, *automaton_args(kind, card), ids)
            want = slot_automaton_ref(kind, *automaton_args(kind, plain), ids)
            case_err = max_abs_diff(torch, (*got, *card), (*want, *plain))
            label = f"slot_automaton {kind} C={c} N={n}, the timed chunk"
            need(case_err == 0, f"{label}: differs from the plain version by {case_err}")
            evicted = len(set(start.slots.tolist()) - set(card.slots.tolist()))
            need(evicted > 0, f"{label}: no slot was evicted")
            err = max(err, case_err)
            reset = restorer(card, start)
            args = (kind, *automaton_args(kind, card), ids)
            ms = timed_ms(torch, lambda: slot_automaton(*args), 5, flush, reset=reset)
            b, by = bound_ms(automaton_bytes(torch, kind, start.slots, ids), 0)
            by_c.setdefault(kind, {})[c] = ms * 1e3 / w
            bounds.setdefault(kind, {})[c] = b * 1e3
            timed_evictions.setdefault(kind, {})[c] = evicted
            if c != QUICK_C:
                continue
            warm_ms = timed_ms(torch, lambda: slot_automaton(*args), 5, reset=reset)
            plain_args = (kind, *automaton_args(kind, plain), ids)
            plain_ms = timed_ms(torch, lambda: slot_automaton_ref(*plain_args), 1, flush,
                                reset=restorer(plain, start))
            rows[kind] = {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b,
                          "bound_by": by, "max_abs_err": case_err,
                          "us_per_request": ms * 1e3 / w,
                          "plain_us_per_request": plain_ms * 1e3 / w, "plan": plan(c),
                          "hits": int(got[0]), "evicted": evicted}
            print(f"slot_automaton {kind}, quick's shape (C={c}, N={n}, window {w}, from a "
                  f"full carry, {int(got[0])} hits, {evicted} evicted): cold {ms * 1e3:.2f} us "
                  f"({ms * 1e3 / w:.4f} us a request), warm {warm_ms * 1e3:.2f} us; plain on "
                  f"the card {plain_ms * 1e3:.2f} us ({plain_ms * 1e3 / w:.3f} us a request); "
                  f"bound {b * 1e3:.4f} us by {by}; max abs err {case_err}; plan {plan(c)}")
    for kind, per in by_c.items():
        print(f"slot_automaton {kind}: us a request, cold, from a full carry, at C = "
              + ", ".join(f"{c}: {us:.4f}" for c, us in per.items())
              + "; bound (us a chunk) "
              + ", ".join(f"{c}: {us:.4f}" for c, us in bounds[kind].items())
              + f"; evictions in the timed chunk {timed_evictions[kind]}")
    main = rows["lfu"]
    return {"ms": main["ms"], "warm_ms": main["warm_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "max_abs_err": main["max_abs_err"], "max_abs_err_all_timed": err,
            "timed": f"lfu at quick's shape from a full carry: C={QUICK_C}, N={QUICK_N}, "
            f"window {w}", "by_kind": rows, "us_per_request_by_c": by_c,
            "bound_us_by_c": bounds, "evictions_by_c": timed_evictions}


def _golden_rows(name):
    return json.loads((ROOT / "tests" / "cachesim" / "golden" / f"{name}.json").read_text())


def lru_compactions(m, cap, window, chunks):
    """The ring compactions the tree LRU launches over ``chunks`` chunks
    from an empty carry: one where the host's upper bound on pos leaves no
    room for the chunk (tree_engines.lru_bounds)."""
    from repro_torch.cachesim.tree_engines import LRUHost, lru_bounds

    host, n = LRUHost(pos_lo=0, pos_hi=0, cap=cap), 0
    for _ in range(chunks):
        n += host.pos_hi + window > m
        lo, hi = lru_bounds(host, window, m)
        host = host._replace(pos_lo=lo, pos_hi=hi)
    return n


def _scenario_launches(name, scale, policies=None, trace=None):
    """run_scenario on the card with every launch counted; checks one
    launch a chunk of each automaton row (slot_automaton for FIFO, tree_lru
    for LRU, minpair_automaton for LFU and FTPL), the LRU's possible ring
    compactions (a compaction launch and an int32 tree build each), and the
    OGB and OMD rows' histogram, mass and apply launches."""
    from repro_torch.cachesim.scenarios import get_scenario, run_scenario
    from repro_torch.cachesim.tree_engines import ring_for_window
    from repro_torch.kernels import launch_counts, reset_launch_counts

    sc = get_scenario(name)
    n, t, c = sc.dims(scale)
    w, batch = max(t // 20, 1), min(sc.batch, max(t // 20, 1))
    kinds = policies if policies is not None else sc.policies
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_scenario(name, scale, policies=policies, trace=trace, device="cuda")
    wall = time.perf_counter() - t0
    got = launch_counts()
    chunks, rows = t // batch, t // w
    comp = lru_compactions(ring_for_window(c, w), c, w, rows) if "lru" in kinds else 0
    want = {k: 0 for k in got}
    want.update({"slot_automaton": rows * ("fifo" in kinds),
                 "tree_lru": (rows + comp) * ("lru" in kinds),
                 "minpair_automaton": rows * (("lfu" in kinds) + ("ftpl" in kinds)),
                 "segsum": comp, "histogram": chunks * (("ogb" in kinds) + ("omd" in kinds)),
                 "mass": chunks * ("ogb" in kinds), "apply": chunks * ("ogb" in kinds)})
    need(got == want, f"{name} {scale}: launches {got}, expected {want}")
    return res, got, wall


def dense_rows(name):
    """The LRU, LFU and FTPL rows of a scenario at quick through the dense
    slot kernel (impl="dense") on the card, as run_scenario runs them."""
    from repro_torch import policy_def, run
    from repro_torch.cachesim.scenarios import get_scenario

    sc = get_scenario(name)
    n, t, c = sc.dims("quick")
    trace = sc.make_trace("quick")
    return {k.upper(): run(policy_def(k, impl="dense"), trace, n, c, window=max(t // 20, 1),
                           seed=0, horizon=t, track_opt=False, keep_carry=False).hit_ratio
            for k in TREE_AUTOMATA}


def check_scenarios(torch, cpu_futures):
    """Phase 17: every unsized scenario with a policy set through
    run_scenario on the card: at mini against the committed goldens, at
    quick against the port's CPU run (phase 17's workers)."""
    total = {}
    for name in SCENARIO_NAMES:
        res, _, wall = _scenario_launches(name, "mini")
        golden = _golden_rows(name)
        need(res.rows.keys() == golden["rows"].keys(), f"{name} mini: rows {sorted(res.rows)}")
        for policy, entry in golden["rows"].items():
            for metric, want in entry.items():
                got = round(res.rows[policy][metric], 10 if metric == "hit_ratio" else 6)
                if metric == "hit_ratio" and policy in FRACTIONAL_ROWS:
                    continue  # the Poisson p is the port's own (CPU tests: the reference's)
                tol = (GOLDEN_EXACT if metric == "hit_ratio"
                       else max(GOLDEN_FLOAT * golden["T"], abs(want) * 5e-3))
                need(abs(got - want) <= tol, f"{name} mini {policy} {metric}: {got} != {want}")
        print(f"{name} mini on the card: {len(golden['rows'])} rows against the golden (automata, "
              f"ARC, OPT exact; OGB/OMD regret within tolerance) in {wall:.2f} s")
    for name in SCENARIO_NAMES:
        res, got, wall = _scenario_launches(name, "quick")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        cpu = cpu_futures[name].result(timeout=900)
        for policy, row in cpu.items():
            card = res.rows[policy]
            if policy in FRACTIONAL_ROWS:
                dh = abs(card["hit_ratio"] - row["hit_ratio"])
                df = abs(card["frac_hit_ratio"] - row["frac_hit_ratio"]) / row["frac_hit_ratio"]
                need(dh <= QUICK_HIT_TOL and df <= QUICK_FRAC_TOL,
                     f"{name} quick {policy}: card vs CPU hit ratio {dh}, frac rel {df}")
            else:
                need(card["hit_ratio"] == row["hit_ratio"],
                     f"{name} quick {policy}: card {card['hit_ratio']} != CPU {row['hit_ratio']}")
        dense = dense_rows(name)
        for policy, hit_ratio in dense.items():
            need(res.rows[policy]["hit_ratio"] == hit_ratio,
                 f"{name} quick {policy}: tree {res.rows[policy]['hit_ratio']} != dense "
                 f"{hit_ratio}")
        line = ", ".join(f"{p} {r['hit_ratio']:.4f}" for p, r in sorted(res.rows.items()))
        us = ", ".join(f"{p} {r['us_per_request']:.4f}" for p, r in sorted(res.rows.items())
                       if "us_per_request" in r)
        print(f"{name} quick on the card ({wall:.2f} s): {line}; us a request: {us}; "
              f"equal to the CPU run (automata exactly; OGB/OMD hit ratio within "
              f"{QUICK_HIT_TOL}, fractional within {QUICK_FRAC_TOL} relative); the tree "
              f"rows LRU, LFU, FTPL equal to the dense slot kernel's")
    print(f"quick scenarios' launches: {total}")
    return total


def check_paper_scale(torch):
    """Phase 18: fig2_adversarial at full (every row, ARC too) and
    fig8_cdn at full for OGB, OMD and the tree LRU, LFU and FTPL."""
    from repro_torch.cachesim.scenarios import get_scenario, run_scenario

    sc = get_scenario("fig2_adversarial")
    n, t, c = sc.dims("full")
    t0 = time.perf_counter()
    res = run_scenario("fig2_adversarial", "full", device="cuda")
    opt = c / n
    print(f"fig2_adversarial full (N={n}, T={t}, C={c}), {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{p} hit {r['hit_ratio']:.4f}" + (f" ({r['us_per_request']:.4f} us/req)"
                                                       if "us_per_request" in r else "")
                      for p, r in sorted(res.rows.items())))
    need(res.skipped == (), f"fig2 full skipped {res.skipped}")
    for p in ("OGB", "OMD"):
        need(res.rows[p]["hit_ratio"] > 0.7 * opt, f"fig2 full: {p} not above 0.7 C/N")
    for p in ("LRU", "LFU"):
        need(res.rows[p]["hit_ratio"] < 0.2 * opt, f"fig2 full: {p} not below 0.2 C/N")
    print(f"fig2 claims (benchmarks/fig2_adversarial.py): OGB and OMD above 0.7 C/N = "
          f"{0.7 * opt:.4f}, LRU and LFU below 0.2 C/N = {0.2 * opt:.4f}: met")

    sc = get_scenario("fig8_cdn")
    n, t, c = sc.dims("full")
    t0 = time.perf_counter()
    trace = sc.make_trace("full")
    print(f"fig8_cdn full: trace N={n} T={t} in {time.perf_counter() - t0:.2f} s")
    res, launches, wall = _scenario_launches("fig8_cdn", "full", FIG8_POLICIES, trace)
    opt = res.rows["OPT(static)"]["hit_ratio"]
    for p, r in res.rows.items():
        print(f"fig8_cdn full {p}: hit ratio {r['hit_ratio']}"
              + "".join(f", {k} {r[k]}" for k in ("frac_hit_ratio", "regret", "us_per_request")
                        if k in r) + (" us a request" if "us_per_request" in r else ""))
    for p in ("OGB", "OMD"):
        r = res.rows[p]
        need(math.isfinite(r["regret"]) and 0.0 < r["hit_ratio"] < 1.0, f"fig8 full {p}: {r}")
    for p in ("LRU", "LFU", "FTPL"):
        need(0.0 < res.rows[p]["hit_ratio"] < 1.0, f"fig8 full {p}: {res.rows[p]}")
    need(res.rows["OGB"]["hit_ratio"] >= FIG8_OGB_FLOOR * opt,
         f"fig8 full: OGB {res.rows['OGB']['hit_ratio']} below {FIG8_OGB_FLOOR} OPT(static) {opt}")
    need(res.rows["OGB"]["hit_ratio"] > res.rows["LRU"]["hit_ratio"],
         f"fig8 full: OGB {res.rows['OGB']['hit_ratio']} not above LRU "
         f"{res.rows['LRU']['hit_ratio']} (benchmarks/fig7_8_traces.py:57)")
    need(min(launches[k] for k in ("tree_lru", "minpair_automaton", "segsum")) > 0,
         f"fig8 full: a tree kernel was not launched: {launches}")
    print(f"fig8_cdn full: OPT(static) {opt}; OGB at least {FIG8_OGB_FLOOR} of it and above LRU "
          f"(Fig. 8-left, benchmarks/fig7_8_traces.py:57): met ({wall:.2f} s); launches "
          f"{launches} (segsum: int32 tree builds, one a ring compaction)")
    check_no_host_reads(torch, trace, n, c, max(t // 20, 1))
    try:
        run_scenario("fig8_cdn", "full", policies=("fifo",), trace=trace, include_opt=False,
                     device="cuda")
    except ValueError as exc:
        need("no tree form" in str(exc) and "ROADMAP" in str(exc), f"FIFO's message: {exc}")
        print(f"fig8_cdn full FIFO at C = {c} raises: {exc}")
    else:
        raise Failed(f"FIFO ran at C = {c} on the slot kernel")
    return launches


def check_no_host_reads(torch, trace, n, c, window):
    """Phase 18: FIG8_SYNC_CHUNKS chunks of each automaton row of fig8_cdn
    full, from a started run, under torch's sync debug mode "error": a read
    of the device (or a blocking copy to it) in a chunk raises."""
    from repro_torch import policy_def
    from repro_torch.cachesim.tree_engines import ring_for_window

    chunks = torch.from_numpy(trace[:FIG8_SYNC_CHUNKS * window].astype("int32")).to(
        "cuda").reshape(FIG8_SYNC_CHUNKS, window)
    for kind in TREE_AUTOMATA:
        pd = policy_def(kind)
        ring = {"ring": ring_for_window(c, window)} if kind == "lru" else {}
        carry = pd.start(pd.init(n, c, horizon=len(trace), **ring))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(FIG8_SYNC_CHUNKS):
                carry, out = pd.step(carry, chunks[i])
        except RuntimeError as exc:
            raise Failed(f"fig8 full {kind}: a chunk read the device: {exc}") from exc
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"fig8_cdn full: {FIG8_SYNC_CHUNKS} chunks of {window} requests of each of LRU, LFU, "
          f"FTPL under sync debug mode 'error': 0 host reads in a chunk")


# -- the tree automata's kernels (phase 19) ------------------------------------

def tree_plain(kind, carry, ids):
    """One chunk of a tree automaton through its plain version, on the
    carry's device (the LRU's ring compaction decided from pos)."""
    from repro_torch.kernels.minpair_automaton.ref import minpair_automaton_ref
    from repro_torch.kernels.prefix_tree.ops import leaves_for_storage
    from repro_torch.kernels.tree_lru.ref import tree_lru_ref

    if kind == "lru":
        m = leaves_for_storage(carry.tree.numel(), 16)
        return tree_lru_ref(carry.tree, carry.last, carry.pos, carry.nseen, carry.cap, ids, m)
    lfu = kind == "lfu"
    return minpair_automaton_ref(kind, carry.imap, carry.counts, None if lfu else carry.noise,
                                 carry.slots, carry.tree_hi, carry.tree_lo,
                                 carry.t if lfu else None, ids)


def tree_tensors(carry):
    """A tree automaton's carry leaves that are tensors (the LRU's host
    bound is not)."""
    return [x for x in carry if hasattr(x, "device")]


def tree_copy(carry, dev):
    """The carry's tensors on ``dev``, copied (an LRU's host bound dropped:
    the card's first step reads it)."""
    return type(carry)(*(x.to(dev, copy=True) for x in tree_tensors(carry)))


def tree_case_trace(c, seed):
    """Phase 19's ids of one case: a round robin of C distinct ids over 4C
    items (filling every slot from empty), then TREE_IDS of zipf and a round
    robin over them, so that every kind evicts."""
    import numpy as np

    from repro_torch.cachesim.traces import adversarial, zipf

    n = max(4 * c, 2000)
    return n, np.concatenate([adversarial(n, c, seed=seed + 1),
                              zipf(n, TREE_IDS // 2, alpha=0.9, seed=seed),
                              adversarial(n, TREE_IDS // 2, seed=seed)]).astype("int32")


def tree_bytes(torch, kind, before, after, ids):
    """Bytes one chunk must move, from its inputs and what it changed: the
    ids read; each distinct requested item's last (LRU) or imap entry and
    count (LFU, FTPL; FTPL also its noise) read once; each changed carry
    entry written (last, imap, counts, slots); each changed tree node read
    and written (4 bytes a tree, 2 trees for LFU and FTPL)."""
    distinct = torch.unique(ids).numel()
    n_bytes = 4 * ids.numel() + 4 * distinct * (1 if kind == "lru" else 2 + (kind == "ftpl"))
    names = ("last",) if kind == "lru" else ("imap", "counts", "slots")
    for name in names:
        n_bytes += 4 * int((getattr(before, name) != getattr(after, name)).sum())
    trees = ("tree",) if kind == "lru" else ("tree_hi", "tree_lo")
    changed = sum((getattr(before, t) != getattr(after, t)) for t in trees)
    return n_bytes + 8 * len(trees) * int((changed > 0).sum())


def check_tree_automata(torch, dev):
    """Phase 19: tree_lru and minpair_automaton against their plain versions,
    bit for bit, on the card and against the CPU, every case evicting; the
    int32 tree build; then each kernel's time cold from a full carry."""
    import numpy as np

    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.cachesim.traces import adversarial, zipf
    from repro_torch.kernels.prefix_tree.ops import leaves_for_storage, tree_build, tree_storage
    from repro_torch.kernels.prefix_tree.ref import tree_build_ref
    from repro_torch.kernels.tree_lru.ops import ring_compaction, tree_lru

    cases = [(kind, c, None, None) for kind in TREE_AUTOMATA for c in TREE_CS]
    cases += [(kind, c, c + 37, None) for kind in ("lfu", "ftpl") for c in (23, 1000)]
    cases += [("lru", c, None, ring) for c, ring in ((23, 256), (1000, 4096))]
    err, n_hits = 0.0, 0
    for kind, c, n_slots, ring in cases:
        n, trace = tree_case_trace(c, c)
        window = min(TREE_IDS // 2, tt.max_window(ring)) if ring else TREE_IDS // 2
        cpu = tt.init_tree_engine_carry(kind, n, c, n_slots=n_slots, ring=ring,
                                        horizon=len(trace), device="cpu")
        card, plain = tree_copy(cpu, dev), tree_copy(cpu, dev)
        ids = torch.from_numpy(trace)
        parts = [ids[:c]] + list(ids[c:].split(window))
        evicted, misses = 0, 0
        for part in parts:
            before = set(cpu.slots.tolist()) if kind != "lru" else set()
            card, got = tt.tree_chunk(kind, card, part.to(dev))
            want = tree_plain(kind, plain, part.to(dev))
            cpu, on_cpu = tt.tree_chunk(kind, cpu, part)
            case_err = max_abs_diff(torch, (*got, *tree_tensors(card)),
                                    (*want, *tree_tensors(plain)))
            label = f"{kind} C={c} n_slots={n_slots or c} ring={ring}"
            need(case_err == 0, f"{label}: card differs from the plain version by {case_err}")
            for a, h in zip((*got, *tree_tensors(card)), (*on_cpu, *tree_tensors(cpu))):
                need(torch.equal(a.cpu(), h), f"{label}: card differs from the CPU")
            err = max(err, case_err)
            n_hits += int(got[0])
            misses += part.numel() - int(got[0])
            if kind != "lru":
                evicted += len(before - set(cpu.slots.tolist()) - {-1, -2})
        if kind == "lru":
            evicted = misses - int(cpu.nseen.clamp(max=c))  # misses past a full cache
        need(evicted > 0, f"{kind} C={c}: no eviction")
        if n_slots:
            need(bool((card.slots[c:] == -2).all()), f"{kind} C={c}: an inactive slot written")
    print(f"tree automata: {len(cases)} cases (LRU, LFU, FTPL at C in {TREE_CS}, padded LFU "
          f"and FTPL, LRU with a ring of 4C: forced compactions), C distinct ids filling the "
          f"slots, then {TREE_IDS} ids: hits, stats and every carry leaf bit for bit against "
          f"the plain version on the card and the CPU ({n_hits} hits, max abs err {err}); "
          f"every case evicts")

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    build = {}
    for m in INT32_BUILD_LEAVES:
        leaves = (torch.rand(m, device=dev) < 0.3).to(torch.int32)
        got = tree_build(leaves, 16)
        want = tree_build_ref(leaves, 16)
        e = max_abs_diff(torch, (got,), (want,))
        need(e == 0 and torch.equal(got.cpu(), tree_build_ref(leaves.cpu(), 16)),
             f"int32 tree build at {m} leaves differs by {e}")
        out = torch.empty_like(got)
        ms = timed_ms(torch, lambda: tree_build(leaves, 16, out=out), 20, flush)
        plain_ms = timed_ms(torch, lambda: tree_build_ref(leaves, 16), 5, flush)
        b, by = bound_ms(4 * m + 4 * tree_storage(m, 16), tree_storage(m, 16) - m)
        build[m] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                    "max_abs_err": e}
        print(f"int32 tree build, {m} leaves at radix 16: cold {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, bound {b * 1e3:.4f} us by {by}, max abs err {e}")

    timed, compaction = {}, {}
    for c, (n, w) in TREE_TIMED.items():
        fill = np.concatenate([adversarial(n, c, seed=9), zipf(n, w, alpha=0.9, seed=9)])
        chunk = torch.from_numpy(zipf(n, w, alpha=0.9, seed=10).astype("int32")).to(dev)
        for kind in TREE_AUTOMATA:
            ring = {"ring": tt.ring_for_window(c, w)} if kind == "lru" else {}
            card = tt.start_tree_run(tt.init_tree_engine_carry(
                kind, n, c, horizon=len(fill) + w, device=dev, **ring))
            card, _ = tt.tree_chunk(kind, card, torch.from_numpy(fill.astype("int32")).to(dev))
            start = tt.start_tree_run(card)
            plain = tt.start_tree_run(card)
            t0 = time.perf_counter()
            want = tree_plain(kind, plain, chunk)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if kind == "lru":
                m = leaves_for_storage(card.tree.numel(), 16)
                need(int(card.pos) + w <= m, "the timed LRU chunk would compact")
                args = (card.tree, card.last, card.pos, card.nseen, card.cap, chunk, m)

                def kern():
                    return tree_lru(*args, compact=False)
            else:
                def kern(kind=kind, card=card):
                    return tt.tree_chunk(kind, card, chunk)[1]
            got = kern()
            case_err = max_abs_diff(torch, (*got, *tree_tensors(card)),
                                    (*want, *tree_tensors(plain)))
            label = f"{kind} C={c} N={n}, the timed chunk of {w}"
            need(case_err == 0, f"{label}: differs from the plain version by {case_err}")
            if kind == "lru":
                evicted = w - int(got[0])  # the cache is full: every miss evicts
            else:
                evicted = len(set(start.slots.tolist()) - set(card.slots.tolist()))
            need(evicted > 0, f"{label}: no eviction")
            n_bytes = tree_bytes(torch, kind, start, card, chunk)
            err = max(err, case_err)

            def reset(card=card, start=start):
                for x, x0 in zip(tree_tensors(card), tree_tensors(start)):
                    x.copy_(x0)

            ms = timed_ms(torch, kern, 2 if w > 100_000 else 5, flush, reset=reset)
            b, by = bound_ms(n_bytes, 0)
            timed[kind, c] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                              "max_abs_err": case_err, "us_per_request": ms * 1e3 / w,
                              "plain_us_per_request": plain_ms * 1e3 / w, "window": w, "N": n,
                              "hits": int(got[0]), "evicted": evicted}
            print(f"{kind} C={c} N={n}, a {w}-request chunk from a full carry ({int(got[0])} "
                  f"hits, {evicted} evicted): cold {ms:.4f} ms ({ms * 1e3 / w:.5f} us a "
                  f"request); plain on the card {plain_ms:.2f} ms ({plain_ms * 1e3 / w:.4f} us a "
                  f"request); bound {b * 1e3:.4f} us by {by} ({n_bytes} bytes); max abs err "
                  f"{case_err}")
            if kind == "lru":
                # a due compaction at this shape: pos pushed past m - w
                card.pos.fill_(m - w + 1)
                saved = [x.clone() for x in tree_tensors(card)]

                def compact(card=card, m=m):
                    ring_compaction(card.tree, card.last, card.pos, card.cap, w, m)

                def restore(card=card, saved=saved):
                    for x, x0 in zip(tree_tensors(card), saved):
                        x.copy_(x0)

                cms = timed_ms(torch, compact, 5, flush, reset=restore)
                compaction[c] = cms
                print(f"  a ring compaction at C={c} (ring {m}, N={n}): cold {cms * 1e3:.2f} us "
                      f"(the grid launch and the int32 tree build)")
    print(f"phase 19 max abs err over every case and timed chunk: {err}")
    rows = {}
    chains = {"tree_lru": "a chain of dependent 256-request sub-chunks",
              "minpair_automaton": "a chain of dependent requests, each a few warp-wide "
                                   "reductions and a group of leaves read from L2"}
    for name, kinds in (("tree_lru", ("lru",)), ("minpair_automaton", ("lfu", "ftpl"))):
        main = timed[kinds[0], 50000]
        rows[name] = {
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "bound_note": f"latency-bound: {chains[name]}",
            "library_ms": None, "max_abs_err": err,
            "timed": f"{kinds[0]} at fig8_cdn full's shape from a full carry: C=50000, "
                     f"N={TREE_TIMED[50000][0]}, a chunk of {TREE_TIMED[50000][1]}",
            "by_case": {f"{k} C={c}": timed[k, c] for k in kinds for c in TREE_TIMED},
        }
    rows["tree_lru"]["compaction_ms"] = compaction
    return rows, build


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    card = nvidia_smi_line()
    print(f"python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    _libs, logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s, {sorted(_libs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    trace = zipf(N, T, alpha=ALPHA, seed=0)
    print(f"trace: zipf N={N} T={T} alpha={ALPHA}, {time.perf_counter() - t0:.2f} s")
    eta = theoretical_eta(C, N, T, 1)

    carry = tree_state(trace, eta)
    rows = check_kernels(torch, dev, trace, eta, dense_tau(trace, eta), carry)
    rows.update(check_tree_kernels(torch, dev, carry, eta))
    rows.update(check_tree_sums(torch, dev, carry, trace, rows.pop("segsum")))
    launches, designs = check_main_path(torch, trace, eta)
    check_card_against_cpu(trace, eta)
    check_resume(torch, trace, eta)
    breakdown(torch, trace, eta)
    tree_launches, tree_designs = check_tree_main_path(trace, eta)
    check_tree_card_against_cpu(trace, eta)
    check_tree_repeat_and_resume(torch, trace, eta)
    reanchor_histograms = check_reanchor(torch, trace, eta)
    madow_segsum = check_madow(trace, eta)
    tree_profile = breakdown(torch, trace, eta, kind="ogb_tree")
    attn_errs = check_attention_kernels(torch, dev)
    rows.update(time_attention_kernels(torch, dev, attn_errs))
    engine, prompts, first_out, serve_launches = serve_full_width(torch, dev)
    serve_breakdown(torch, engine, prompts)
    check_served_against_plain(torch, engine, prompts, first_out)
    del engine

    t_scenarios = time.perf_counter()
    pool, cpu_futures = start_cpu_quick()
    try:
        rows["slot_automaton"] = check_slot_automaton(torch, dev)
        scenario_launches = check_scenarios(torch, cpu_futures)
        fig8_launches = check_paper_scale(torch)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"scenario phases 16-18: {time.perf_counter() - t_scenarios:.2f} s")
    t_tree = time.perf_counter()
    tree_rows, int32_build = check_tree_automata(torch, dev)
    rows.update(tree_rows)
    print(f"tree automata phase 19: {time.perf_counter() - t_tree:.2f} s")

    # launches: the dense main path's for its kernels, the lazy main path's
    # for the prefix-tree kernels (segsum also ran 1 a chunk on madow_tree)
    launches.update({k: tree_launches[k] for k in ("segsum", "tree_update", "bucket_mass")})
    launches.update({k: serve_launches[k] for k in ("flash_prefill", "decode_attention")})
    # the automata's: the seven quick scenarios on the card (phase 17); the
    # tree kernels' on fig8_cdn full beside them (phase 18)
    for name in ("slot_automaton", "tree_lru", "minpair_automaton"):
        launches[name] = scenario_launches[name]
    for name in ("tree_lru", "minpair_automaton"):
        rows[name]["launches_fig8_full"] = fig8_launches[name]
    # the int32 tree build: a ring compaction's, launched on the scenario paths
    rows["segsum"]["int32"] = {"by_leaves": int32_build,
                               "launches_quick": scenario_launches["segsum"],
                               "launches_fig8_full": fig8_launches["segsum"]}
    # the redesigned kernels name the design their main path launched
    for name in ("mass", "histogram", "apply"):
        rows[name]["design"] = " + ".join(designs[name])
    # the re-anchor's histograms: their launches in phase 9's forced re-anchors
    rows["histogram"]["reanchor"]["launches_by_design"] = reanchor_histograms
    rows["bucket_mass"]["design"] = " + ".join(tree_designs["bucket_mass"])
    for name, design in DESIGNS.items():
        rows[name]["design"] = design
    # the tree kernels in an ogb_tree chunk, and the chunk itself (phase 11)
    for name, key in (("tree_update", "tree_update_kernel"), ("segsum", "tree_build_kernel")):
        rows[name]["in_chunk"] = tree_profile["port_kernels"].get(key)
    rows["tree_update"]["ogb_tree_chunk"] = {k: v for k, v in tree_profile.items()
                                             if k != "port_kernels"}
    print(f"segsum launches: ogb_tree main path {launches['segsum']}, madow_tree "
          f"{madow_segsum} over {MADOW_CHUNKS} chunks")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
