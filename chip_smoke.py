#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit, and builds the kernels from the checkout's sources on first use
(into build/repro_torch/).  Phases, in order; the first failure stops the
script with a non-zero exit:

1. versions, and the card's name and power limit (nvidia-smi);
2. build every kernel; fail if ptxas serializes any wgmma (its C7514/C7518
   notes, "wgmma ... serialized"), and print each kernel's registers,
   stack and spills;
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
   and at a run of 2000 deltas under one node (in either order of the
   adds), each bit for bit its plain version on the card and on the CPU,
   and timed beside its earlier plan in turns (tools/time_tree_updates.py);
4. the dense main path: run(policy_def("ogb")) over zipf(0.8) with
   N = 1e6, T = 1e7, C = 50 000, window 1000, every kernel's launches
   counted, the histogram's all bin tiles and the clip's all in the
   projection's epilogue;
5. the card against the CPU (the plain versions) over the first 100 chunks;
6. resume: 2000 chunks in two calls equal one call, bit for bit;
7. where a chunk's time goes, from torch.profiler over 300 chunks;
8. the lazy main path: run(policy_def("ogb_tree")) over the same trace,
   launches, host syncs and re-anchors counted (3 tree builds at init and
   a re-anchor, 3 tree updates and a bin-tiles histogram a chunk), its
   fractional hit ratio held to the JAX reference's for this trace and eta;
9. ogb_tree on the card against the CPU over 100 chunks, two runs of 500
   chunks and a resumed run bit for bit, and a re-anchor in every chunk
   (batch_hint=1: 50 chunks on the card, 20 against the CPU), two
   id-slices histograms a re-anchor;
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
   and adversarial ids (4000 a case in 2 launches, from empty slots),
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
   the same trace; a launch a chunk of each automaton row (fifo_queue
   for FIFO, tree_lru for LRU, minpair_automaton for LFU and FTPL; the
   LRU's possible ring compactions a compaction launch and an int32 tree
   build each), the OGB row's histogram, mass and apply and the OMD row's
   histogram once a chunk;
18. paper scale: fig2_adversarial at full (N = 1000, T = 1e6, C = 250,
   every row, ARC on the host), held to the figure's claims; fig8_cdn at
   full (N = 1e6, T = 2e7, C = 50 000, B = 1000, a window of 1e6) for OGB,
   the tree LRU, LFU and FTPL and FIFO (the FIFO queue, past the slot
   kernel's 16 384 slots; OMD, whose host-bound KL projection would take
   ~78 s here, runs at fig2_adversarial full and on every quick scenario),
   OGB held to a share of OPT(static) and above
   LRU (Fig. 8-left), FIFO's hits the recorded ones, each row's hit
   ratio and us a request printed, every tree kernel and the FIFO queue
   launched, three chunks of each automaton
   row run again under torch's sync debug mode "error" (no read of the
   device in a chunk);
19. the tree automata's kernels against their plain versions on the card,
   bit for bit and against the CPU: tree_lru and minpair_automaton (LFU,
   FTPL) at C = 23, 1000, 16 384 and 50 000 from empty slots, every case
   evicting, a forced ring compaction and padded slots, the min-pair kernel
   also at its radix's edges (C = 64, 65, 4097) and with 1.3 million slots
   (its least-leaf pointers in L2: both plans launched); the int32 tree
   build at 262 144 and 2^21 leaves; each kernel's time cold from a full
   carry at quick's shape (C = 1000, N = 20 000, a 10 000-request chunk)
   and fig8_cdn full's (C = 50 000, N = 1e6, a 1e6-request chunk) beside
   its bound, its plain version on the card and its earlier design, in
   turns (tools/time_automaton_designs.py), and a ring compaction's;
20. the sized axis's kernels against their plain versions, bit for bit on
   the card and against the CPU: the FIFO queue at C = 25, 1000, 16 384 and
   50 000 and padded, and on churn traces (tiles that evict items they
   request again) at C = 31, 32, 1000 and 50 000 and padded, every case
   evicting and both its plans launched; minpair_automaton's GDS mode at
   C = 23, 1000, 16 384, 50 000, 64, 65 and 4097 with dyadic costs, padded
   and with its pointers in L2; the FIFO queue and the GDS mode timed
   beside their earlier designs, in turns (tools/time_automaton_designs.py);
   the stacked tree update at a sized_cdn full chunk's three calls
   recorded from a mid-run state (each also as 4 one-tree launches), at a
   stacked call in input order and the int32 tree update over a ring's
   262 144 leaves, beside its earlier plan in turns, with each call's order
   of the adds, nodes a level and changed nodes (tools/time_tree_updates.py);
   the sized solve at that chunk and at built instances with G = 1, 6, 32,
   33 and 200 groups of buckets holding an item, both its plans counted,
   beside its earlier design in turns and at 0, 1 and 30 steps
   (tools/sweep_threshold_solves.py); each timed cold beside its bound, its
   plain version and a library call where one computes the same;
21. the sized scenario: sized_cdn at mini on the card against the golden
   (GDS, LRU, LFU, FTPL and OPT(static) hit and byte hit ratios exactly,
   OGB_sized_tree's byte regret within its tolerance), at quick against
   the port's CPU run (a worker process started with phase 17's), and at
   full (N = 1e6, T = 2e7, C = 50 000, a byte budget of 1 062 500, every
   row), each row's hit ratio, byte hit ratio and us a request printed and
   whether byte and object hit ratio rank the policies differently; a
   launch a chunk of each automaton row (GDS, LFU and FTPL one
   minpair_automaton each), three stacked tree updates, one sized solve
   and one histogram a chunk of OGB_sized_tree, and three chunks of the
   GDS row and of OGB_sized_tree under sync debug mode "error"; every
   full row's hit and byte hit ratio the recorded ones, and the G the
   sized solve met over the full run (its plans' device tally); and where
   an OGB_sized_tree chunk's time goes at full, from torch.profiler over
   200 chunks of a started run: device kernels, busy and wall us and idle
   share a chunk, and the three stacked updates' time in it;
22. the sweep: repro_torch.sweep over a grid of combos, each chunk one
   launch of each kernel for the whole grid.  Dense ogb (Poisson) over the
   main trace's first 1e6 requests, capacities 12 500, 25 000 and 50 000,
   etas None (Theorem 3.1's at each capacity) and 0.5 and 2 times Theorem
   3.1's at 50 000, seeds 0 and 1: 18 combos, one histogram and one warm
   projection a chunk for all, and the 18 single runs one after another,
   every row's final f and tau bit for bit its single run's and its hits
   equal; the tree LRU, LFU and FTPL (seeds 0 and 1) and FIFO over fig8_cdn
   full's first 1e7 requests at capacities 6 250 to 50 000 padded to 50 000
   slots, a launch a chunk for each kind (FIFO at most one a plan), every
   row's hits and final carry bit for bit its single run's; each part's
   wall time beside the single runs' sum and us a request a row; the warm
   solve at one row beside its one-row design in turns, and at 1, 4 and 18
   rows beside as many one-row launches (tools/time_warm_solves.py); the
   tree LRU, LFU and FIFO grids' chunks at 4 combos cold beside 4
   one-combo launches, each bit for bit them;
23. out-of-core streams, trace files and multi-tenant fleets: (a) the main
   trace written as a u32 trace file under build/, read back through
   open_trace -> CatalogRemap -> run_stream(policy_def("ogb"), C = 50 000,
   window 1000, horizon 1e7), with prefetch 2 and 0, each bit for bit the
   one-shot run over remap_trace of the trace (hits, reward, tau, final f),
   its ingest/device/host split and its growth of resident memory (VmRSS
   sampled every 20 ms while it ran); (b) edge_fleet_cdn full's edge tier
   (256 tenants, N = 1e5, 5e5 requests a tenant, C = 1562, window 500: the
   scenario's traces, made in threads) as run_fleet of the tree LRU and of
   dense ogb, one tree_lru launch a chunk (and where any tenant's ring
   compaction may be due one compaction launch and one int32 build of
   every tenant's tree) and one histogram and one warm solve a chunk for
   all 256, tenants 0, 85, 170 and 255 bit for bit
   their own runs (hits, reward, aux, occupancy, final carry), us a
   request of the fleet beside those four runs; (c) run_fleet of lfu, ftpl
   and fifo over the first 32 tenants, one launch a chunk (FIFO one a
   plan), tenants 0 and 31 bit for bit their runs; (d)
   run_edge_fleet_scenario("edge_fleet_cdn", "quick") on the card against
   the port's CPU run (a worker process started with phase 17's): the
   edges exactly, the origin within the dense path's limits (tau 1e-6,
   hits 1 in 10 000); (e) each per-row kernel (histogram, the warm solve
   over a counts row a row, tree_lru, minpair_automaton LFU, fifo_queue)
   at (b)'s shapes, 256 rows of ids, bit for bit its plain version (the
   warm solve: its one-row launches, tau within 1e-6 of the plain version)
   and timed cold beside 256 one-row launches and its bound;
24. MoE serving and the expert cache: (a) granite-moe-1b-a400m at full
   width, all 24 layers (random bf16 weights drawn on the card), served
   as phase 14 serves glm4-9b, exactly 24 flash_prefill and 24 x 32
   decode_attention launches a generate call, where its time goes, its
   logits against the plain attention versions' (rows where no (token,
   layer) routed differently, and every row with the plain run routed as
   the kernels'; the flips counted), 8 teacher-forced decode steps, and
   both attention kernels timed at its served shapes beside their bounds
   and scaled_dot_product_attention; (b) kimi-k2-1t-a32b at full width
   with its depth cut from 61 layers to 1 (33.8 GB of bf16 experts drawn
   expert by expert): a prefill of 1 x 512 tokens through capacity
   dispatch (capacity 11) and 8 decode steps, 64 sampled tokens' MoE
   output against a float64 evaluation of the same kept (expert, gate)
   pairs, and the dispatch's share of the layer's time; (c) OGBExpertCache
   at kimi-k2's 61 x 384 and granite-moe's 24 x 32 (layer, expert)
   catalogs, resident fraction 0.25, over 200 steps of Poisson(5) counts
   and a 1500-step drift run (8 hot experts a layer, moved at step 500),
   each step against the port's CPU run (worker processes started before
   phase 22): f and tau within 1e-5, the residency masks equal off |f - p|
   <= 1e-5, 50 masses launches and one apply a step, the hit ratio after
   the drift > 0.5; the step timed and profiled first, and the Poisson
   run's steps served open-loop by ContinuousServingLoop at 70% of that
   capacity (p50/p99, sustained req/s, backlog); and ogb_grad's masses and
   apply at N = 23 424 timed beside their plain versions;
25. the remaining attention families at full width and depth, each drawn
   in bf16 on the card and freed before the next: (a) mistral-nemo-12b
   with its int8 KV cache, served as phase 14 serves glm4-9b in 2 generate
   calls, exactly 40 flash_prefill and 40 x 32 int8-cache decode_attention
   launches a call, its logits within phase 15's limit of the plain
   versions' (prefill, and 8 teacher-forced decode steps from a copy of the
   kernels' cache), the int8 decode (its own kernel and plan) against its
   plain version at the served shape and around its slice, ring and split
   edges, timed beside the bf16-cache kernel over the same K and V, its
   bound and scaled_dot_product_attention over the dequantized cache,
   beside its PR 28 design in turns (tools/time_int8_decode_designs.py),
   and at split lengths around its plan's; (b) phi-3-vision-4.2b: 8 prompts
   of 256 image embeddings and 1792 tokens, 32 decode steps (32 wgmma+tma
   D = 96 causal prefill launches, 32 x 32 decode launches), logits against
   the plain versions', the D = 96 prefill against its plain version
   causal (the served shape), non-causal (S = T = 1500) and cross (S = 224
   over T = 1500), and timed beside the CUDA-core design it replaced (at
   the same inputs, through its C entry point), scaled_dot_product_attention
   and its bound; (c) whisper-large-v3: 8 utterances of 1500 frames and
   224-token prompts, 32 decode steps (a prefill: 32 non-causal, 32 causal
   and 32 cross flash_prefill launches; a step: 32 self and 32 cross
   decode_attention launches), logits against the plain versions', 64
   sampled rows of its first encoder and cross calls against float64
   attention, and both non-causal modes timed beside their bounds and
   scaled_dot_product_attention;
26. the SSM family: (a) the WKV-6 recurrence's kernel (wkv6) against its
   plain version on the card at rwkv6-1.6b's served layer (B 8, S 2048,
   H 32, n 64) from a zero and a mid-run state, with a fast and a
   near-zero decay, one past it (S 2049), 7 steps and a decode step (S 1),
   at n = 16 (a near-zero decay too) and 32, and a case a plan (n, P, C)
   with a near-one decay; y and the final state within WKV_TOL of the
   largest, two runs bit for bit; at the served layer and a decode step
   timed cold beside its PR 30 design in turns, its bound, its plain
   version and the floor of the timing (tools/time_wkv6_designs.py), and
   warm at the served layer (no library call computes it);
   (b) rwkv6-1.6b at full width and depth (random bf16 weights drawn on the
   card, w0 and u float32, its parameters counted leaf by leaf) served as
   phase 14 serves glm4-9b: exactly 24 + 24 x 32 wkv6 launches a generate
   call and no attention launch; (c) its logits against the plain
   version's after prefill and 8 teacher-forced decode steps, and prefill
   of 2048 tokens against prefill of 2047 and a decode step;
27. the hybrid family: (a) Mamba's selective scan (selective_scan) against
   its plain version on the card at jamba's served layer (B 8, S 2048,
   d_in 16 384, n 16) from a zero and a mid-run state, with slow (~1e-3)
   and fast (~5) dt, 7 steps, a decode step (S 1) and one past it (S 2049),
   at n = 8 and at a ragged d_in of 200; y and the final state within
   SCAN_TOL of the largest, two runs bit for bit; at the served layer and a
   decode step timed cold beside its earlier design in turns, and warm,
   beside its bound, the exponentials' floor, its plain version and the
   floor of the timing (tools/time_selective_scan_designs.py; no library
   call computes it); both attention kernels held against their plain versions
   at jamba's heads (H 64, Hkv 8, D 128) and served shapes, and timed
   beside scaled_dot_product_attention; (b) jamba-1.5-large at full width,
   its depth cut from 72 layers to one super-block of 4 (Mamba + MLP,
   Mamba + MoE, Mamba + MLP, attention + MoE; random bf16 weights drawn on
   the card, A_log, dt_bias, D and the routers float32, 23 776 305 152
   parameters counted leaf by leaf) served as phase 14 serves glm4-9b:
   exactly 3 + 3 x 32 selective_scan (3 of the prefill design, 3 x 32 of
   the decode step's), 1 flash_prefill and 32 decode_attention launches a
   generate call, and where a prefill and a
   decode step go; (c) its logits against the plain versions' after
   prefill and 8 teacher-forced decode steps (routing flips counted, the
   plain runs routed as the kernels'), and prefill of 2048 tokens against
   prefill of 2047 and a decode step on the rows no expert's capacity
   dropped;
28. training the attention families: (a) the backward kernel
   (flash_prefill_bwd: dq, dk, dv in three launches of its wgmma design,
   two of its CUDA-core design) against its plain version at glm4-9b's
   training shape (B=2, S=4096, H=32, Hkv=2, D=128, causal), granite-moe's
   D=64, phi-3-vision's D=96, whisper's non-causal (S = T = 1500) and cross
   (224 over 1500) shapes and the smoke configurations' float32 D=16:
   within 8 bf16 ulps of each output's largest (float32: 1e-4), two runs
   bit for bit, the CUDA-core design and the earlier mma.sync design
   (tools/time_flash_bwd_designs.py keeps it as text) held to the same
   limits, its time cold beside the earlier design's in turns (new, old,
   old, new), its bound, the design's own bound (7 products and the float32
   partials), its plain version and scaled_dot_product_attention's forward
   and backward, and the floor of the timing; (b) the
   forward's log-sum-exp in both designs against the plain version's: the
   serving call's design with an lse buffer (its output bit for bit the
   serving call's), and training's (bf16: the wgmma design with P split
   into bf16 hi + lo for its P V product; its output within 8 bf16 ulps of
   the plain version's); (c) glm4-9b
   at full width with its depth cut to 4 layers trained 8 steps (AdamW at
   lr 1e-4 after 2 warm-up steps,
   SyntheticLM data made by a worker meanwhile, 4 x 4096 tokens a step in 2
   microbatches, remat): the loss finite and falling, exactly 4 x 2 x 2
   flash_prefill and 4 x 2 x 3 flash_prefill_bwd launches a step, step
   seconds, tokens/s, MFU and peak memory printed, one more step under
   torch.profiler (busy time, the attention kernels' and the products'
   shares), and a forward and backward at 1 x 1024 tokens through the
   kernels against the plain
   versions from the same weights (loss, grad_norm, every attention weight's
   gradient); (d) every kernel wrapper without a backward (decode_attention,
   wkv6, selective_scan, flash_prefill's serving call) raises on a CUDA
   tensor that requires grad.

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
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, T, C, W = 1_000_000, 10_000_000, 50_000, 1000
ALPHA = 0.8
CPU_CHUNKS, RESUME_CHUNKS, TREE_RESUME_CHUNKS, PROFILE_CHUNKS = 100, 2000, 500, 300
MADOW_CHUNKS, MADOW_CPU_CHUNKS, REANCHOR_CHUNKS, REANCHOR_CPU_CHUNKS = 2000, 100, 50, 20
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
    "fifo_queue": "src/repro/cachesim/engines.py:172",
    # no Pallas kernel: the reference scans the WKV recurrence with lax.scan
    "wkv6": "src/repro/models/rwkv.py:74",
    # no Pallas kernel: the reference scans Mamba's recurrence with lax.scan
    "selective_scan": "src/repro/models/mamba.py:77",
    # flash_prefill's training form: the reference's gradient is JAX's autodiff
    # of its jnp flash_attention (the Pallas prefill kernel has no backward)
    "flash_prefill_bwd": "src/repro/models/attention.py:67",
    # wkv6's training form: the reference's gradient is JAX's autodiff of its
    # lax.scan of the WKV recurrence (no Pallas kernel)
    "wkv6_bwd": "src/repro/models/rwkv.py:74",
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
    "fifo_queue": "src/repro_torch/kernels/fifo_queue/csrc/fifo_queue.cu",
    "wkv6": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
    "selective_scan": "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
    "flash_prefill_bwd": "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill_bwd_wgmma.cu",
    "wkv6_bwd": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
}
KERNELS = ("histogram", "mass", "apply", "segsum", "tree_update", "bucket_mass",
           "flash_prefill", "decode_attention", "slot_automaton", "tree_lru",
           "minpair_automaton", "fifo_queue", "wkv6", "selective_scan", "flash_prefill_bwd",
           "wkv6_bwd")
#: the one design of each kernel that has one (wkv6's and selective_scan's
#: are checked against their launches by design in phases 26 and 27; the
#: others name theirs in
#: their rows: the attention kernels by design(), the histogram, the clip
#: and the two threshold solves by the launches of their main path, the
#: tree automata's kernels by their packages' design names, phase 19, and
#: the FIFO queue its two plans', phase 20)
DESIGNS = {
    "segsum": "whole tree, one launch: a block a tile of 4096 leaves (levels 1-2 in shared "
              "memory), the last block by atomic ticket the levels above; each node one warp, "
              "fixed-order shuffles",
    "slot_automaton": "one block a chunk: the slots spread over its threads in shared memory "
                      "beside their eviction keys, the requests in order, one block-wide argmin "
                      "over (key, slot) a request (redux.sync, one __syncthreads; none on one "
                      "warp); counts a tile of requests at a time",
    "wkv6": "u term factored; a block a (sequence, head), each column's rows cut over P "
            "threads of C columns (n = 64: 8 x 4, 128 threads, 32 state registers a thread); "
            "partials summed over the row blocks in order a 16-step chunk; r, k, w, v staged "
            "by cp.async in a 3-chunk ring",
    "selective_scan": "a thread a channel, its n states (scaled by 2^j at a chunk's step j) and "
                      "row of A log2(e) in registers; 128 channels of one sequence a block, 3 "
                      "blocks an SM; 2 dec one ex2.approx of fma(dt, a', 1), h and y by fmas; x, "
                      "dt, B and C staged by cp.async, 32 steps a chunk in a 2-chunk ring",
}
#: selective_scan's second design, a decode step's (S = 1), which phase 27
#: counts beside the prefill design of DESIGNS
SCAN_STEP_DESIGN = ("a decode step: a thread a channel, every load (state, A, x, dt, D, B, C) "
                    "issued before its arithmetic; the state and A read and written a warp's 32 "
                    "rows at a time through a swizzled shared copy; no block barrier")
#: the design of the standalone apply kernel, which phase 3 times (the dense
#: main path's clip is the projection's epilogue)
APPLY_STANDALONE = "standalone: 16-byte body, 2 float4 of f and c in flight a thread"
DENSE_KERNELS = 23  # device kernels a dense chunk launches (phase 7), its reward summed in float64
#: kernels off the replay paths: serving's attention and recurrence, the scenario
#: path's automata
OFF_PATH = {"flash_prefill": 0, "decode_attention": 0, "slot_automaton": 0, "tree_lru": 0,
            "minpair_automaton": 0, "fifo_queue": 0, "wkv6": 0, "selective_scan": 0,
            "flash_prefill_bwd": 0, "wkv6_bwd": 0}
#: the port's kernels in the profiler's rows, by the names of their functions
PORT_KERNEL_NAMES = ("tree_update_kernel", "tree_build_kernel", "bin_tiles_kernel",
                     "solve_buckets_kernel", "project_warm_kernel", "solve_sized_kernel")
#: device_kernels: profiled calls, and the most while every one shows none
PROFILE_TRIES, PROFILE_MOST_TRIES = 3, 10
FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores, NVIDIA's data sheet
AUTOMATA = ("lru", "fifo", "lfu", "ftpl")
#: phase 16's capacities (and the design's largest), ids a case and launches
AUTOMATON_CS, AUTOMATON_IDS, AUTOMATON_CHUNKS = (25, 250, 1000), 4000, 2
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
FIG8_POLICIES, FIG8_SYNC_CHUNKS = ("ogb", "lru", "lfu", "ftpl", "fifo"), 3
TREE_AUTOMATA = ("lru", "lfu", "ftpl")
#: phase 19's capacities, ids a case after the fill, and the two timed shapes
#: (C: catalog, chunk): quick's and fig8_cdn full's
TREE_CS, TREE_IDS = (23, 1000, 16384, 50000), 20_000
#: the min-pair kernel's capacities at its radix's edges (one level; two of
#: 2; three, the top of 2), and padded slots past its shared-memory
#: pointers (its L2 plan: 20 636 nodes above the leaves)
MINPAIR_EDGE_CS, MINPAIR_L2_SLOTS = (64, 65, 4097), 1_300_000
TREE_TIMED = {1000: (20_000, 10_000), 50000: (1_000_000, 1_000_000)}
#: the int32 tree build's timed leaves: a ring of C = 50 000 (ring_size), and
#: fig8_cdn full's ring (a window of 1e6)
INT32_BUILD_LEAVES = (262_144, 2_097_152)
#: phase 20's capacities of the FIFO queue (from one warp's lanes past the
#: slot kernel's 16 384) and of the GDS mode
FIFO_CS = (25, 1000, 16384, 50000)
#: phase 20's FIFO cases on churn traces (requests that keep the queue's
#: oldest items in play): each side of the tile plan's 32 active slots,
#: padded slots, quick's C (a one-warp tile), 5000 (two warps) and fig8_cdn
#: full's (eight); requests after the fill
FIFO_CHURN_CASES, FIFO_CHURN_IDS = ((31, None), (32, None), (31, 40), (32, 40), (1000, None),
                                    (5000, None), (50000, None)), 20_000
#: fig8_cdn full's FIFO hits (hit ratio 0.51661145 of 2e7), as the earlier
#: designs of the FIFO queue gave them
FIG8_FIFO_HITS = 10_332_229
#: sized_cdn full's rows as the earlier designs printed them (hit ratio, byte hit
#: ratio): the kernels on its path are bit for bit their plain versions
SIZED_FULL_ROWS = {
    "OGB_sized_tree": (0.47094605, 0.1526340598879972),
    "GDS": (0.5871178, 0.13628431225493215),
    "LRU": (0.553772, 0.13982521164859485),
    "LFU": (0.65334045, 0.15042566423160866),
    "FTPL": (0.63125105, 0.15018568524726408),
    "OPT(static)": (0.6621757, 0.274805157402888),
}
#: the sized scenario, and the chunks of its full run before the state that
#: phase 20 records a chunk of
SIZED = "sized_cdn"
SIZED_RECORD_CHUNKS = 200
#: phase 21's OGB_sized_tree chunks timed, and as many profiled, after
#: SIZED_RECORD_CHUNKS
SIZED_PROFILE_CHUNKS = 200
#: phase 22, the sweep: dense ogb over the main trace's first SWEEP_T
#: requests at these capacities, etas (Theorem 3.1's at each capacity, and
#: these multiples of its value at C) and seeds; the automata over fig8_cdn
#: full's first SWEEP_AUTOMATA_T requests at theirs, at the largest's slots
SWEEP_T, SWEEP_CS, SWEEP_ETA_SCALES, SWEEP_SEEDS = 1_000_000, (12_500, 25_000, 50_000), \
    (0.5, 2.0), (0, 1)
SWEEP_AUTOMATA_T, SWEEP_AUTOMATA_CS = 10_000_000, (6_250, 12_500, 25_000, 50_000)
#: the automata's grids timed chunk by chunk beside their one-combo launches
SWEEP_TIMED_ROWS = 4


#: phase 23: the edge-fleet scenario, the tenants checked against their own
#: runs in (b) and (c), and (c)'s tenants
EDGE = "edge_fleet_cdn"
FLEET_CHECKED, FLEET_SMALL = (0, 85, 170, 255), 32


class Failed(Exception):
    pass


def need(cond, what):
    if not cond:
        raise Failed(what)


def cpu_result(future, timeout=900):
    """A CPU worker's result, and the seconds the card's phase waited for it."""
    t0 = time.perf_counter()
    out = future.result(timeout=timeout)
    return out, time.perf_counter() - t0


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
    expected = f" (expected {DENSE_KERNELS})" if kind == "ogb" else ""
    rows, out = profiled_chunks(torch, prof, PROFILE_CHUNKS, f"breakdown {kind}{expected}",
                                plain.wall_seconds, profiled.wall_seconds)
    accumulate = [e.key for e in rows if "indexing_backward" in e.key]
    if kind == "ogb_tree":
        sorts = sum(e.self_device_time_total for e in rows if "RadixSort" in e.key)
        print(f"  PyTorch's accumulate: {len(accumulate)} rows; radix sorts "
              f"{sorts / PROFILE_CHUNKS:.2f} us/chunk")
        need(not accumulate, f"ogb_tree still runs PyTorch's accumulate: {accumulate}")
    return out


def profiled_chunks(torch, prof, chunks, label, wall_s, profiled_wall_s):
    """Phases 7, 11 and 21: a profiled run of ``chunks`` chunks, a chunk at
    a time: device busy us and kernels, wall us (of the same run
    unprofiled, ``wall_s``) and idle share, the top kernels and the port's
    kernels by name, printed.  Returns (the profiler's device rows, the
    numbers)."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / chunks
    launches = sum(e.count for e in rows) / chunks
    wall_us, prof_wall_us = wall_s * 1e6 / chunks, profiled_wall_s * 1e6 / chunks
    need(busy_us > 0, f"{label}: the profiler saw no device time")
    print(f"{label}, {chunks} chunks: wall {wall_us:.1f} us/chunk (profiled {prof_wall_us:.1f}), "
          f"device busy {busy_us:.1f} us/chunk, {launches:.1f} device kernels/chunk, device idle "
          f"share {1 - busy_us / wall_us:.3f} (profiled {1 - busy_us / prof_wall_us:.3f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / chunks:8.2f} us/chunk "
              f"{e.count / chunks:6.2f}/chunk  {e.key[:90]}")
    ours = {}
    for e in rows:
        name = next((k for k in PORT_KERNEL_NAMES if k in e.key), None)
        if name:
            us, per = e.self_device_time_total / chunks, e.count / chunks
            mine = ours.setdefault(name, {"us_a_chunk": 0.0, "launches_a_chunk": 0.0})
            mine["us_a_chunk"] += us
            mine["launches_a_chunk"] += per
    for name, r in ours.items():
        print(f"  port kernel {name}: {r['us_a_chunk']:.2f} us/chunk, "
              f"{r['launches_a_chunk']:.2f} launches/chunk")
    return rows, {"wall_us_a_chunk": wall_us, "busy_us_a_chunk": busy_us,
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


def check_tree_sums(torch, dev, carry, trace, one_level):
    """Phase 3, the tree's two sums: the whole-tree build and the batched
    tree update, against their plain versions (and the build against the
    per-level design it replaced, bit for bit), then timings.  The update at
    a real chunk's three calls and at a run of 2000 deltas under one node.
    ``one_level`` is the one-level segsum kernel's row, kept in the build's."""
    from repro_torch.kernels.prefix_tree.ops import tree_build, tree_storage, tree_update_
    from repro_torch.kernels.prefix_tree.ref import tree_build_ref, tree_update_ref
    from tools.time_tree_updates import EARLIER_DESIGN, ogb_tree_cases, time_updates

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

    # the update at a real chunk's three calls, a run of 2000 under one node
    # and the same in input order: its checks, then beside its earlier plan
    # (tools/time_tree_updates.py: bit for bit, timed in turns)
    cases = ogb_tree_cases(torch, dev, record_chunk_updates(trace, carry))
    for label, (tree, n, radix, _, idx, delta) in cases.items():
        got = tree_update_(tree.clone(), n, radix, idx, delta)
        need(torch.equal(got, tree_update_ref(tree.clone(), n, radix, idx, delta)),
             f"tree_update {label} differs from its plain version on the card")
        cpu = tree_update_ref(tree.to("cpu", copy=True), n, radix, idx.cpu(), delta.cpu())
        need(torch.equal(got.cpu(), cpu), f"tree_update {label} differs from the CPU's")
        work = tree.clone()
        kernels = device_kernels(torch, lambda: tree_update_(work, n, radix, idx, delta))
        need(kernels == 1, f"tree_update {label}: {kernels} device kernels a call, not 1")
    updates = time_updates(torch, dev, flush, cases)
    slower = [k for k, r in updates.items() if r["ms"] > r["earlier_ms"]]
    print(f"tree_update, the one-tree path: every case bit for bit the plain version on the card "
          f"and the CPU, 1 device kernel a call; cold against the earlier plan: "
          + ", ".join(f"{k} {r['ms'] * 1e3:.2f} ({r['earlier_ms'] * 1e3:.2f})"
                      for k, r in updates.items())
          + f" us; slower than the earlier plan at {slower or 'no case'}")
    del flush_buf
    row = {**updates["ogb_tree ysum"], "tree": "ysum, a real chunk's",
           "calls": {k: {x: y for x, y in v.items() if x != "runs_ms"}
                     for k, v in updates.items() if k != "ogb_tree ysum"},
           "earlier_design": EARLIER_DESIGN}
    row.pop("runs_ms")
    return {"segsum": segsum, "tree_update": row}


def check_tree_main_path(trace, eta):
    """Phase 8: the lazy main path, every launch and host read counted."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.prefix_tree.ops import UPDATE_DESIGN, WHOLE_TREE

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
    need(designs["tree_update"] == {UPDATE_DESIGN: 3 * m},
         f"ogb_tree tree_update designs {designs['tree_update']}")
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
    part = trace[: TREE_RESUME_CHUNKS * W]
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
    print(f"ogb_tree: two runs of {TREE_RESUME_CHUNKS} chunks equal, and two calls equal one, "
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


def attention_jobs(torch, dev, H, Hkv, D, seed):
    """Timed jobs of the two attention kernels in bf16 at heads (H, Hkv, D):
    ``decode(B, S, lengths)`` and ``prefill(B, S)`` each give (kernel,
    plain version, one scaled_dot_product_attention call, its bound), and
    print the kernel's distance from that call."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def decode(B, S, lengths):
        q, k, v = randn(B, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        qd, kd, vd = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, enable_gqa=True)[:, :, 0]
        print(f"decode B={B} S={S} H={H} Hkv={Hkv} D={D}: max |kernel - "
              f"scaled_dot_product_attention| = "
              f"{float((decode_attention(q, k, v, lengths).float() - lib.float()).abs().max()):.3e}")
        # K and V of every valid position read once, q read and out written once;
        # 4 operations per (query head, position, dim): the two dot products
        valid = int(lengths.sum())
        n_bytes = 2 * 2 * valid * Hkv * D + 2 * 2 * B * H * D + 4 * B
        return (lambda: decode_attention(q, k, v, lengths),
                lambda: decode_attention_ref(q, k, v, lengths),
                lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, enable_gqa=True),
                bound_ms(n_bytes, 4 * valid * H * D, BF16_OPS_PER_S))

    def prefill(B, S):
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        print(f"prefill B={B} S={S} H={H} Hkv={Hkv} D={D}: max |kernel - "
              f"scaled_dot_product_attention| = "
              f"{float((flash_prefill(q, k, v).float() - lib.transpose(1, 2).float()).abs().max()):.3e}")
        # 4 B H (S^2 / 2) D operations over the bf16 tensor-core peak
        n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        return (lambda: flash_prefill(q, k, v),
                lambda: flash_prefill_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                bound_ms(n_bytes, 4 * B * H * (S * S / 2) * D, BF16_OPS_PER_S))

    return decode, prefill


def measure_attention(torch, name, label, job, plain_reps, flush):
    """One attention job cold and warm in L2, beside its plain version and
    the library call, printed; the row's numbers."""
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


def l2_flush(torch, dev):
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    return flush_buf.zero_


def time_attention_kernels(torch, dev, errs):
    """Phase 13: each attention kernel in bf16, cold and warm in L2, beside
    its plain version, one scaled_dot_product_attention call (timed as a
    yardstick only: the port never calls it) and its bound, at glm4-9b's
    long shapes and at the shapes the served model launches it."""
    from repro_torch.kernels.decode_attention.kernel import design as decode_design
    from repro_torch.kernels.flash_prefill.kernel import design as prefill_design

    bf, D = torch.bfloat16, 128
    decode_job, prefill_job = attention_jobs(torch, dev, 32, 2, D, 4)
    flush = l2_flush(torch, dev)

    def measure(name, label, job, plain_reps):
        return measure_attention(torch, name, label, job, plain_reps, flush)

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
    for name, row in time_served_attention(torch, dev, decode_job, prefill_job, measure).items():
        rows[name].update(row)
    sweep_decode_splits(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def time_served_attention(torch, dev, decode_job, prefill_job, measure):
    """Both attention kernels at a served model's shapes: a prefill of
    SERVE_B prompts of SERVE_S tokens, and a decode step over the SERVE_S +
    SERVE_NEW cache, lengths SERVE_S + 1 .. (phases 13 and 24)."""
    S = SERVE_S + SERVE_NEW
    served = torch.arange(SERVE_S + 1, SERVE_S + 1 + SERVE_B, device=dev,
                          dtype=torch.int32).clamp(max=S)
    rows = {"decode_attention": {"serving": {
        "shape": f"B={SERVE_B} S={S} lengths {int(served.min())}..{int(served.max())}",
        **measure("decode_attention", f"serving B={SERVE_B} S={S}",
                  decode_job(SERVE_B, S, served), 10)}}}
    torch.cuda.empty_cache()
    rows["flash_prefill"] = {"serving": {
        "shape": f"B={SERVE_B} S={SERVE_S}",
        **measure("flash_prefill", f"serving B={SERVE_B} S={SERVE_S}",
                  prefill_job(SERVE_B, SERVE_S), 3)}}
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
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, 0, lengths.data_ptr(), B, H, Hkv,
                    D, S,
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


def expected_params(cfg):
    """A model's parameters as init_params draws them: ArchConfig.param_count
    (which counts three matrices an MLP, where a GELU MLP has two), the norms,
    the rows of the vocab's padding, and a vlm's image norm or an encdec's
    learned positions.  An ssm model's blocks are counted leaf by leaf
    (param_count counts an ssm block as Mamba's), and so are a hybrid
    model's (param_count leaves out a Mamba layer's w_dt, convolution and
    A_log)."""
    from repro_torch.models.mamba import mamba_params
    from repro_torch.models.model import DEC_POSITIONS, _is_attn_layer, _is_moe_layer, padded_vocab
    from repro_torch.models.rwkv import block_params

    d = cfg.d_model
    if cfg.family == "ssm":
        return 2 * padded_vocab(cfg) * d + d + cfg.n_layers * block_params(cfg)
    if cfg.family == "hybrid":  # a layer: two norms, attention or Mamba, MoE or MLP
        attn = 2 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
        ffn = {True: cfg.n_experts * (3 * d * cfg.expert_ff + d), False: 3 * d * cfg.d_ff}
        layers = [layer % cfg.attn_period for layer in range(cfg.n_layers)]
        return 2 * padded_vocab(cfg) * d + d + sum(
            2 * d + (attn if _is_attn_layer(cfg, j) else mamba_params(cfg))
            + ffn[_is_moe_layer(cfg, j)] for j in layers)
    n = cfg.param_count() + 2 * (padded_vocab(cfg) - cfg.vocab_size) * d + d
    if cfg.mlp_activation == "gelu":
        n -= (cfg.n_layers + cfg.n_encoder_layers) * d * cfg.d_ff
    if cfg.family == "encdec":
        return (n + (2 * cfg.n_encoder_layers + 3 * cfg.n_layers + 1) * d
                + (cfg.n_audio_frames + DEC_POSITIONS) * d)
    return n + 2 * cfg.n_layers * d + (d if cfg.family == "vlm" else 0)


def draw_full_width(torch, dev, arch, cfg=None):
    """``arch`` at full width and depth (or ``cfg``, a depth cut of it),
    random bf16 weights drawn on the card, its parameter count held to the
    configuration's."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import init_params

    full = get_arch(arch)
    cfg = cfg or full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    experts = (f", {cfg.n_experts} experts of {cfg.expert_ff} top-{cfg.experts_per_token}"
               if cfg.n_experts else "")
    encoder = f", {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else ""
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of {cfg.rwkv_head_dim}, no KV cache"
             if cfg.family == "ssm" else f"heads {cfg.n_heads} / KV {cfg.n_kv_heads}, head_dim "
             f"{cfg.head_dim}, KV cache {cfg.kv_cache_dtype}")
    if cfg.family == "hybrid":
        heads += (f", attention 1 layer in {cfg.attn_period}, Mamba d_in "
                  f"{cfg.ssm_expand * cfg.d_model} state {cfg.ssm_state_dim} conv "
                  f"{cfg.ssm_conv_width}, MoE every {cfg.moe_every} from {cfg.moe_offset}")
    counted = (f"{cfg.family} layers leaf by leaf + embeddings"
               if cfg.family in ("ssm", "hybrid") else
               f"ArchConfig.param_count {cfg.param_count()} + norms + vocab padding"
               f"{' + positions' if encoder else ''}")
    cut = (f" (depth cut from {full.n_layers} layers at attn_period {full.attn_period})"
           if cfg.n_layers != full.n_layers else "")
    print(f"{arch}: {cfg.n_layers} layers{cut}{encoder}, d_model {cfg.d_model}, {heads}, d_ff "
          f"{cfg.d_ff}{experts}, vocab {cfg.vocab_size}; {n_params} parameters ({counted}) "
          f"drawn in bf16 on the card in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated")
    need(n_params == expected_params(cfg), f"the model is not {arch}'s full width")
    return cfg, params


def serve_full_width(torch, dev, arch=ARCH, calls=SERVE_CALLS, cfg=None):
    """Phase 14 (and 24 (a), 25 (a), 26 (b), 27 (b)): ``arch`` at full width
    (``cfg``, where given, a depth cut of it) behind an OGB page pool,
    ``calls`` generate calls, every kernel launch counted.  Returns the
    engine, the first call's prompts and tokens, the launches, and the
    steady calls' numbers."""
    import numpy as np

    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool

    cfg, params = draw_full_width(torch, dev, arch, cfg)
    pages = SERVE_S // PAGE_SIZE
    policy = make_policy("ogb", 1 << 18, POOL_PAGES, horizon=calls * SERVE_B * pages,
                         batch_size=SERVE_B * pages)
    pool = PagedKVPool(policy, page_size=PAGE_SIZE)
    engine = ServeEngine(cfg, params, pool=pool, max_len=SERVE_S + SERVE_NEW, device=dev)
    print(f"page pool: OGB over 2^18 page ids, {POOL_PAGES} pages of {PAGE_SIZE} tokens, "
          f"eta {policy.eta:.6f}, horizon {calls * SERVE_B * pages} page touches, "
          f"batch {SERVE_B * pages}")
    rng = np.random.default_rng(0)
    hot = [rng.integers(1, cfg.vocab_size, SERVE_S) for _ in range(HOT_PROMPTS)]
    reset_launch_counts()
    batches, outs, steady = [], [], []
    for step in range(calls):
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
    if cfg.family == "ssm":  # the recurrence: a launch a layer in a prefill and in a step
        want["wkv6"] = cfg.n_layers * (1 + SERVE_NEW) * calls
    elif cfg.family == "hybrid":  # the scan a Mamba layer, attention a super-block
        attn = cfg.n_layers // cfg.attn_period
        want["selective_scan"] = (cfg.n_layers - attn) * (1 + SERVE_NEW) * calls
        want["flash_prefill"] = attn * calls
        want["decode_attention"] = attn * SERVE_NEW * calls
    else:
        want["flash_prefill"] = cfg.n_layers * calls
        want["decode_attention"] = cfg.n_layers * SERVE_NEW * calls
    wp = sum(w for w, _ in steady) / len(steady)
    wd = sum(w for _, w in steady) / len(steady)
    print(f"serving, calls 2-{calls}: prefill {SERVE_B * SERVE_S / wp:.1f} tokens/s, "
          f"decode {wd * 1e3 / SERVE_NEW:.3f} ms a step, {SERVE_B * SERVE_NEW / wd:.2f} tokens/s; "
          f"peak memory {peak / 1e9:.3f} GB (max_memory_allocated); prefix reuse "
          f"{engine.stats.prefix_reuse:.6f}, page hit ratio {pool.stats.page_hit_ratio:.6f}, "
          f"pool stats {pool.stats}; launches {launches} (a decode_attention launch is its "
          f"split pass and its combine pass together)")
    need(launches == want, f"serving launches {launches}, expected {want}")
    need(engine.stats.prefix_reuse > 0 and pool.stats.page_hit_ratio > 0,
         "the page pool reused nothing by the last call")
    steady = {"prefill_s": wp, "decode_ms_a_step": wd * 1e3 / SERVE_NEW,
              "peak_memory_gb": peak / 1e9, "prefix_reuse": engine.stats.prefix_reuse,
              "page_hit_ratio": pool.stats.page_hit_ratio}
    return engine, batches[0], outs[0], launches, steady


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


def _prefill_f64(q, k, v, causal=True):
    """GQA attention in float64, one sequence at a time: what the float32
    plain version approximates, for a yardstick of how far the served
    model's logits move when attention is rounded differently."""
    import torch

    B, S, H, D = q.shape
    g = H // k.shape[2]
    future = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device).triu(1)
    out = torch.empty_like(q)
    for b in range(B):
        kf = k[b].double().repeat_interleave(g, dim=1)
        vf = v[b].double().repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kf) / math.sqrt(D)
        if causal:
            s.masked_fill_(future, -1e30)
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), vf).to(q.dtype)
    return out


def bf16_ulp(x):
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def held_logits(torch, label, a, b, V):
    """Logits within 8 bf16 ulps of the largest |logit|: each layer's
    attention output may round one ulp apart, and 40 layers carry it.
    Returns the error and the limit."""
    a, b = a[:, :V].float(), b[:, :V].float()
    top = float(b.abs().max())
    tol = 8 * bf16_ulp(top)
    err = float((a - b).abs().max())
    print(f"{label}: max |logit kernels - plain| = {err:.4e} (limit {tol:.4e}, 8 bf16 ulps of "
          f"the largest |logit| {top:.4f})")
    need(bool(torch.isfinite(a).all()) and err <= tol, f"{label}: logits differ by {err}")
    return err, tol


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

    tol = held_logits(torch, "prefill, last token", lk, lp, V)[1]
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
        held_logits(torch, f"decode step {step + 1}, teacher-forced", lk, lp, V)
        tok = torch.argmax(lk[:, :V], -1)
    again = engine.generate(prompts, SERVE_NEW)
    need(np.array_equal(again, first_out), "two generate calls on equal prompts differ")
    print(f"two generate calls on equal prompts: equal tokens ({again.size})")


# -- the scenario path (phases 16-18) ---------------------------------------

def cpu_quick_rows(name):
    """Phase 17's and 21's CPU side, in a worker process: ``run_scenario``
    at quick on the CPU (every kernel's plain version), the device rows only
    (the sized scenario's are all device rows)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    from repro_torch.cachesim.scenarios import run_scenario

    policies = None if name == SIZED else DEVICE_POLICIES
    return run_scenario(name, "quick", policies=policies, device="cpu").rows


def start_cpu_quick():
    """Start phase 17's and 21's CPU runs, one worker process a scenario
    (spawned: no CUDA in them), so that they overlap the card's phases."""
    import concurrent.futures
    import multiprocessing

    names = SCENARIO_NAMES + (SIZED,)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(names) + 1, mp_context=multiprocessing.get_context("spawn"))
    futures = {name: pool.submit(cpu_quick_rows, name) for name in names}
    futures[EDGE] = pool.submit(cpu_edge_quick)
    return pool, futures


def cpu_edge_quick():
    """Phase 23's CPU side, in a worker process: edge_fleet_cdn at quick on
    the CPU; the edges' hits and the origin's per-chunk arrays."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    from repro_torch.cachesim.fleet import run_edge_fleet_scenario

    ef = run_edge_fleet_scenario(EDGE, "quick", device="cpu")
    return {"edge_hits": ef.edges.hits, "origin_requests": ef.origin_requests,
            "origin": {k: getattr(ef.origin, k) for k in ("hits", "reward", "aux", "T")}}


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
    launch a chunk of each automaton row (fifo_queue for FIFO, tree_lru
    for LRU, minpair_automaton for LFU, FTPL and GDS), the LRU's possible
    ring compactions (a compaction launch and an int32 tree build each), the
    OGB and OMD rows' histogram, mass and apply launches, and OGB_sized's
    three stacked tree updates, sized solve and histogram a chunk (and its
    3K tree builds at init)."""
    from repro_torch.cachesim.scenarios import get_scenario, run_scenario
    from repro_torch.cachesim.tree_engines import ring_for_window
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.minpair_automaton.ops import DESIGN_GDS
    from repro_torch.kernels.prefix_tree.kernel import SIZED_DESIGN

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
    sized = "ogb_sized" in kinds
    classes = len(set(sc.make_sizes(scale).tolist())) if sized else 0
    want = {k: 0 for k in got}
    want.update({"fifo_queue": rows * ("fifo" in kinds),
                 "tree_lru": (rows + comp) * ("lru" in kinds),
                 "minpair_automaton": rows * (("lfu" in kinds) + ("ftpl" in kinds)
                                              + ("gds" in kinds)),
                 "segsum": comp + 3 * classes,
                 "histogram": chunks * (("ogb" in kinds) + ("omd" in kinds) + sized),
                 "mass": chunks * ("ogb" in kinds), "apply": chunks * ("ogb" in kinds),
                 "tree_update": 3 * chunks * sized, "bucket_mass": chunks * sized})
    need(got == want, f"{name} {scale}: launches {got}, expected {want}")
    designs = design_counts()
    need(designs.get("minpair_automaton", {}).get(DESIGN_GDS, 0) == rows * ("gds" in kinds)
         and designs.get("bucket_mass", {}).get(SIZED_DESIGN, 0) == chunks * sized,
         f"{name} {scale}: the GDS mode or the sized solve did not run once a chunk: {designs}")
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
    total, waited = {}, 0.0
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
        cpu, secs = cpu_result(cpu_futures[name])
        waited += secs
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
    print(f"quick scenarios' launches: {total}; {waited:.2f} s waiting on the CPU runs")
    return total


def check_paper_scale(torch):
    """Phase 18: fig2_adversarial at full (every row, ARC too) and
    fig8_cdn at full for OGB, the tree LRU, LFU and FTPL and FIFO."""
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
    r = res.rows["OGB"]
    need(math.isfinite(r["regret"]) and 0.0 < r["hit_ratio"] < 1.0, f"fig8 full OGB: {r}")
    for p in ("LRU", "LFU", "FTPL"):
        need(0.0 < res.rows[p]["hit_ratio"] < 1.0, f"fig8 full {p}: {res.rows[p]}")
    need(res.rows["OGB"]["hit_ratio"] >= FIG8_OGB_FLOOR * opt,
         f"fig8 full: OGB {res.rows['OGB']['hit_ratio']} below {FIG8_OGB_FLOOR} OPT(static) {opt}")
    need(res.rows["OGB"]["hit_ratio"] > res.rows["LRU"]["hit_ratio"],
         f"fig8 full: OGB {res.rows['OGB']['hit_ratio']} not above LRU "
         f"{res.rows['LRU']['hit_ratio']} (benchmarks/fig7_8_traces.py:57)")
    need(min(launches[k] for k in ("tree_lru", "minpair_automaton", "segsum", "fifo_queue")) > 0,
         f"fig8 full: a tree kernel or the FIFO queue was not launched: {launches}")
    need(0.0 < res.rows["FIFO"]["hit_ratio"] < opt, f"fig8 full FIFO: {res.rows['FIFO']}")
    need(round(res.rows["FIFO"]["hit_ratio"] * t) == FIG8_FIFO_HITS,
         f"fig8 full FIFO: {res.rows['FIFO']['hit_ratio']} is not {FIG8_FIFO_HITS} hits of {t}")
    print(f"fig8_cdn full: OPT(static) {opt}; OGB at least {FIG8_OGB_FLOOR} of it and above LRU "
          f"(Fig. 8-left, benchmarks/fig7_8_traces.py:57): met ({wall:.2f} s); launches "
          f"{launches} (segsum: int32 tree builds, one a ring compaction)")
    check_no_host_reads(torch, trace, n, c, max(t // 20, 1), TREE_AUTOMATA + ("fifo",))
    return launches


def check_no_host_reads(torch, trace, n, c, window, kinds, label="fig8 full", **init_kw):
    """Phases 18 and 21: FIG8_SYNC_CHUNKS chunks of each of ``kinds``, from a
    started run, under torch's sync debug mode "error": a read of the device
    (or a blocking copy to it) in a chunk raises."""
    from repro_torch import policy_def
    from repro_torch.cachesim.tree_engines import ring_for_window

    chunks = torch.from_numpy(trace[:FIG8_SYNC_CHUNKS * window].astype("int32")).to(
        "cuda").reshape(FIG8_SYNC_CHUNKS, window)
    for kind in kinds:
        pd = policy_def(kind)
        ring = {"ring": ring_for_window(c, window)} if kind == "lru" else {}
        carry = pd.start(pd.init(n, c, horizon=len(trace), **ring, **init_kw), n)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(FIG8_SYNC_CHUNKS):
                carry, out = pd.step(carry, chunks[i])
        except RuntimeError as exc:
            raise Failed(f"{label} {kind}: a chunk read the device: {exc}") from exc
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"{label}: {FIG8_SYNC_CHUNKS} chunks of {window} requests of each of "
          f"{', '.join(k.upper() for k in kinds)} under sync debug mode 'error': 0 host reads in "
          f"a chunk")


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
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.kernels import design_counts, reset_launch_counts
    from repro_torch.kernels.minpair_automaton.ops import DESIGN, DESIGN_L2
    from repro_torch.kernels.prefix_tree.ops import leaves_for_storage, tree_build, tree_storage
    from repro_torch.kernels.prefix_tree.ref import tree_build_ref
    from repro_torch.kernels.tree_lru.ops import CHUNK, ring_compaction
    from tools.time_automaton_designs import EARLIER_DESIGNS, time_designs, timed_start

    cases = [(kind, c, None, None) for kind in TREE_AUTOMATA for c in TREE_CS]
    cases += [(kind, c, c + 37, None) for kind in ("lfu", "ftpl") for c in (23, 1000)]
    cases += [("lru", c, None, ring) for c, ring in ((23, 256), (1000, 4096))]
    cases += [(kind, c, None, None) for kind in ("lfu", "ftpl") for c in MINPAIR_EDGE_CS]
    cases += [(kind, 1000, MINPAIR_L2_SLOTS, None) for kind in ("lfu", "ftpl")]
    err, n_hits = 0.0, 0
    reset_launch_counts()
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
    plans = design_counts()["minpair_automaton"]
    need(set(plans) == {DESIGN, DESIGN_L2} and plans[DESIGN_L2] > 0,
         f"the min-pair kernel's plans: {plans}")
    print(f"tree automata: {len(cases)} cases (LRU, LFU, FTPL at C in {TREE_CS}, padded LFU "
          f"and FTPL, LRU with a ring of 4C: forced compactions; LFU and FTPL at C in "
          f"{MINPAIR_EDGE_CS} and with {MINPAIR_L2_SLOTS} slots, its pointers in L2), C "
          f"distinct ids filling the slots, then {TREE_IDS} ids: hits, stats and every carry "
          f"leaf bit for bit against the plain version on the card and the CPU ({n_hits} "
          f"hits, max abs err {err}); every case evicts; min-pair launches by plan {plans}")

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

    # each kernel and its earlier design, cold, from a full carry at both
    # timed shapes (tools/time_automaton_designs.py), then a due compaction
    timed = time_designs(torch, dev, TREE_AUTOMATA, flush)
    err = max([err] + [row["max_abs_err"] for row in timed.values()])
    compaction = {}
    for c, (n, w) in TREE_TIMED.items():
        card, _ = timed_start(torch, "lru", c, n, w, dev)
        m = leaves_for_storage(card.tree.numel(), 16)
        card.pos.fill_(m - w + 1)  # a due compaction at this shape
        saved = [x.clone() for x in tree_tensors(card)]

        def compact(card=card, m=m, w=w):
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
              "minpair_automaton": "a chain of dependent events (admitted misses, hits on "
                                   "their group's least leaf), each ~3 warp-wide reductions "
                                   "a level, between segments of requests applied at once"}
    for name, kinds in (("tree_lru", ("lru",)), ("minpair_automaton", ("lfu", "ftpl"))):
        main = timed[kinds[0], 50000]
        rows[name] = {
            "ms": main["ms"], "earlier_ms": main["earlier_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_note": f"latency-bound: {chains[name]}", "library_ms": None,
            "max_abs_err": err, "earlier_design": EARLIER_DESIGNS[name],
            "timed": f"{kinds[0]} at fig8_cdn full's shape from a full carry: C=50000, "
                     f"N={TREE_TIMED[50000][0]}, a chunk of {TREE_TIMED[50000][1]}",
            "by_case": {f"{k} C={c}": timed[k, c] for k in kinds for c in TREE_TIMED},
        }
    rows["tree_lru"]["compaction_ms"] = compaction
    rows["tree_lru"]["design"] = CHUNK
    rows["minpair_automaton"]["design"] = DESIGN
    rows["minpair_automaton"]["plans_phase19"] = plans
    return rows, build


# -- the sized axis's kernels (phase 20) and the sized scenario (phase 21) ------

def fifo_tensors(carry):
    """A FIFO run carry's tensors: the carry's and its queue's."""
    return (*carry[:3], *carry.queue)


def fifo_copy(carry, dev):
    from repro_torch.cachesim.engines import FIFORunCarry
    from repro_torch.kernels.fifo_queue.ref import FIFOQueue

    return FIFORunCarry(*(x.to(dev, copy=True) for x in carry[:3]),
                        FIFOQueue(*(x.to(dev, copy=True) for x in carry.queue)))


def fifo_bytes(torch, ids, hits):
    """Bytes one FIFO chunk must move: the ids read, each distinct requested
    item's ticket read once, and for each miss the victim's order entry
    read and its slot, stamp and the item's ticket written; the clock,
    head, misses and occupancy read and written, and the three outputs."""
    misses = ids.numel() - hits
    return 4 * ids.numel() + 4 * torch.unique(ids).numel() + 16 * misses + 32 + 16


def fifo_churn_trace(n, c, length, seed):
    """C distinct ids (admitted in order), then ``length`` requests that keep
    the queue's oldest items in play: new ids, ids admitted about C misses
    ago (at the queue's head, or just evicted) and repeats of the last few;
    a tile then evicts items that it requests again."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.random(length)
    out, nxt = list(range(c)), c
    for x in u:
        if x < 0.4:
            out.append(nxt % n)
            nxt += 1
        elif x < 0.75:
            out.append(int(rng.integers(max(0, nxt - c - 40), max(1, nxt - c + 40))) % n)
        else:
            out.append(out[-1 - int(rng.integers(0, 8))])
    return np.asarray(out, dtype="int32")


def gds_copy(carry, dev):
    return type(carry)(*(x.to(dev, copy=True) for x in carry))


def gds_bytes(torch, before, after, ids):
    """Bytes one GDS chunk must move: the ids read, each distinct requested
    item's imap and cost/size read once, each changed imap, slot and H entry
    written, each changed tree node read and written (two trees)."""
    n_bytes = 4 * ids.numel() + 8 * torch.unique(ids).numel() + 8
    for name in ("imap", "slots", "hval"):
        n_bytes += 4 * int((getattr(before, name) != getattr(after, name)).sum())
    changed = (before.tree_hi != after.tree_hi) | (before.tree_lo != after.tree_lo)
    return n_bytes + 16 * int(changed.sum())


def sized_state(torch):
    """A mid-run OGB_sized_tree carry at sized_cdn full's shape (N = 1e6,
    C = 50 000, its byte budget and sizes) after SIZED_RECORD_CHUNKS chunks
    of zipf(0.9) on the card, and the three stacked tree updates and the
    sized solve of the next chunk, recorded (inputs cloned before each)."""
    from repro_torch import policy_def, run
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.cachesim.scenarios import get_scenario
    from repro_torch.cachesim.traces import zipf

    sc = get_scenario(SIZED)
    n, _, c = sc.dims("full")
    sizes, cap = sc.make_sizes("full"), sc.byte_capacity("full")
    trace = zipf(n, (SIZED_RECORD_CHUNKS + 1) * 1000, alpha=0.9, seed=sc.trace_seed)
    pd = policy_def("ogb_sized")
    res = run(pd, trace[:SIZED_RECORD_CHUNKS * 1000], n, cap, window=1000, sizes=sizes,
              horizon=sc.dims("full")[1])
    carry = res.carry
    calls = {"update": [], "solve": []}
    update, solve = tt.stacked_tree_update_, tt.solve_sized

    def spy_update(trees, v, radix, rows, idx, delta):
        calls["update"].append((trees.clone(), v, radix, rows.clone(), idx.clone(), delta.clone()))
        return update(trees, v, radix, rows, idx, delta)

    def spy_solve(ycnt, ysum, v, s_, cap_, lo, hi, iters):
        calls["solve"].append((ycnt.clone(), ysum.clone(), v, s_.clone(), cap_.clone(), lo.clone(),
                               hi.clone(), iters))
        return solve(ycnt, ysum, v, s_, cap_, lo, hi, iters)

    tt.stacked_tree_update_, tt.solve_sized = spy_update, spy_solve
    try:
        ids = torch.from_numpy(trace[SIZED_RECORD_CHUNKS * 1000:].astype("int32")).to("cuda")
        pd.step(carry, ids)
    finally:
        tt.stacked_tree_update_, tt.solve_sized = update, solve
    need(len(calls["update"]) == 3 and len(calls["solve"]) == 1,
         f"a sized chunk made {len(calls['update'])} tree updates and {len(calls['solve'])} solves")
    return calls


def check_sized_kernels(torch, dev):
    """Phase 20: the FIFO queue, the GDS mode, the stacked tree update (and
    the int32 one) and the sized solve against their plain versions, bit for
    bit on the card and against the CPU; their times cold beside their
    bounds and plain versions."""
    import numpy as np

    from repro_torch.cachesim import engines as teng
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.kernels import design_counts
    from repro_torch.kernels.fifo_queue.ops import DESIGN as FIFO_TILE
    from repro_torch.kernels.fifo_queue.ops import DESIGN_CHAIN as FIFO_CHAIN
    from repro_torch.kernels.fifo_queue.ops import fifo_queue
    from repro_torch.kernels.fifo_queue.ref import fifo_queue_ref
    from repro_torch.kernels.minpair_automaton.ops import DESIGN_GDS
    from repro_torch.kernels.minpair_automaton.ref import gds_automaton_ref
    from repro_torch.kernels.prefix_tree.kernel import SIZED_DESIGN, read_sized_tally
    from repro_torch.kernels.prefix_tree.ops import stacked_tree_update_, tree_update_
    from repro_torch.kernels.prefix_tree.ref import solve_sized_ref
    from tools.sweep_threshold_solves import EARLIER_SIZED_DESIGN, time_sized
    from tools.time_automaton_designs import EARLIER_DESIGNS, time_designs
    from tools.time_tree_updates import sized_cases, time_updates

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    def restorer(dst, src):
        def reset():
            for x, x0 in zip(dst, src):
                x.copy_(x0)
        return reset

    rng = np.random.default_rng(20)
    rows = {}
    # (a) the FIFO queue and (b) GDS: every case bit for bit, every case evicting
    n_cases = 0
    fifo_before = dict(design_counts().get("fifo_queue", {}))
    for kind in ("fifo", "gds"):
        cases = [(c, None, False) for c in (FIFO_CS if kind == "fifo" else TREE_CS)]
        cases += [(1000, 1037, False)] if kind == "fifo" else [(23, 60, False),
                                                               (1000, 1037, False)]
        if kind == "fifo":
            cases += [(c, n_slots, True) for c, n_slots in FIFO_CHURN_CASES]
        else:
            cases += [(c, None, False) for c in MINPAIR_EDGE_CS] + [(1000, MINPAIR_L2_SLOTS, False)]
        for c, n_slots, churn in cases:
            if churn:
                n = max(4 * c, 2000)
                trace = fifo_churn_trace(n, c, FIFO_CHURN_IDS, c)
            else:
                n, trace = tree_case_trace(c, c)
            if kind == "fifo":
                cpu = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, n_slots=n_slots,
                                                                 device="cpu"), n)
                copy, tensors = fifo_copy, fifo_tensors
            else:
                sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[rng.integers(0, 4, n)]
                costs = np.asarray([0.5, 1.0, 2.0, 4.0])[rng.integers(0, 4, n)]
                cpu = tt.init_tree_gds_carry(n, c, n_slots, sizes=sizes, costs=costs,
                                             device="cpu")
                copy, tensors = gds_copy, tuple
            card, plain = copy(cpu, dev), copy(cpu, dev)
            ids = torch.from_numpy(trace)
            evicted = 0
            for part in [ids[:c]] + list(ids[c:].split(TREE_IDS // 2)):
                before = set(cpu.slots.tolist())
                if kind == "fifo":
                    got = fifo_queue(card.slots, card.stamps, card.t, card.queue, part.to(dev))
                    want = fifo_queue_ref(plain.slots, plain.stamps, plain.t, plain.queue,
                                          part.to(dev))
                    on_cpu = fifo_queue(cpu.slots, cpu.stamps, cpu.t, cpu.queue, part)
                else:
                    card, got = tt.tree_chunk("gds", card, part.to(dev))
                    want = gds_automaton_ref(plain.imap, plain.prio, plain.hval, plain.L,
                                             plain.slots, plain.tree_hi, plain.tree_lo,
                                             part.to(dev))
                    cpu, on_cpu = tt.tree_chunk("gds", cpu, part)
                e = max_abs_diff(torch, (*got, *tensors(card)), (*want, *tensors(plain)))
                label = f"{kind} C={c} n_slots={n_slots or c}{' churn' if churn else ''}"
                need(e == 0, f"{label}: card differs from the plain version by {e}")
                for a, h in zip((*got, *tensors(card)), (*on_cpu, *tensors(cpu))):
                    need(torch.equal(a.cpu(), h), f"{label}: card differs from the CPU")
                evicted += len(before - set(cpu.slots.tolist()) - {-1, -2})
            need(evicted > 0, f"{kind} C={c}: no eviction")
            if n_slots:
                need(bool((card.slots[c:] == -2).all()), f"{kind} C={c}: an inactive slot written")
            n_cases += 1
    fifo_plans = {d: n - fifo_before.get(d, 0)
                  for d, n in design_counts().get("fifo_queue", {}).items()}
    need(fifo_plans.get(FIFO_TILE, 0) > 0 and fifo_plans.get(FIFO_CHAIN, 0) > 0,
         f"the FIFO cases did not launch both plans: {fifo_plans}")
    print(f"fifo_queue and minpair_automaton's GDS mode: {n_cases} cases (FIFO at C in "
          f"{FIFO_CS} and, on churn traces, {FIFO_CHURN_CASES}; GDS at C in "
          f"{TREE_CS + MINPAIR_EDGE_CS} with dyadic sizes and costs, padded slots, and "
          f"{MINPAIR_L2_SLOTS} slots: its pointers in L2), C distinct ids filling the slots, "
          f"then {TREE_IDS} ids: hits, stats and every carry leaf (FIFO: and the run's queue) "
          f"bit for bit against the plain version on the card and the CPU; every case evicts; "
          f"FIFO launches by plan: tile {fifo_plans.get(FIFO_TILE, 0)}, chain "
          f"{fifo_plans.get(FIFO_CHAIN, 0)}")

    # the FIFO queue and the GDS mode beside their earlier designs
    # (tools/time_automaton_designs.py), cold from a full carry, in turns
    timed = time_designs(torch, dev, ("fifo", "gds"), flush)
    notes = {"fifo": "latency-bound: a round of shared atomics and four block barriers a tile "
                     "of up to 1024 requests, the loads a tile ahead",
             "gds": "latency-bound: a chain of dependent requests on one warp"}
    for kind, name in (("fifo", "fifo_queue"), ("gds", "gds")):
        by_c = {c: row for (k, c), row in timed.items() if k == kind}
        main = by_c[50000]
        rows[name] = {
            "ms": main["ms"], "earlier_ms": main["earlier_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "max_abs_err": max(row["max_abs_err"] for row in by_c.values()),
            "bound_note": notes[kind],
            "timed": f"{kind} at fig8_cdn full's shape from a full carry: C=50000, "
                     f"N={TREE_TIMED[50000][0]}, a chunk of {TREE_TIMED[50000][1]}",
            "by_c": by_c}
    card = nvidia_smi_line()
    print("fifo_queue beside its earlier design, cold from a full carry: "
          + "; ".join(f"C={c} {row['ms']:.4f} ms (earlier {row['earlier_ms']:.4f})"
                      for (k, c), row in timed.items() if k == "fifo") + f" [{card}]")
    rows["gds"].update(design=DESIGN_GDS, earlier_design=EARLIER_DESIGNS["minpair_automaton"])
    rows["fifo_queue"].update(design=FIFO_TILE, chain_design=FIFO_CHAIN,
                              earlier_design=EARLIER_DESIGNS["fifo_queue"],
                              launches_by_plan_phase20=fifo_plans)

    # (c) the stacked tree update at the recorded chunk's three calls (also
    # as K one-tree launches), the int32 update and a stacked call in input
    # order, beside the earlier plan (tools/time_tree_updates.py: bit for
    # bit on the card and the CPU, timed in turns); (d) the sized solve
    calls = sized_state(torch)
    for trees0, v, radix, rws, idx, delta in calls["update"]:
        got = stacked_tree_update_(trees0.clone(), v, radix, rws, idx, delta)
        per_row = trees0.clone()
        for k in range(per_row.shape[0]):
            tree_update_(per_row[k], v, radix, torch.where(rws == k, idx, -1), delta)
        need(torch.equal(per_row, got), "K one-tree updates differ from the stacked update")
    updates = {k: {x: y for x, y in r.items() if x != "runs_ms"}
               for k, r in time_updates(torch, dev, flush,
                                        sized_cases(torch, dev, calls["update"])).items()}
    print(f"stacked and int32 tree updates, cold against the earlier plan: "
          + ", ".join(f"{k} {r['ms'] * 1e3:.2f} ({r['earlier_ms'] * 1e3:.2f})"
                      for k, r in updates.items()) + f" us; each call's K one-tree launches equal "
          f"to its stacked launch [{nvidia_smi_line()}]")
    # the sized solve at the recorded chunk and at built G, beside its
    # earlier design (tools/sweep_threshold_solves.py)
    ycnt, ysum, v, s_, cap_, lo, hi, iters = calls["solve"][0]
    tally = read_sized_tally(dev)
    sized = time_sized(torch, dev, flush, calls["solve"][0])
    after = read_sized_tally(dev)
    plans = {p: after[p] - tally[p] for p in ("few groups", "block")}
    need(min(plans.values()) > 0, f"the sized solve's cases did not take both plans: {plans}")
    t0 = time.perf_counter()
    solve_sized_ref(ycnt[:, :v], ysum[:, :v], s_, cap_, lo, hi, iters)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    main = sized["recorded sized_cdn full chunk"]
    rows["solve_sized"] = {"ms": main["ms"], "earlier_ms": main["earlier_ms"],
                           "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
                           "bound_by": main["bound_by"], "max_abs_err": 0.0, "bit_for_bit": True,
                           "groups": main["groups"], "classes": main["classes"],
                           "iters": iters, "plan": main["plan"],
                           "us_by_steps": main["us_by_steps"], "library_ms": None,
                           "design": SIZED_DESIGN, "earlier_design": EARLIER_SIZED_DESIGN,
                           "launches_by_plan_phase20": plans,
                           "by_case": {k: {x: y for x, y in r.items() if x != "runs_ms"}
                                       for k, r in sized.items()}}
    print(f"sized solve, the recorded chunk: {main['ms'] * 1e3:.2f} us (earlier design "
          f"{main['earlier_ms'] * 1e3:.2f}; 0, 1 and 30 steps "
          + ", ".join(f"{v:.2f}" for v in main["us_by_steps"]["current"].values())
          + f" us); plain on the card {plain_ms:.2f} ms; both plans launched over the cases "
          f"({plans}) [{nvidia_smi_line()}]")
    int32 = updates.pop("int32, scattered")
    rows["stacked_update"] = {**updates["sized_cdn full ycnt"], "calls": updates}
    rows["int32_update"] = int32
    return rows


def check_sized_scenario(torch, cpu_future):
    """Phase 21: sized_cdn at mini against the golden, at quick against the
    CPU, at full with every row."""
    from repro_torch.cachesim.scenarios import get_scenario
    from repro_torch.kernels.prefix_tree.kernel import read_sized_tally, reset_sized_tally

    sc = get_scenario(SIZED)
    res, _, wall = _scenario_launches(SIZED, "mini")
    golden = _golden_rows(SIZED)
    need(res.rows.keys() == golden["rows"].keys(), f"{SIZED} mini: rows {sorted(res.rows)}")
    for policy, entry in golden["rows"].items():
        for metric, want in entry.items():
            if policy == "OGB_sized_tree" and metric != "byte_regret":
                continue  # the Poisson p is the port's own (CPU tests: the reference's)
            got = round(res.rows[policy][metric], 10)
            tol = (GOLDEN_EXACT if metric in ("hit_ratio", "byte_hit_ratio")
                   else max(GOLDEN_FLOAT * golden["T"], abs(want) * 5e-3))
            need(abs(got - want) <= tol, f"{SIZED} mini {policy} {metric}: {got} != {want}")
    print(f"{SIZED} mini on the card ({wall:.2f} s): GDS, LRU, LFU, FTPL and OPT(static) hit and "
          f"byte hit ratios equal to the golden, OGB_sized_tree's byte regret "
          f"{res.rows['OGB_sized_tree']['byte_regret']} (golden "
          f"{golden['rows']['OGB_sized_tree']['byte_regret']})")

    res, got, wall = _scenario_launches(SIZED, "quick")
    cpu, secs = cpu_result(cpu_future)
    print(f"{SIZED} quick: {secs:.2f} s waiting on the CPU run")
    need(res.rows.keys() == cpu.keys(), f"{SIZED} quick: rows {sorted(res.rows)}")
    for policy, row in cpu.items():
        card = res.rows[policy]
        if policy == "OGB_sized_tree":
            for metric in ("hit_ratio", "byte_hit_ratio"):
                need(abs(card[metric] - row[metric]) <= QUICK_HIT_TOL,
                     f"{SIZED} quick {policy} {metric}: card {card[metric]} CPU {row[metric]}")
            need(abs(card["byte_regret"] - row["byte_regret"]) <= 1e-4 * abs(row["byte_regret"]),
                 f"{SIZED} quick {policy} byte regret: card {card['byte_regret']} CPU "
                 f"{row['byte_regret']}")
        else:
            for metric in ("hit_ratio", "byte_hit_ratio"):
                need(card[metric] == row[metric],
                     f"{SIZED} quick {policy} {metric}: card {card[metric]} != CPU {row[metric]}")
    print(f"{SIZED} quick on the card ({wall:.2f} s): "
          + ", ".join(f"{p} {r['hit_ratio']:.4f}/{r['byte_hit_ratio']:.4f}"
                      for p, r in sorted(res.rows.items()))
          + f" (hit/byte hit); equal to the CPU run (automata and OPT exactly, OGB_sized_tree "
          f"within {QUICK_HIT_TOL}); launches {got}")

    n, t, c = sc.dims("full")
    t0 = time.perf_counter()
    trace = sc.make_trace("full")
    sizes, cap = sc.make_sizes("full"), sc.byte_capacity("full")
    print(f"{SIZED} full: trace N={n} T={t} in {time.perf_counter() - t0:.2f} s, C={c}, byte "
          f"budget {cap}, sizes {sorted(set(sizes.tolist()))}")
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_sized_tally(dev)
    res, launches, wall = _scenario_launches(SIZED, "full", trace=trace)
    groups = sized_groups_seen(read_sized_tally(dev), launches["bucket_mass"])
    card = nvidia_smi_line()
    for p, r in sorted(res.rows.items()):
        print(f"{SIZED} full {p}: hit ratio {r['hit_ratio']}, byte hit ratio {r['byte_hit_ratio']}"
              + "".join(f", {k} {r[k]}" for k in ("frac_hit_ratio", "byte_regret",
                                                  "us_per_request") if k in r)
              + (" us a request" if "us_per_request" in r else "") + f" [{card}]")
    for p, r in res.rows.items():
        need(0.0 < r["hit_ratio"] < 1.0 and 0.0 < r["byte_hit_ratio"] < 1.0,
             f"{SIZED} full {p}: {r}")
        need((r["hit_ratio"], r["byte_hit_ratio"]) == SIZED_FULL_ROWS[p],
             f"{SIZED} full {p}: hit and byte hit ratio {r['hit_ratio']}, {r['byte_hit_ratio']} "
             f"are not the recorded {SIZED_FULL_ROWS[p]}")
    print(f"{SIZED} full: every row's hit and byte hit ratio the recorded ones; the sized "
          f"solve's {launches['bucket_mass']} launches met G (groups of 64 buckets holding an "
          f"item) max {groups['max']}, median {groups['median']}: few-groups plan "
          f"{groups['few groups']}, block plan {groups['block']}")
    need(math.isfinite(res.rows["OGB_sized_tree"]["byte_regret"]), f"{SIZED} full OGB_sized_tree")
    pols = [p for p in res.rows if p != "OPT(static)"]
    by_obj = sorted(pols, key=lambda p: -res.rows[p]["hit_ratio"])
    by_byte = sorted(pols, key=lambda p: -res.rows[p]["byte_hit_ratio"])
    flip = by_obj != by_byte and by_obj[0] != by_byte[0]
    print(f"{SIZED} full ({wall:.2f} s): by object hit ratio {by_obj}, by byte hit ratio "
          f"{by_byte}: the ranking flip (byte winner not the object winner) "
          f"{'holds' if flip else 'does not hold'}; launches {launches}")
    w = max(t // 20, 1)
    check_no_host_reads(torch, trace, n, c, w, ("gds",), label=f"{SIZED} full", sizes=sizes)
    check_no_host_reads(torch, trace, n, cap, 1000, ("ogb_sized",), label=f"{SIZED} full",
                        sizes=sizes)
    chunk = sized_breakdown(torch, trace, n, cap, sizes, t)
    return launches, {p: {k: r[k] for k in ("hit_ratio", "byte_hit_ratio", "us_per_request")
                          if k in r} for p, r in res.rows.items()}, flip, groups, chunk


def sized_breakdown(torch, trace, n, cap, sizes, horizon):
    """Phase 21: where an OGB_sized_tree chunk's time goes at sized_cdn
    full, from torch.profiler: a started run takes SIZED_RECORD_CHUNKS
    chunks, then SIZED_PROFILE_CHUNKS timed on the host clock and as many
    more profiled; device kernels a chunk, busy and wall us, idle share, and
    the three stacked tree updates' time in the chunk."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import policy_def

    pd = policy_def("ogb_sized")
    k = SIZED_PROFILE_CHUNKS
    chunks = torch.from_numpy(trace[:(SIZED_RECORD_CHUNKS + 2 * k) * 1000].astype("int32")).to(
        "cuda").reshape(-1, 1000)
    carry = pd.start(pd.init(n, cap, horizon=horizon, sizes=sizes), n)

    def drive(first):
        nonlocal carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, first + k):
            carry, _ = pd.step(carry, chunks[i])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(SIZED_RECORD_CHUNKS):
        carry, _ = pd.step(carry, chunks[i])
    wall = drive(SIZED_RECORD_CHUNKS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = drive(SIZED_RECORD_CHUNKS + k)
    _, out = profiled_chunks(torch, prof, k, f"{SIZED} full OGB_sized_tree chunk", wall, profiled)
    updates = out["port_kernels"].get("tree_update_kernel", {})
    need(updates.get("launches_a_chunk", 0) > 0, "the profiler saw no tree update in the chunk")
    print(f"{SIZED} full OGB_sized_tree: the three stacked tree updates "
          f"{updates['us_a_chunk']:.2f} us a chunk in {updates['launches_a_chunk']:.2f} launches "
          f"[{nvidia_smi_line()}]")
    return out


def sized_groups_seen(tally, launches):
    """The sized solve's tally over a run of ``launches`` solves: its plans'
    launches and the largest and the median G they met."""
    need(tally["few groups"] + tally["block"] == launches,
         f"the sized solve's tally {tally} does not count the run's {launches} launches")
    seen, at, median = sorted(tally["groups"].items()), 0, None
    for g, n in seen:
        at += n
        if median is None and 2 * at >= launches:
            median = g
    return {"few groups": tally["few groups"], "block": tally["block"], "max": seen[-1][0],
            "median": median, "by_groups": dict(seen)}


# -- the sweep (phase 22) --------------------------------------------------------

def _carry_tensors(carry):
    """A carry's tensor leaves, nested carries and queues included."""
    if hasattr(carry, "device") and hasattr(carry, "dtype"):
        return [carry]
    if isinstance(carry, (tuple, list)):
        return [t for x in carry for t in _carry_tensors(x)]
    return []


def _same_carry(torch, a, b):
    ta, tb = _carry_tensors(a), _carry_tensors(b)
    return len(ta) == len(tb) > 0 and all(torch.equal(x, y) for x, y in zip(ta, tb))


def sweep_dense(torch, trace):
    """Phase 22, dense ogb: the 18-combo grid, then its single runs."""
    from repro_torch import policy_def, run, sweep
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts

    trace = trace[:SWEEP_T]
    chunks = SWEEP_T // W
    eta_c = theoretical_eta(C, N, SWEEP_T, 1)
    etas = (None,) + tuple(k * eta_c for k in SWEEP_ETA_SCALES)
    pd = policy_def("ogb")
    reset_launch_counts()
    res = sweep(pd, trace, N, SWEEP_CS, etas=etas, seeds=SWEEP_SEEDS, window=W, track_opt=False)
    launches, designs = launch_counts(), design_counts()
    rows = len(res.combos)
    need(rows == len(SWEEP_CS) * len(etas) * len(SWEEP_SEEDS) and pd.batched is not None,
         f"dense sweep: {rows} combos, a grid form {pd.batched is not None}")
    need(launches["histogram"] == chunks and launches["mass"] == chunks,
         f"dense sweep: {launches['histogram']} histograms and {launches['mass']} warm solves "
         f"over {chunks} chunks, not one each a chunk")
    singles_s = 0.0
    for r, combo in enumerate(res.combos):
        one = run(pd, trace, N, combo["capacity"], window=W, seed=combo["seed"],
                  eta=combo["eta"], track_opt=False)
        singles_s += one.wall_seconds
        need(torch.equal(one.carry.f, res.carries[r].f)
             and torch.equal(one.carry.tau, res.carries[r].tau),
             f"dense sweep row {r} {combo}: final f or tau differs from its single run")
        need((one.hits == res.hits[r]).all(), f"dense sweep row {r}: hits differ")
        rel = max(float(abs(one.reward - res.reward[r]).max() / abs(one.reward).max()),
                  float(abs(one.occupancy - res.occupancy[r]).max() / abs(one.occupancy).max()))
        need(rel <= 1e-5, f"dense sweep row {r}: reward or occupancy {rel} apart")
    us = 1e6 * res.wall_seconds / (SWEEP_T * rows)
    print(f"sweep dense ogb: {rows} combos (C {SWEEP_CS}, eta None and "
          f"{', '.join(f'{e:.6f}' for e in etas[1:])}, seeds {SWEEP_SEEDS}) over {SWEEP_T} "
          f"requests: {res.wall_seconds:.3f} s ({us:.4f} us a request a row); the {rows} single "
          f"runs {singles_s:.3f} s ({singles_s / res.wall_seconds:.2f}x); launches a chunk for "
          f"the grid: histogram {launches['histogram'] / chunks:g}, warm solve "
          f"{launches['mass'] / chunks:g} ({designs.get('mass', {})}); every row's f and tau bit for bit "
          f"its single run's, hits equal")
    return res, {"combos": rows, "requests": SWEEP_T, "wall_s": res.wall_seconds,
                 "singles_wall_s": singles_s, "us_per_request_row": us,
                 "launches": {"histogram": launches["histogram"], "mass": launches["mass"]},
                 "chunks": chunks, "design": designs.get("mass", {})}


def sweep_automata(torch, trace, n):
    """Phase 22, the automata: each kind's grid, then its single runs."""
    from repro_torch import policy_def, run, sweep
    from repro_torch.cachesim.tree_engines import ring_for_window
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.tree_lru.ops import CHUNK

    window = 1_000_000
    trace = trace[:SWEEP_AUTOMATA_T]
    chunks = SWEEP_AUTOMATA_T // window
    slots = max(SWEEP_AUTOMATA_CS)
    out, grids = {}, {}
    for kind in ("lru", "lfu", "ftpl", "fifo"):
        pd = policy_def(kind)
        seeds = SWEEP_SEEDS if kind != "fifo" else (0,)
        kw = {"ring": ring_for_window(slots, window)} if kind == "lru" else {}
        reset_launch_counts()
        res = sweep(pd, trace, n, SWEEP_AUTOMATA_CS, seeds=seeds, window=window,
                    track_opt=False, **kw)
        launches, designs = launch_counts(), design_counts()
        name = {"lru": "tree_lru", "fifo": "fifo_queue"}.get(kind, "minpair_automaton")
        by_design = designs.get(name, {})
        if kind == "lru":
            grid_launches = by_design.get(CHUNK, 0)
        elif kind == "fifo":
            grid_launches = max(by_design.values(), default=0)
        else:
            grid_launches = launches[name]
        need(pd.batched is not None and grid_launches == chunks,
             f"{kind} sweep: {by_design or launches[name]} over {chunks} chunks, not one a chunk"
             + (" a plan" if kind == "fifo" else ""))
        singles_s = 0.0
        for r, combo in enumerate(res.combos):
            one = run(pd, trace, n, combo["capacity"], window=window, seed=combo["seed"],
                      n_slots=slots, track_opt=False, **kw)
            singles_s += one.wall_seconds
            need((one.hits == res.hits[r]).all() and _same_carry(torch, one.carry,
                                                                  res.carries[r]),
                 f"{kind} sweep row {r} {combo}: hits or final carry differ from its single run")
        rows = len(res.combos)
        us = 1e6 * res.wall_seconds / (SWEEP_AUTOMATA_T * rows)
        print(f"sweep {kind}: {rows} combos (C {SWEEP_AUTOMATA_CS} at {slots} slots, seeds "
              f"{seeds}) over {SWEEP_AUTOMATA_T} requests of fig8_cdn full, a window of "
              f"{window}: {res.wall_seconds:.3f} s ({us:.5f} us a request a row); the {rows} "
              f"single runs {singles_s:.3f} s ({singles_s / res.wall_seconds:.2f}x); "
              f"{name} launches {by_design or launches[name]} over {chunks} chunks"
              + (f", {launches['segsum']} ring compactions' tree builds" if kind == "lru" else "")
              + "; every row's hits and final carry bit for bit its single run's")
        out[kind] = {"combos": rows, "requests": SWEEP_AUTOMATA_T, "wall_s": res.wall_seconds,
                     "singles_wall_s": singles_s, "us_per_request_row": us,
                     "launches": launches[name], "chunks": chunks,
                     "by_design": dict(by_design)}
        grids[kind] = res.carries[:SWEEP_TIMED_ROWS] if kind != "fifo" else None
    return out, grids


def time_automaton_grids(torch, dev, trace, n, carries, flush):
    """Phase 22: a chunk of the tree LRU, LFU and FIFO grids at
    SWEEP_TIMED_ROWS combos, from the sweep's final carries, cold, beside as
    many one-combo launches on the same carries, each row bit for bit its
    one-combo launch, and the bound (each row's bytes, summed)."""
    from repro_torch.cachesim import engines as te
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.cachesim.tree_engines import ring_for_window
    from repro_torch import policy_def

    window = 1_000_000
    ids = torch.from_numpy(trace[SWEEP_AUTOMATA_T:SWEEP_AUTOMATA_T + window].astype("int32")).to(dev)
    out = {}
    for kind in ("lru", "lfu", "fifo"):
        if kind == "fifo":
            pd = policy_def("fifo")
            rows = [pd.init(n, c, n_slots=max(SWEEP_AUTOMATA_CS)) for c in SWEEP_AUTOMATA_CS]
            fill = torch.from_numpy(trace[:window].astype("int32")).to(dev)
            grid = te.start_fifo_grid(rows, n)
            te.fifo_grid_chunk(grid, fill)
            singles = [te.FIFORunCarry(grid.slots[r].clone(), grid.stamps[r].clone(),
                                       grid.t[r].clone(),
                                       te.FIFOQueue(grid.queue.order[r, :grid.active[r]].clone(),
                                                    grid.queue.head[r].clone(),
                                                    grid.queue.imap[r].clone(),
                                                    grid.queue.occ[r].clone(),
                                                    grid.queue.misses[r].clone()))
                       for r in range(len(rows))]
            step_grid = lambda g: te.fifo_grid_chunk(g, ids)  # noqa: E731
            step_one = lambda c: te.fifo_chunk(c, ids)  # noqa: E731
            tensors = lambda c: [*c[:3], *c.queue]  # noqa: E731
        else:
            rows = [tt.start_tree_run(c) for c in carries[kind][:SWEEP_TIMED_ROWS]]
            grid = tt.grid_start(rows)
            singles = [tt.start_tree_run(c) for c in rows]
            step_grid = (lambda g: tt.grid_lru_chunk(g, ids)) if kind == "lru" else \
                (lambda g, k=kind: tt.tree_chunk(k, g, ids))
            step_one = lambda c, k=kind: tt.tree_chunk(k, c, ids)  # noqa: E731
            tensors = lambda c: [x for x in c if hasattr(x, "dtype")]  # noqa: E731
        grid_saved = [x.clone() for x in _carry_tensors(grid)]
        one_saved = [[x.clone() for x in tensors(c)] for c in singles]

        def reset_grid(grid=grid, saved=grid_saved):
            for x, y in zip(_carry_tensors(grid), saved):
                x.copy_(y)

        def reset_ones(singles=singles, saved=one_saved, tensors=tensors):
            for c, ys in zip(singles, saved):
                for x, y in zip(tensors(c), ys):
                    x.copy_(y)

        firsts = list(singles)  # each combo's carry object before the chunk (its host bound)
        state = {"grid": grid, "ones": list(singles)}

        def call_grid():
            state["grid"], _ = step_grid(state["grid"])

        def call_ones():
            for i, c in enumerate(state["ones"]):
                state["ones"][i], _ = step_one(c)

        reset_grid(), reset_ones()
        g_grid, (g_hits, _) = step_grid(grid)
        hits = []
        for i, c in enumerate(singles):
            singles[i], (h, _) = step_one(c)
            hits.append(int(h))
        need(g_hits.tolist() == hits, f"{kind} grid chunk: hits {g_hits.tolist()} against {hits}")
        if kind == "fifo":
            split = [(grid.slots[r], grid.stamps[r], grid.t[r]) for r in range(len(rows))]
            same = all(torch.equal(a, b) for r, c in enumerate(singles)
                       for a, b in zip(split[r], c[:3]))
            n_bytes = sum(fifo_bytes(torch, ids, h) for h in hits)
        else:
            after = tt.grid_split(g_grid)
            same = all(_same_carry(torch, a, b) for a, b in zip(after, singles))
            n_bytes = 0
            for r, c in enumerate(singles):
                n_bytes += tree_bytes(torch, kind, type(c)(*one_saved[r]), after[r], ids)
        need(same, f"{kind} grid chunk: a row's carry differs from its one-combo launch")
        ms = timed_ms(torch, call_grid, 5, flush, reset=lambda: (reset_grid(),
                                                                 state.update(grid=grid)))
        ones_ms = timed_ms(torch, call_ones, 5, flush,
                           reset=lambda: (reset_ones(firsts), state.update(ones=list(firsts))))
        bound, by = bound_ms(n_bytes, 0)
        print(f"{kind} grid chunk, {len(rows)} combos (C {SWEEP_AUTOMATA_CS[:len(rows)]}) x "
              f"{window} requests, cold from the sweep's state: one launch {ms:.3f} ms, "
              f"{len(rows)} one-combo launches {ones_ms:.3f} ms ({ones_ms / ms:.2f}x); bit for "
              f"bit them; bound {bound * 1e3:.3f} us by {by}")
        out[kind] = {"rows": len(rows), "ms": ms, "singles_ms": ones_ms, "bound_ms": bound,
                     "bound_by": by, "hits": hits, "library_ms": None}
    return out


def check_sweep(torch, dev, trace):
    """Phase 22: the sweep, dense and automata, and its kernels' times."""
    import time_warm_solves as tws

    from repro_torch.cachesim.scenarios import get_scenario

    t0 = time.perf_counter()
    print(f"sweep phase 22 on {nvidia_smi_line()}: each part's wall time beside its single runs'")
    dense, dense_row = sweep_dense(torch, trace)
    sc = get_scenario("fig8_cdn")
    n, _t, _c = sc.dims("full")
    fig8 = sc.make_trace("full")
    automata, carries = sweep_automata(torch, fig8, n)
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    # the warm solve over the dense grid's final states and the next chunk
    from repro_torch.jaxcache.fractional import warm_bracket_hi
    from repro_torch.kernels.scatter_counts.ops import histogram

    f = torch.stack([c.f for c in dense.carries])
    eta = torch.stack([c.eta for c in dense.carries])
    ids = torch.from_numpy(trace[SWEEP_T:SWEEP_T + W].astype("int32")).to(dev)
    rows = (f, histogram(ids, N), eta, torch.stack([c.cap for c in dense.carries]),
            torch.zeros_like(eta), warm_bracket_hi(eta * float(W)),
            torch.stack([c.tau for c in dense.carries]))
    solves = tws.time_solves(torch, dev, flush, rows)
    del dense, f, rows
    grids = time_automaton_grids(torch, dev, fig8, n, carries, flush)
    print(f"sweep phase 22: {time.perf_counter() - t0:.2f} s")
    return {"dense": dense_row, "automata": automata, "warm_solve": solves,
            "automaton_grids": grids}


# -- streams, trace files and fleets (phase 23) ----------------------------------

def _rss_mb():
    """This process's resident memory now, MB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


class RssPeak:
    """The largest VmRSS sampled every 20 ms while the block ran."""

    def __enter__(self):
        import threading

        self.start = self.peak = _rss_mb()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, _rss_mb())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_mb())
        return False


def stream_from_file(torch, trace):
    """Phase 23 (a): the main trace through a u32 trace file, CatalogRemap
    and run_stream, with the pipeline and without, against one run."""
    import numpy as np

    from repro_torch import (CatalogRemap, open_trace, policy_def, remap_trace, run,
                             run_stream, write_trace)

    path = ROOT / "build" / "chip_smoke" / "main_trace.u32"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_trace(str(path), trace, "bin32")
    write_s = time.perf_counter() - t0
    pd = policy_def("ogb")
    out, streams = {"file_mb": path.stat().st_size / 2**20, "write_s": write_s}, {}
    try:
        for prefetch in (2, 0):
            remap = CatalogRemap(max_items=N)
            with RssPeak() as rss:
                res = run_stream(pd, remap.remap(open_trace(str(path))), N, C, window=W,
                                 horizon=T, prefetch=prefetch)
            streams[prefetch] = res
            out[f"prefetch_{prefetch}"] = {
                "wall_s": res.wall_seconds, "ingest_s": res.ingest_seconds,
                "device_s": res.device_seconds, "host_s": res.host_seconds,
                "segments": res.n_segments, "us_per_request": res.us_per_request,
                "rss_start_mb": rss.start, "rss_growth_mb": rss.peak - rss.start,
                "items": len(remap)}
    finally:
        path.unlink()
    t0 = time.perf_counter()
    dense = remap_trace(trace)
    remap_s = time.perf_counter() - t0
    one = run(pd, dense, N, C, window=W, track_opt=False)
    for prefetch, res in streams.items():
        need(res.T == one.T and np.array_equal(res.hits, one.hits)
             and np.array_equal(res.reward, one.reward) and np.array_equal(res.aux, one.aux)
             and torch.equal(res.carry.f, one.carry.f),
             f"run_stream (prefetch {prefetch}) is not the one-shot run bit for bit")
        o = out[f"prefetch_{prefetch}"]
        print(f"stream from a u32 file ({out['file_mb']:.1f} MB, written in {write_s:.2f} s) "
              f"-> CatalogRemap ({o['items']} items) -> run_stream(ogb), prefetch {prefetch}: "
              f"{o['wall_s']:.2f} s wall, {o['us_per_request']:.4f} us a request, "
              f"{o['segments']} segments; ingest {o['ingest_s']:.2f} s, device "
              f"{o['device_s']:.2f} s, host {o['host_s']:.3f} s; resident memory "
              f"{o['rss_start_mb']:.0f} MB at its start, +{o['rss_growth_mb']:.1f} MB at its "
              f"peak; bit for bit the one-shot run (hits, reward, tau, final f)")
    out["one_shot"] = {"wall_s": one.wall_seconds, "us_per_request": one.us_per_request,
                       "remap_trace_s": remap_s}
    print(f"one-shot run over remap_trace ({remap_s:.2f} s on the host): {one.wall_seconds:.2f} s"
          f", {one.us_per_request:.4f} us a request")
    return out


def _make_tenant_traces(sc, scale):
    """The scenario's (E, T) tenant traces, as make_edge_traces makes them
    (the same seeds), a thread a tenant at a time."""
    import numpy as np

    import concurrent.futures

    from repro_torch.cachesim.traces import make_trace

    e, n, t, _, _ = sc.dims(scale)
    kw = dict(sc.trace_kw)
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        rows = list(ex.map(lambda i: make_trace(sc.trace, n, t, seed=sc.trace_seed + i, **kw),
                           range(e)))
    return np.stack(rows)


def _fleet_against_runs(torch, kind, traces, n, cap, window, tenants, **kw):
    """run_fleet of ``kind`` with its launches, and the given tenants' own
    runs: every per-chunk array and the final carry bit for bit."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.cachesim.fleet import run_fleet
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts

    pd = policy_def(kind)
    reset_launch_counts()
    fr = run_fleet(pd, traces, n, cap, window=window, track_opt=False, **kw)
    launches, designs = launch_counts(), design_counts()
    singles = {}
    for r in tenants:
        one = run(pd, traces[r], n, cap, window=window, seed=r, track_opt=False, **kw)
        same = all(np.array_equal(getattr(fr, a)[r], getattr(one, a))
                   for a in ("hits", "reward", "aux", "occupancy"))
        need(same and _same_carry(torch, fr.carry[r], one.carry),
             f"{kind} fleet: tenant {r} is not its own run bit for bit")
        singles[r] = one.us_per_request
    return fr, launches, designs, singles


def fleet_full_edge(torch, sc, traces):
    """Phase 23 (b) and (c): edge_fleet_cdn full's edge tier."""
    from repro_torch.kernels.tree_lru.ops import CHUNK, COMPACTION

    e, n, t, c_edge, _ = sc.dims("full")
    window = sc.window
    chunks = t // window
    out, fleets = {}, {}
    for kind in ("lru", "ogb"):
        fr, launches, designs, singles = _fleet_against_runs(torch, kind, traces, n, c_edge,
                                                             window, FLEET_CHECKED)
        if kind == "lru":
            by_design = designs.get("tree_lru", {})
            grid_launches = {"tree_lru": by_design.get(CHUNK, 0),
                             "compaction": by_design.get(COMPACTION, 0),
                             "segsum": launches["segsum"]}
            ok = (grid_launches["tree_lru"] == chunks
                  and grid_launches["compaction"] == grid_launches["segsum"] <= chunks)
        else:
            grid_launches = {"histogram": launches["histogram"], "mass": launches["mass"]}
            ok = launches["histogram"] == chunks and launches["mass"] == chunks
        need(ok, f"{kind} fleet: launches {grid_launches} over {chunks} chunks, not one a chunk")
        out[kind] = {"tenants": e, "requests_a_tenant": t, "wall_s": fr.wall_seconds,
                     "us_per_request": fr.us_per_request, "launches": grid_launches,
                     "chunks": chunks, "hit_ratio": fr.hit_ratio,
                     "hit_ratio_p5": fr.hit_ratio_p5, "hit_ratio_p95": fr.hit_ratio_p95,
                     "singles_us_per_request": singles}
        fleets[kind] = fr
        print(f"fleet {kind}, {EDGE} full's edge tier ({e} tenants, N = {n}, {t} requests a "
              f"tenant, C = {c_edge}, window {window}): {fr.wall_seconds:.3f} s, "
              f"{fr.us_per_request:.5f} us a request; launches {grid_launches} over {chunks} "
              f"chunks; hit ratio {fr.hit_ratio:.4f} (tenants p5 {fr.hit_ratio_p5:.4f}, p95 "
              f"{fr.hit_ratio_p95:.4f}); tenants {FLEET_CHECKED} bit for bit their own runs, "
              f"which took " + ", ".join(f"{v:.4f}" for v in singles.values())
              + " us a request")
    small = traces[:FLEET_SMALL]
    for kind in ("lfu", "ftpl", "fifo"):
        fr, launches, designs, singles = _fleet_against_runs(
            torch, kind, small, n, c_edge, window, (0, FLEET_SMALL - 1))
        name = "fifo_queue" if kind == "fifo" else "minpair_automaton"
        per_plan = max(designs.get(name, {}).values(), default=0)
        need(per_plan == chunks and launches[name] <= 2 * chunks,
             f"{kind} fleet: {designs.get(name)} over {chunks} chunks, not one a chunk")
        out[kind] = {"tenants": FLEET_SMALL, "wall_s": fr.wall_seconds,
                     "us_per_request": fr.us_per_request, "launches": launches[name],
                     "chunks": chunks, "hit_ratio": fr.hit_ratio,
                     "singles_us_per_request": singles}
        fleets[kind] = fr
        print(f"fleet {kind}, the first {FLEET_SMALL} tenants: {fr.wall_seconds:.3f} s, "
              f"{fr.us_per_request:.5f} us a request, {name} launches {launches[name]} over "
              f"{chunks} chunks; tenants 0 and {FLEET_SMALL - 1} bit for bit their own runs "
              f"(" + ", ".join(f"{v:.4f}" for v in singles.values()) + " us a request)")
    return out, fleets


def edge_quick_against_cpu(cpu_future):
    """Phase 23 (d): edge_fleet_cdn at quick on the card against the CPU."""
    import numpy as np

    from repro_torch.cachesim.fleet import run_edge_fleet_scenario

    t0 = time.perf_counter()
    ef = run_edge_fleet_scenario(EDGE, "quick")
    wall = time.perf_counter() - t0
    cpu, secs = cpu_result(cpu_future, timeout=None)
    print(f"{EDGE} quick: {secs:.2f} s waiting on the CPU run")
    need(np.array_equal(ef.edges.hits, cpu["edge_hits"]),
         f"{EDGE} quick: the card's edges are not the CPU's")
    o = cpu["origin"]
    dtau = float(np.abs(ef.origin.aux - o["aux"]).max())
    dhits = abs(int(ef.origin.hits.sum()) - int(o["hits"].sum()))
    need(ef.origin_requests == cpu["origin_requests"] and ef.origin.T == o["T"]
         and dtau <= 1e-6 and dhits <= max(1, ef.origin.T // 10_000),
         f"{EDGE} quick origin: |dtau| {dtau}, hits {dhits} apart over {ef.origin.T}")
    print(f"{EDGE} quick on the card: {wall:.2f} s; edges equal to the CPU's (hit ratio "
          f"{ef.edge_hit_ratio:.4f}), origin over {ef.origin_requests} misses: |dtau| "
          f"{dtau:.3g}, hits {dhits} apart, hit ratio {ef.origin_hit_ratio:.4f}, end to end "
          f"{ef.end_to_end_hit_ratio:.4f}")
    return {"wall_s": wall, "origin_dtau": dtau, "origin_hits_apart": dhits,
            "edge_hit_ratio": ef.edge_hit_ratio, "end_to_end_hit_ratio": ef.end_to_end_hit_ratio}


def _timed_rows(torch, flush, grid_call, ones_call, reset):
    """Device ms of the one launch and of the E one-row launches, cold, the
    device held busy for twice the host's time to enqueue each call (E
    one-row launches take milliseconds to enqueue), so the events time the
    device alone."""
    out = []
    for fn, reps in ((grid_call, 3), (ones_call, 2)):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        hold = max(HOLD_CYCLES, int(2 * host_s * 2e9))  # ~2e9 cycles a second
        out.append(timed_ms(torch, fn, reps, flush, hold=hold, reset=reset))
    return tuple(out)


def row_kernels(torch, dev, sc, traces, fleets, flush):
    """Phase 23 (e): each per-row kernel at (b)'s shapes, a row of ids a
    tenant, against its plain version and timed cold beside E one-row
    launches."""
    from repro_torch import policy_def
    from repro_torch.cachesim import engines as te
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.cachesim.fleet import run_fleet
    from repro_torch.jaxcache.fractional import warm_bracket_hi
    from repro_torch.kernels.capped_simplex.ops import project_warm
    from repro_torch.kernels.capped_simplex.ref import apply_ref, project_warm_tau_ref
    from repro_torch.kernels.fifo_queue.ref import FIFOQueue
    from repro_torch.kernels.scatter_counts.ops import histogram
    from repro_torch.kernels.scatter_counts.ref import histogram_ref

    e, n, t, c_edge, _ = sc.dims("full")
    window = sc.window
    # the chunk after those the fleets replayed: their first chunk again
    ids64 = torch.from_numpy(traces[:, :window].astype("int64")).to(dev)
    ids = ids64.to(torch.int32).contiguous()
    out = {}

    def report(name, ms, ones_ms, n_bytes, extra=""):
        bound, by = bound_ms(n_bytes, 0)
        print(f"{name} over {e} rows of ids ({e} x {window}){extra}: one launch {ms * 1e3:.2f} "
              f"us cold, {e} one-row launches {ones_ms * 1e3:.2f} us ({ones_ms / ms:.2f}x); "
              f"bound {bound * 1e3:.3f} us by {by}")
        return {"rows": e, "ms": ms, "one_row_launches_ms": ones_ms, "bound_ms": bound,
                "bound_by": by}

    # the histogram: (E, W) ids -> (E, N) counts
    got = histogram(ids, n)
    need(torch.equal(got, histogram_ref(ids, n))
         and all(torch.equal(got[r], histogram(ids[r].contiguous(), n)) for r in range(e)),
         "histogram rows: not the plain version or their one-row calls")
    rows = [ids[r].contiguous() for r in range(e)]
    ms, ones_ms = _timed_rows(torch, flush, lambda: histogram(ids, n),
                              lambda: [histogram(x, n) for x in rows], None)
    offsets = (torch.arange(e, device=dev) * n)[:, None]

    def library():
        return torch.zeros(e * n, device=dev).index_add_(
            0, (ids64 + offsets).reshape(-1), torch.ones(e * window, device=dev))

    need(torch.equal(library().reshape(e, n), got), "histogram rows: index_add_ differs")
    out["histogram"] = report("histogram", ms, ones_ms, 4 * e * window + 4 * e * n)
    out["histogram"]["library_ms"] = timed_ms(torch, library, 3, flush)
    out["histogram"]["plain_ms"] = timed_ms(torch, lambda: histogram_ref(ids, n), 1, flush)

    # the warm solve: the ogb fleet's final states, a counts row a tenant
    carries = fleets["ogb"].carry
    f = torch.stack([c.f for c in carries])
    eta = torch.stack([c.eta for c in carries])
    cap = torch.stack([c.cap for c in carries])
    tau0 = torch.stack([c.tau for c in carries])
    lo, hi = torch.zeros_like(eta), warm_bracket_hi(eta * float(window))
    got_f, got_tau = project_warm(f, got, eta, cap, lo, hi, tau0, SWEEPS)
    for r in range(e):
        one_f, one_tau = project_warm(f[r], got[r], eta[r], cap[r], lo[r], hi[r], tau0[r],
                                      SWEEPS)
        need(torch.equal(one_f, got_f[r]) and torch.equal(one_tau, got_tau[r]),
             f"warm solve row {r}: not its one-row launch bit for bit")
    dtau = max(abs(float(project_warm_tau_ref(f[r], got[r], eta[r], cap[r], lo[r], hi[r],
                                              tau0[r], SWEEPS)) - float(got_tau[r]))
               for r in FLEET_CHECKED)
    need(dtau <= 1e-6 and all(torch.equal(got_f[r], apply_ref(f[r], got[r], eta[r], got_tau[r]))
                              for r in FLEET_CHECKED),
         f"warm solve rows: tau {dtau} from the plain version, or f' not its clip")
    scal = [(f[r], got[r], eta[r], cap[r], lo[r], hi[r], tau0[r]) for r in range(e)]
    ms, ones_ms = _timed_rows(
        torch, flush, lambda: project_warm(f, got, eta, cap, lo, hi, tau0, SWEEPS),
        lambda: [project_warm(*x, SWEEPS) for x in scal], None)
    out["mass"] = report("warm solve with its f' epilogue", ms, ones_ms, 12 * e * n,
                         f" (N = {n}, a counts row a row)")
    out["mass"]["max_dtau_plain"] = dtau
    del f, got_f, scal

    # the automata: each kind's grid from its fleet's (or a short run's) carries
    automata = {}
    for kind, name in (("lru", "tree_lru"), ("lfu", "minpair_automaton"),
                       ("fifo", "fifo_queue")):
        if kind == "lru":
            start = fleets["lru"].carry
        else:  # every tenant, its first 20 chunks
            start = run_fleet(policy_def(kind), traces[:, :20 * window], n, c_edge,
                              window=window, track_opt=False).carry
        if kind == "fifo":
            grid = te.start_fifo_grid(start, n)
            singles = [te.start_fifo_run(c, n) for c in start]
            step_grid = lambda g: te.fifo_grid_chunk(g, ids)  # noqa: E731
            step_one = lambda c, r: te.fifo_chunk(c, rows[r])  # noqa: E731
            tensors = fifo_tensors
        else:
            grid = tt.grid_start([tt.start_tree_run(c) for c in start])
            singles = [tt.start_tree_run(c) for c in start]
            step_grid = ((lambda g: tt.grid_lru_chunk(g, ids)) if kind == "lru" else
                         (lambda g, k=kind: tt.tree_chunk(k, g, ids)))
            step_one = lambda c, r, k=kind: tt.tree_chunk(k, c, rows[r])  # noqa: E731
            tensors = lambda c: [x for x in c if hasattr(x, "dtype")]  # noqa: E731
        grid_saved = [x.clone() for x in _carry_tensors(grid)]
        one_saved = [[x.clone() for x in tensors(c)] for c in singles]
        first = list(singles)
        state = {"grid": grid, "ones": list(singles)}

        def reset(grid=grid, singles=first, gs=grid_saved, os_=one_saved, tensors=tensors,
                  state=state):
            for x, y in zip(_carry_tensors(grid), gs):
                x.copy_(y)
            for c, ys in zip(singles, os_):
                for x, y in zip(tensors(c), ys):
                    x.copy_(y)
            state.update(grid=grid, ones=list(singles))

        def call_grid(state=state, step_grid=step_grid):
            state["grid"], _ = step_grid(state["grid"])

        def call_ones(state=state, step_one=step_one):
            for r, c in enumerate(state["ones"]):
                state["ones"][r], _ = step_one(c, r)

        reset()
        g_grid, (g_hits, _) = step_grid(grid)
        hits = []
        for r in range(e):
            singles[r], (h, _) = step_one(singles[r], r)
            hits.append(h)
        hits = torch.stack(hits)
        need(torch.equal(g_hits, hits), f"{name} rows: hits differ from one-row launches")
        if kind == "fifo":
            same = all(torch.equal(a, b) for r in range(e)
                       for a, b in zip((grid.slots[r], grid.stamps[r], grid.t[r]),
                                       singles[r][:3]))
        else:
            same = all(_same_carry(torch, a, b) for a, b in zip(tt.grid_split(g_grid), singles))
        need(same, f"{name} rows: a row's carry differs from its one-row launch")
        # the plain version, on the CPU from the same carries, the checked tenants
        for r in FLEET_CHECKED:
            before = [y.cpu() for y in one_saved[r]]
            if kind == "fifo":
                c0 = te.FIFORunCarry(*before[:3], FIFOQueue(*before[3:]))
                c0, (h, _) = te.fifo_chunk(c0, rows[r].cpu())
            else:
                c0, (h, _) = tt.tree_chunk(kind, type(first[r])(*before), rows[r].cpu())
            want = tensors(c0)
            got_r = [x.cpu() for x in tensors(singles[r])]
            need(int(h) == int(hits[r]) and len(got_r) == len(want)
                 and all(torch.equal(a, b) for a, b in zip(got_r, want)),
                 f"{name} row {r}: not its plain version bit for bit")
        ms, ones_ms = _timed_rows(torch, flush, call_grid, call_ones, reset)
        if kind == "fifo":
            n_bytes = sum(fifo_bytes(torch, rows[r], int(hits[r])) for r in range(e))
        else:
            n_bytes = sum(tree_bytes(torch, kind, type(first[r])(*one_saved[r]), singles[r],
                                     rows[r]) for r in range(e))
        automata[name] = report(name + (" (LFU)" if kind == "lfu" else ""), ms, ones_ms,
                                n_bytes, f" (C = {c_edge}, N = {n})")
        reset()
    out.update(automata)
    return out


def check_fleet(torch, dev, trace, cpu_edge_future):
    """Phase 23: streams, trace files and fleets."""
    from repro_torch.cachesim.scenarios import get_edge_fleet_scenario

    t0 = time.perf_counter()
    print(f"streams and fleets phase 23 on {nvidia_smi_line()}")
    stream = stream_from_file(torch, trace)
    sc = get_edge_fleet_scenario(EDGE)
    t1 = time.perf_counter()
    traces = _make_tenant_traces(sc, "full")
    print(f"{EDGE} full's {traces.shape[0]} tenant traces of {traces.shape[1]} requests: "
          f"{time.perf_counter() - t1:.2f} s on the host")
    fleet, fleets = fleet_full_edge(torch, sc, traces)
    quick = edge_quick_against_cpu(cpu_edge_future)
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    kernels = row_kernels(torch, dev, sc, traces, fleets, flush)
    del fleets, flush_buf
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"streams and fleets phase 23: {secs:.2f} s")
    return {"stream": stream, "fleet": fleet, "edge_quick": quick, "row_kernels": kernels,
            "seconds": secs}


# -- MoE serving and the expert cache (phase 24) -----------------------------------

#: (a) the MoE model served at full width; (b) the capacity-dispatch model,
#: its depth cut, a prefill of B x S tokens, its decode steps and the tokens
#: held against float64
MOE_ARCH, DISPATCH_ARCH = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
DISPATCH_LAYERS, DISPATCH_B, DISPATCH_S, DISPATCH_STEPS, DISPATCH_SAMPLED = 1, 1, 512, 8, 64
#: (c) the expert catalogs (layers, experts) at resident fraction 0.25; the
#: Poisson(5) run's steps (benchmarks/serving_slo.py's payloads, seed 0); the
#: drift run's steps, the step its hot experts move at, and its hot experts a
#: layer (tests/serve/test_serve.py's routing, the hot set half a layer on);
#: the serving loop's warm-up and timed steps and its load
#: (benchmarks/serving_slo.py's LOAD_FACTOR); card against CPU within
EXPERT_CATALOGS = {"kimi-k2-1t-a32b": (61, 384), "granite-moe-1b-a400m": (24, 32)}
EXPERT_STEPS, DRIFT_STEPS, DRIFT_SHIFT, DRIFT_HOT = 200, 1500, 500, 8
EXPERT_WARM, EXPERT_TIMED, LOAD_FACTOR, EXPERT_TOL = 20, 50, 0.7, 1e-5


class moe_routes:
    """Within this block every MoE layer's routing is recorded in call order
    (``seen``: its top-k expert ids (T, K); ``inputs``: its (T, D) input,
    when ``keep_inputs``).  Given ``forced`` (an earlier block's ``seen``),
    each layer routes by those ids instead, its gates its own softmax at
    them, renormalised: the run follows the other run's routing, and
    ``seen`` still holds its own."""

    def __init__(self, forced=None, keep_inputs=False):
        self.forced, self.keep_inputs = forced, keep_inputs
        self.seen, self.inputs = [], []

    def __enter__(self):
        from repro_torch.models import moe

        self.saved = moe.route

        def route(p, xt, k):
            r = self.saved(p, xt, k)
            self.seen.append(r.eidx)
            if self.keep_inputs:
                self.inputs.append(xt)
            if self.forced is None:
                return r
            eidx = self.forced[len(self.seen) - 1]
            gates = r.probs.gather(1, eidx)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            return moe.Routing(r.logits, r.probs, gates, eidx)

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.saved


def routing_flips(torch, a, b, seq_len):
    """(token, layer) pairs whose top-k expert sets differ between two
    runs' routings, a layer, and the sequences (rows of ``seq_len``
    tokens) with none."""
    flips, clean = [], None
    for x, y in zip(a, b):
        differ = (torch.sort(x, dim=-1).values != torch.sort(y, dim=-1).values).any(dim=-1)
        flips.append(int(differ.sum()))
        rows = ~differ.view(-1, seq_len).any(dim=-1)
        clean = rows if clean is None else clean & rows
    return flips, clean


def check_moe_served_against_plain(torch, engine, prompts, first_out):
    """Phase 24 (a): the MoE model through the kernels against the plain
    attention versions on the card: the plain run with its own routing,
    held where no (token, layer) routed differently; and the plain run
    routed as the kernels' run, held on every row; then 8 teacher-forced
    decode steps routed the same way, and two generate calls on equal
    prompts."""
    import numpy as np

    from repro_torch.models.model import decode_step, prefill

    cfg, params, dev, V = engine.cfg, engine.params, engine.device, engine.cfg.vocab_size
    tokens = torch.from_numpy(prompts).to(dev)
    B, S = prompts.shape

    def compare(label, a, b, rows=None):
        a, b = a[:, :V].float(), b[:, :V].float()
        if rows is not None:
            a, b = a[rows], b[rows]
        if not len(b):
            print(f"{label}: no row to hold")
            return 0.0
        top = float(b.abs().max())
        tol = 8 * bf16_ulp(top)
        err = float((a - b).abs().max())
        print(f"{label}: max |logit kernels - plain| = {err:.4e} over {len(b)} rows (limit "
              f"{tol:.4e}, 8 bf16 ulps of the largest |logit| {top:.4f})")
        need(bool(torch.isfinite(a).all()) and err <= tol, f"{label}: logits differ by {err}")
        return err

    with moe_routes() as kern:
        lk, ck = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    with plain_attention(), moe_routes() as own:
        lp, _ = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    by_layer, clean = routing_flips(torch, kern.seen, own.seen, S)
    flips, decisions = sum(by_layer), B * S * cfg.n_layers
    print(f"prefill routing, kernels against plain attention with its own routing: {flips} "
          f"(token, layer) flips of {decisions}, by layer {by_layer} (a flip changes its "
          f"token's later layers and, through attention, the later tokens'); "
          f"{int(clean.sum())} of {B} rows with none")
    compare("prefill, last token, rows routed alike", lk, lp, clean)
    with plain_attention(), moe_routes(forced=kern.seen):
        lf, cf = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    errs = [compare("prefill, last token, plain routed as the kernels", lk, lf)]
    need(np.array_equal(torch.argmax(lk[:, :V], -1).cpu().numpy(), first_out[:, 0]),
         "prefill does not repeat generate")
    tok, decode_flips = torch.argmax(lk[:, :V], -1), 0
    for step in range(TEACHER_STEPS):
        with moe_routes() as kern:
            lk, ck = decode_step(cfg, params, ck, tok, dev)
        with plain_attention(), moe_routes(forced=kern.seen) as own:
            lf, cf = decode_step(cfg, params, cf, tok, dev)
        decode_flips += sum(routing_flips(torch, kern.seen, own.seen, 1)[0])
        errs.append(compare(f"decode step {step + 1}, teacher-forced, routed alike", lk, lf))
        tok = torch.argmax(lk[:, :V], -1)
    print(f"decode routing over {TEACHER_STEPS} teacher-forced steps: {decode_flips} (token, "
          f"layer) flips of {B * TEACHER_STEPS * cfg.n_layers} where plain attention routed "
          f"by its own scores")
    again = engine.generate(prompts, SERVE_NEW)
    need(np.array_equal(again, first_out), "two generate calls on equal prompts differ")
    print(f"two generate calls on equal prompts: equal tokens ({again.size})")
    return {"prefill_flips": flips, "prefill_flips_by_layer": by_layer,
            "prefill_decisions": decisions,
            "rows_routed_alike": int(clean.sum()), "decode_flips": decode_flips,
            "max_logit_err": max(errs)}


def serve_moe(torch, dev):
    """Phase 24 (a): granite-moe at full width, all 24 layers, behind an OGB
    page pool (phase 14's engine and calls), where its time goes, its
    logits against the plain versions', and its attention kernels timed at
    its served shapes."""
    from repro_torch.configs.base import get_arch

    engine, prompts, first_out, launches, steady = serve_full_width(torch, dev, MOE_ARCH)
    serve_breakdown(torch, engine, prompts)
    held = check_moe_served_against_plain(torch, engine, prompts, first_out)
    del engine
    torch.cuda.empty_cache()
    cfg = get_arch(MOE_ARCH)
    decode_job, prefill_job = attention_jobs(torch, dev, cfg.n_heads, cfg.n_kv_heads,
                                             cfg.head_dim, 24)
    flush = l2_flush(torch, dev)
    timed = time_served_attention(
        torch, dev, decode_job, prefill_job,
        lambda *a: measure_attention(torch, *a, flush))
    for name in ("flash_prefill", "decode_attention"):
        timed[name] = {"launches": launches[name], **timed[name]["serving"]}
    return {"serving": steady, "held": held, "attention": timed}


def expert_f64(torch, p, xt, r, kept, tokens):
    """The MoE output of ``tokens`` in float64 on the card: each kept
    (expert, gate) pair's SwiGLU over the layer's bf16 weights, summed."""
    out = torch.zeros((len(tokens), xt.shape[1]), dtype=torch.float64, device=xt.device)
    eidx, gates, keep = r.eidx[tokens], r.gates[tokens].double(), kept[tokens]
    for e in torch.unique(eidx[keep]).tolist():
        i, k = torch.nonzero((eidx == e) & keep, as_tuple=True)
        x = xt[tokens][i].double()
        h = torch.nn.functional.silu(x @ p["w_gate"][e].double()) * (x @ p["w_up"][e].double())
        out.index_add_(0, i, gates[i, k][:, None] * (h @ p["w_down"][e].double()))
    return out


def check_dispatch_layer(torch, dev):
    """Phase 24 (b): kimi-k2 at full width, its depth cut from 61 layers to
    DISPATCH_LAYERS: a prefill of DISPATCH_B x DISPATCH_S tokens through
    capacity dispatch (the reference's small-batch plan), DISPATCH_STEPS
    decode steps, the MoE output of DISPATCH_SAMPLED sampled tokens against
    a float64 evaluation of the same kept (expert, gate) pairs, and the
    dispatch's share of the layer's time."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, init_params, prefill

    full = get_arch(DISPATCH_ARCH)
    cfg = dataclasses.replace(full, n_layers=DISPATCH_LAYERS)
    T = DISPATCH_B * DISPATCH_S
    need(T * cfg.experts_per_token <= 16_384, "the prefill is past the small-batch plan")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    p = params["blocks"][0]["moe"]
    expert_bytes = sum(p[k].numel() * p[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    cap = moe.capacity(T, cfg)
    print(f"{DISPATCH_ARCH}: depth cut from {full.n_layers} layers to {cfg.n_layers}, every "
          f"width its own (d_model {cfg.d_model}, heads {cfg.n_heads} / KV {cfg.n_kv_heads}, "
          f"head_dim {cfg.head_dim}, {cfg.n_experts} experts of {cfg.expert_ff} top-"
          f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}, vocab "
          f"{cfg.vocab_size}); weights drawn in bf16 on the card expert by expert in "
          f"{time.perf_counter() - t0:.2f} s, experts {expert_bytes / 1e9:.3f} GB, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated; capacity {cap} at "
          f"T = {T}")
    need(cap == 11 and cfg.n_experts * cfg.expert_ff > moe.DENSE_MIXTURE_MAX,
         "kimi-k2's prefill does not take capacity dispatch at capacity 11")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (DISPATCH_B, DISPATCH_S))).to(dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_routes(keep_inputs=True) as rec:
        logits, cache = prefill(cfg, params, {"tokens": tokens}, DISPATCH_S + DISPATCH_STEPS,
                                dev)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
    t0 = time.perf_counter()
    for _ in range(DISPATCH_STEPS):
        logits, cache = decode_step(cfg, params, cache, tok, dev)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DISPATCH_STEPS
    launches = launch_counts()
    want = {name: 0 for name in launches}
    want.update(flash_prefill=cfg.n_layers, decode_attention=cfg.n_layers * DISPATCH_STEPS)
    need(launches == want, f"kimi-k2 launches {launches}, expected {want}")
    need(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()), "kimi-k2's logits not finite")
    xt, r = rec.inputs[0], moe.route(p, rec.inputs[0], cfg.experts_per_token)
    need(torch.equal(r.eidx, rec.seen[0]), "the layer's routing does not repeat")
    kept = (moe.dispatch(r, cfg.n_experts, cap) != cfg.n_experts * cap).view(
        T, cfg.experts_per_token)
    out = moe.moe_output(p, xt[None], cfg)[0]
    sample = torch.from_numpy(np.sort(rng.choice(T, DISPATCH_SAMPLED, replace=False))).to(dev)
    want64 = expert_f64(torch, p, xt, r, kept, sample)
    top = float(want64.abs().max())
    tol = 8 * bf16_ulp(top)
    err = float((out[sample].double() - want64).abs().max())
    n_kept = int(kept.sum())
    print(f"kimi-k2 prefill {prefill_s * 1e3:.3f} ms (B={DISPATCH_B}, S={DISPATCH_S}), decode "
          f"{decode_ms:.3f} ms a step; launches {launches}; {n_kept} of {kept.numel()} "
          f"assignments kept, {kept.numel() - n_kept} past capacity; MoE output of "
          f"{DISPATCH_SAMPLED} sampled tokens against float64 of the same kept (expert, gate) "
          f"pairs: max |bf16 - float64| {err:.4e} (limit {tol:.4e}, 8 bf16 ulps of the "
          f"largest {top:.4f})")
    need(bool(torch.isfinite(out).all()) and err <= tol, f"kimi-k2 MoE output off by {err}")
    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen, device=dev).to(xt.dtype)
    layer_ms = timed_ms(torch, lambda: moe.moe_output(p, xt[None], cfg), 10)
    experts_ms = timed_ms(torch, lambda: moe.expert_swiglu(p, buf), 10)
    n_ops = 2 * 3 * cfg.n_experts * cap * cfg.d_model * cfg.expert_ff
    b, by = bound_ms(expert_bytes, n_ops, BF16_OPS_PER_S)
    share = 1 - experts_ms / layer_ms
    print(f"kimi-k2 MoE layer at T = {T}: {layer_ms:.3f} ms, its three expert products "
          f"{experts_ms:.3f} ms (bound {b:.3f} ms by {by}: every expert's weights read once); "
          f"routing, dispatch and combine {layer_ms - experts_ms:.3f} ms, {share:.4f} of the "
          f"layer; peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    del params, p, cache, buf, rec
    torch.cuda.empty_cache()
    return {"layers": f"{cfg.n_layers} of {full.n_layers}", "prefill_ms": prefill_s * 1e3,
            "decode_ms_a_step": decode_ms, "capacity": cap, "kept": n_kept,
            "max_abs_err_f64": err, "layer_ms": layer_ms, "experts_ms": experts_ms,
            "dispatch_share": share, "experts_bound_ms": b}


def expert_payloads(layers, experts, kind):
    """Routed counts a step: ``poisson``, benchmarks/serving_slo.py's
    Poisson(5) vectors (seed 0); ``drift``, tests/serve/test_serve.py's
    routing (DRIFT_HOT hot experts a layer at 50-100 tokens, four others at
    0-10), the hot set half a layer on from step DRIFT_SHIFT."""
    import numpy as np

    rng = np.random.default_rng(0)
    if kind == "poisson":
        return [rng.poisson(5.0, (layers, experts)).astype(np.float32)
                for _ in range(EXPERT_STEPS)]
    out = []
    for t in range(DRIFT_STEPS):
        counts = np.zeros((layers, experts), np.float32)
        start = 0 if t < DRIFT_SHIFT else experts // 2
        counts[:, start:start + DRIFT_HOT] = rng.integers(50, 100, (layers, DRIFT_HOT))
        for layer in range(layers):
            counts[layer, rng.integers(0, experts, 4)] += rng.integers(0, 10, 4)
        out.append(counts)
    return out


def expert_cache_config(name, kind):
    from repro_torch.serve.expert_cache import ExpertCacheConfig

    layers, experts = EXPERT_CATALOGS[name]
    steps = EXPERT_STEPS if kind == "poisson" else DRIFT_STEPS
    return ExpertCacheConfig(n_layers=layers, n_experts=experts, resident_fraction=0.25,
                             horizon_steps=steps)


def cpu_expert_run(name, kind):
    """Phase 24 (c)'s CPU side, in a worker process: OGBExpertCache from seed
    0 on the CPU over the payloads; each step's tau, f and record."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from repro_torch.serve.expert_cache import OGBExpertCache

    ec = OGBExpertCache(expert_cache_config(name, kind), seed=0, device="cpu")
    taus, fs, recs = [], [], []
    for counts in expert_payloads(*EXPERT_CATALOGS[name], kind):
        recs.append(ec.step(counts))
        taus.append(float(ec.carry.tau))
        fs.append(ec.carry.f.numpy().copy())
    return {"tau": np.array(taus), "f": np.stack(fs), "records": recs,
            "p": ec.carry.p.numpy()}


def start_cpu_expert_runs():
    """Start phase 24 (c)'s CPU runs, one worker process a (catalog, run),
    spawned, so that they overlap the card's phases 22-24."""
    import concurrent.futures
    import multiprocessing

    jobs = [(name, kind) for name in EXPERT_CATALOGS for kind in ("poisson", "drift")]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(jobs), mp_context=multiprocessing.get_context("spawn"))
    return pool, {job: pool.submit(cpu_expert_run, *job) for job in jobs}


def expert_step_time(torch, dev, name):
    """The cache's step on the card: EXPERT_WARM steps, then EXPERT_TIMED
    timed (its capacity, as benchmarks/serving_slo.py measures it) and as
    many profiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.expert_cache import OGBExpertCache

    payloads = expert_payloads(*EXPERT_CATALOGS[name], "poisson")
    ec = OGBExpertCache(expert_cache_config(name, "poisson"), seed=0, device=dev)
    for counts in payloads[:EXPERT_WARM]:
        ec.step(counts)
    t0 = time.perf_counter()
    for counts in payloads[:EXPERT_TIMED]:
        ec.step(counts)
    per_step = (time.perf_counter() - t0) / EXPERT_TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for counts in payloads[:EXPERT_TIMED]:
            ec.step(counts)
        prof_wall = time.perf_counter() - t0
    _, breakdown = profiled_chunks(torch, prof, EXPERT_TIMED, f"expert cache {name} step",
                                   per_step * EXPERT_TIMED, prof_wall)
    return per_step, {k: v for k, v in breakdown.items() if k != "port_kernels"}


def expert_run_on_card(torch, dev, name, kind, cpu, rate=None):
    """One (catalog, run) on the card, from the carry the CPU run started
    from (seed 0's p is drawn on the host), against the CPU run step by
    step: tau and f within EXPERT_TOL, the residency masks equal off
    |f - p| <= EXPERT_TOL, the records equal (the hit ratio within
    EXPERT_TOL) at the steps where no f was that close, and each step 50
    masses launches and one standalone apply.  Given ``rate``, the steps
    are ContinuousServingLoop's decisions over payloads arriving open-loop
    at ``rate`` a second, as benchmarks/serving_slo.py serves them."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousServingLoop
    from repro_torch.serve.expert_cache import OGBExpertCache

    ec = OGBExpertCache(expert_cache_config(name, kind), seed=0, device=dev)
    p = cpu["p"]
    need(np.array_equal(ec.carry.p.cpu().numpy(), p), f"{name} {kind}: p differs from the CPU's")
    payloads = expert_payloads(*EXPERT_CATALOGS[name], kind)
    fs = torch.empty((len(payloads), ec.N), dtype=torch.float32, device=dev)
    taus = torch.empty(len(payloads), dtype=torch.float32, device=dev)
    recs, bad_launches = [], []

    def decide(batch):
        t = len(recs)
        reset_launch_counts()
        recs.append(ec.step(batch[0]))
        got = launch_counts()
        if got["mass"] != 50 or got["apply"] != 1 or sum(got.values()) != 51:
            bad_launches.append(t)
        fs[t], taus[t] = ec.carry.f, ec.carry.tau

    if rate is None:
        slo = None
        for counts in payloads:
            decide([counts])
    else:
        slo = ContinuousServingLoop(decide).run(payloads, rate)
    fs, taus = fs.cpu().numpy(), taus.cpu().numpy()
    need(not bad_launches, f"{name} {kind}: steps {bad_launches[:5]} not 50 masses + 1 apply")
    d_f = float(np.abs(fs - cpu["f"]).max())
    d_tau = float(np.abs(taus - cpu["tau"]).max())
    f_prev = np.concatenate([np.full((1, ec.N), ec.C / ec.N, np.float32), cpu["f"][:-1]])
    near = np.abs(cpu["f"] - p) <= EXPERT_TOL
    near_step = near.any(axis=1) | (np.abs(f_prev - p) <= EXPERT_TOL).any(axis=1)
    mask_off = int(((fs >= p) != (cpu["f"] >= p))[~near].sum())
    d_hit = [abs(a["resident_hit_ratio"] - b["resident_hit_ratio"])
             for a, b in zip(recs, cpu["records"])]
    d_hit_all, d_hit = max(d_hit), max((d for d, n in zip(d_hit, near_step) if not n),
                                       default=0.0)

    def counted(r):
        return {k: v for k, v in r.items() if k != "resident_hit_ratio"}

    rec_off = sum(counted(a) != counted(b)
                  for a, b, n in zip(recs, cpu["records"], near_step) if not n)
    hits = [r["resident_hit_ratio"] for r in recs]
    windows = [round(float(np.mean(hits[k - 50:k])), 4) for k in range(100, len(hits) + 1, 100)]
    print(f"expert cache {name} ({ec.N} experts, C {ec.C}, eta {ec.eta:.6f}) {kind}, "
          f"{len(payloads)} steps, card against CPU: max |df| {d_f:.3e}, max |dtau| "
          f"{d_tau:.3e}, max |d hit ratio| {d_hit:.3e} ({d_hit_all:.3e} with the steps where "
          f"an expert was within {EXPERT_TOL} of its p); residency masks differ at {mask_off} "
          f"(step, expert) off |f - p| <= {EXPERT_TOL}, records at {rec_off} of "
          f"{int((~near_step).sum())} steps with no such expert; {int(near_step.sum())} steps "
          f"had one; hit ratio, mean of the 50 steps to each 100th: {windows}; swapped in "
          f"{ec.swapped_in}, out {ec.swapped_out}; launches 50 masses + 1 apply a step")
    need(d_f <= EXPERT_TOL and d_tau <= EXPERT_TOL and d_hit <= EXPERT_TOL and not mask_off
         and not rec_off, f"expert cache {name} {kind}: the card differs from the CPU")
    out = {"max_df": d_f, "max_dtau": d_tau, "max_dhit": d_hit, "max_dhit_all": d_hit_all,
           "near_steps": int(near_step.sum()), "hit_ratio_windows": windows,
           "swapped_in": ec.swapped_in, "swapped_out": ec.swapped_out}
    if kind == "drift":
        after = float(np.mean(hits[-50:]))
        print(f"expert cache {name}: hit ratio {after:.4f} over the last 50 of {DRIFT_STEPS} "
              f"steps, the hot experts moved at step {DRIFT_SHIFT} (step {DRIFT_SHIFT + 500}: "
              f"{float(np.mean(hits[DRIFT_SHIFT + 450:DRIFT_SHIFT + 500])):.4f})")
        need(after > 0.5, f"expert cache {name}: hit ratio {after} after the drift")
        out["hit_ratio_after_drift"] = after
    if slo is not None:
        print(f"expert cache {name} served open-loop: offered {rate:.1f} req/s, sustained "
              f"{slo.req_per_sec:.1f} req/s; decision latency p50 {slo.p50_ms:.3f} ms, p99 "
              f"{slo.p99_ms:.3f} ms, mean {slo.mean_ms:.3f} ms, max {slo.max_ms:.3f} ms; "
              f"backlog max {slo.backlog_max}; mean hit ratio {ec.mean_hit_ratio:.4f}")
        need(slo.requests == len(payloads) and slo.req_per_sec > 0.5 * rate,
             f"expert cache {name}: sustained {slo.req_per_sec} of an offered {rate}")
        out["slo"] = {"offered": rate, "sustained": slo.req_per_sec, "p50_ms": slo.p50_ms,
                      "p99_ms": slo.p99_ms, "mean_ms": slo.mean_ms, "max_ms": slo.max_ms,
                      "backlog_max": slo.backlog_max}
    return out


def time_grad_projection(torch, dev, flush):
    """ogb_grad's projection at kimi-k2's catalog: one K = 1 masses pass and
    the standalone apply, cold, beside their plain versions and bounds."""
    from repro_torch.kernels.capped_simplex.ops import apply, as_scalar, masses
    from repro_torch.kernels.capped_simplex.ref import apply_ref, masses_ref

    n = EXPERT_CATALOGS[DISPATCH_ARCH][0] * EXPERT_CATALOGS[DISPATCH_ARCH][1]
    gen = torch.Generator(device=dev).manual_seed(6)
    f = torch.rand(n, generator=gen, device=dev) * 0.5
    c = torch.rand(n, generator=gen, device=dev) / n
    eta, tau = as_scalar(2.0, dev), as_scalar(0.25, dev)
    taus = tau.reshape(1)
    rows = {}
    for name, kern, plain, out_bytes in (
            ("mass", lambda: masses(f, c, eta, taus), lambda: masses_ref(f, c, eta, taus), 8),
            ("apply", lambda: apply(f, c, eta, tau), lambda: apply_ref(f, c, eta, tau), 4 * n)):
        got, want = kern(), plain()
        got, want = (got, want) if name == "mass" else ((got,), (want,))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ms, plain_ms = timed_ms(torch, kern, 50, flush), timed_ms(torch, plain, 20, flush)
        b, by = bound_ms(8 * n + out_bytes, (2 + 7) * n if name == "mass" else 4 * n)
        print(f"ogb_grad's {name} at N = {n}: cold {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} "
              f"us, bound {b * 1e3:.4f} us by {by}), max |kernel - plain| {err:.3e}")
        need(err <= 1e-3 if name == "mass" else err <= 1e-6, f"ogb_grad's {name} off by {err}")
        rows[name] = {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "max_abs_err": err}
    return rows


def check_moe(torch, dev, cpu_runs):
    """Phase 24: MoE serving and the expert cache."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"MoE serving and the expert cache phase 24 on {nvidia_smi_line()}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated at its start")
    need(torch.cuda.memory_allocated(dev) < 4e9, "an earlier phase's weights are still held")
    served = serve_moe(torch, dev)
    t1 = time.perf_counter()
    dispatch = check_dispatch_layer(torch, dev)
    print(f"phase 24 (a) {t1 - t0:.2f} s, (b) {time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    experts = {}
    for name in EXPERT_CATALOGS:
        per_step, breakdown = expert_step_time(torch, dev, name)
        rate = LOAD_FACTOR / per_step
        print(f"expert cache {name}: a step {per_step * 1e3:.3f} ms on the card; served at "
              f"{LOAD_FACTOR} of that, {rate:.1f} req/s")
        experts[name] = {"ms_a_step": per_step * 1e3, "step_breakdown": breakdown}
        for kind in ("poisson", "drift"):
            cpu, secs = cpu_result(cpu_runs[name, kind], timeout=None)
            print(f"expert cache {name} {kind}: {secs:.2f} s waiting on the CPU run")
            experts[name][kind] = expert_run_on_card(torch, dev, name, kind, cpu,
                                                     rate if kind == "poisson" else None)
    projection = time_grad_projection(torch, dev, l2_flush(torch, dev))
    secs = time.perf_counter() - t0
    print(f"phase 24 (c) {time.perf_counter() - t1:.2f} s; phase 24: {secs:.2f} s")
    return {"served": served, "dispatch": dispatch, "experts": experts,
            "projection": projection, "seconds": secs}


# -- the remaining attention families (phase 25) -------------------------------------

#: (a) mistral-nemo with its int8 KV cache, served as phase 14 serves glm4-9b,
#: in FAMILY_CALLS generate calls; (b) phi-3-vision: SERVE_B prompts of its
#: n_image_tokens image embeddings and VLM_TEXT tokens, SERVE_NEW decode
#: steps; (c) whisper: SERVE_B utterances of n_audio_frames frames, a
#: WHISPER_PROMPT-token prompt and SERVE_NEW new tokens in its
#: WHISPER_MAX_LEN-token text context; F64_ROWS rows of an encoder call and
#: of a cross call held against float64; the int8 decode's split lengths
#: (tiles a split) timed beside its plan's; the D = 96 prefill's non-causal
#: calls: S = T = D96_T (an encoder's 1500 rows) and WHISPER_PROMPT over D96_T
INT8_ARCH, VLM_ARCH, ENCDEC_ARCH = "mistral-nemo-12b", "phi-3-vision-4.2b", "whisper-large-v3"
FAMILY_CALLS, VLM_TEXT, WHISPER_PROMPT, WHISPER_MAX_LEN, F64_ROWS = 2, 1792, 224, 448, 64
INT8_SPLIT_TILES, D96_T = (3, 4, 6, 9, 17), 1500

#: phase 26, the SSM family: rwkv6-1.6b served at full width and depth, and
#: its recurrence's kernel at the served layer's (B, S, H, n)
SSM_ARCH, WKV_SERVED = "rwkv6-1.6b", (SERVE_B, SERVE_S, 32, 64)
#: the kernel against its plain version, y and the final state: within this
#: share of the largest |value|.  Both are float32.  The kernel factors the
#: u term out (y_j = sum_i r_i S_ij + v_j ru_t, ru_t = sum_i r_i u_i k_i),
#: contracts r*S + acc, w*S + k*v and v*ru + sum into fmas, sums each column's
#: rows in P blocks in order and the P partials in order p = 0 .. P-1, and
#: ru_t over 4-element pieces then a pairwise tree (tests/
#: test_torch_wkv6_design.py models it); PyTorch's einsum sums in its own
#: order, and the state carries an error about 1 / (1 - w) = 400 steps at
#: w0 = -6 (1.6e-6 measured at S = 2048 in PR 30)
WKV_TOL = 1e-5
#: steps of the plain version that make a "mid-run" state
WKV_WARM = 256
#: w0 of each decay, w = exp(-exp(w0 + 0.12 N(0, 1))): ~0.9975 (rwkv6's w0),
#: ~0.5, exp(-e^2) ~ 6e-4, ~1 - 6e-6
WKV_DECAYS = {"slow": -6.0, "fast": math.log(math.log(2.0)), "near zero": 2.0,
              "near one": -12.0, "1e-3": math.log(-math.log(1e-3))}
#: (label, B, S, H, n, decay, start state); the "plan" cases, one a head
#: dim, run its Plan<n> (kernel.PLANS) over two chunks and a step
WKV_CASES = (
    ("served prefill", 8, 2048, 32, 64, "slow", "zero"),
    ("served, fast decay", 8, 2048, 32, 64, "fast", "mid-run"),
    ("served, near-zero decay", 8, 2048, 32, 64, "near zero", "mid-run"),
    ("served, from a mid-run state", 8, 2048, 32, 64, "slow", "mid-run"),
    ("decode step", 8, 1, 32, 64, "slow", "mid-run"),
    ("one past the served length", 8, 2049, 32, 64, "slow", "zero"),
    ("7 steps", 8, 7, 32, 64, "slow", "mid-run"),
    ("n=16", 4, 2049, 8, 16, "slow", "mid-run"),
    ("n=16, near-zero decay", 4, 2049, 8, 16, "near zero", "zero"),
    ("n=16 decode step", 4, 1, 8, 16, "fast", "mid-run"),
    ("n=32", 4, 2049, 8, 32, "slow", "zero"),
    ("n=32, 7 steps", 4, 7, 8, 32, "fast", "mid-run"),
    ("plan of n=16", 2, 33, 4, 16, "near one", "mid-run"),
    ("plan of n=32", 2, 33, 4, 32, "near one", "mid-run"),
    ("plan of n=64", 2, 33, 4, 64, "near one", "mid-run"),
)
#: prefill of S tokens against prefill of S - 1 and a decode step: tm_x and
#: cm_x (in the compute type) within this many bf16 ulps of their largest
#: |value| (the last token's products run at M = 8 rows in the step and
#: M = 16 384 in the prefill, so its bf16 activations may round apart, and
#: 24 layers carry it)
SPLIT_ULPS = 8
#: ... and the float32 WKV state tm_s within this share of its largest
#: |value|: 2.0e-4 measured (0.129 of 643.8 on an H100), with room for noise;
#: a step that skipped the decay would move it by (1 - w) |S|, about 2.5e-3
SPLIT_STATE_TOL = 1e-3


def family_against_plain(torch, cfg, params, batch, max_len, dev, first=None):
    """A model's prefill through the kernels against the same prefill through
    the plain versions on the card, then TEACHER_STEPS teacher-forced decode
    steps, the plain run from a copy of the kernels' prefill cache (an int8
    cache quantizes K and V that the two prefills round differently, so each
    step holds the decode kernels on the same cache).  ``first``: the tokens
    a generate call gave after this prefill."""
    import numpy as np

    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import decode_step, prefill

    V = cfg.vocab_size
    lk, ck = prefill(cfg, params, batch, max_len, dev)
    before = launch_counts()
    with plain_attention():
        lp, _ = prefill(cfg, params, batch, max_len, dev)
    need(launch_counts() == before, "the plain run launched a kernel")
    errs = [held_logits(torch, f"{cfg.name} prefill, last token", lk, lp, V)[0]]
    tok = torch.argmax(lk[:, :V], -1)
    if first is not None:
        need(np.array_equal(tok.cpu().numpy(), first), "prefill does not repeat generate")
    cp = {k: v.clone() if torch.is_tensor(v) else v for k, v in ck.items()}
    for step in range(TEACHER_STEPS):
        lk, ck = decode_step(cfg, params, ck, tok, dev)
        with plain_attention():
            lp, cp = decode_step(cfg, params, cp, tok, dev)
        errs.append(held_logits(torch, f"{cfg.name} decode step {step + 1}, teacher-forced",
                                lk, lp, V)[0])
        tok = torch.argmax(lk[:, :V], -1)
    return max(errs)


class first_prefill_calls:
    """Within this block the first flash_prefill call of each mode (causal,
    non-causal, cross) keeps its inputs in ``calls``; every call still runs
    the kernel and is counted."""

    def __enter__(self):
        from repro_torch.kernels.flash_prefill.kernel import mode
        from repro_torch.models import attention

        self.saved, self.calls = attention.flash_prefill, {}

        def record(q, k, v, causal=True):
            self.calls.setdefault(mode(q, k, causal), (q, k, v))
            return self.saved(q, k, v, causal)

        attention.flash_prefill = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_prefill = self.saved


def rows_against_f64(torch, label, q, k, v, out, gen):
    """F64_ROWS sampled (sequence, query row, head) rows of a non-causal call's
    output against float64 attention over the same bf16 inputs, within one
    bf16 ulp of the largest of them."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    b = torch.randint(0, B, (F64_ROWS,), generator=gen, device=q.device)
    s = torch.randint(0, S, (F64_ROWS,), generator=gen, device=q.device)
    h = torch.randint(0, H, (F64_ROWS,), generator=gen, device=q.device)
    qr = q[b, s, h].double()  # (R, D)
    kr, vr = k[b, :, h // g].double(), v[b, :, h // g].double()  # (R, T, D)
    w = torch.softmax(torch.einsum("rd,rtd->rt", qr, kr) / math.sqrt(D), dim=-1)
    want = torch.einsum("rt,rtd->rd", w, vr)
    err = float((out[b, s, h].double() - want).abs().max())
    tol = 2.0 ** -7 * float(want.abs().max())
    print(f"{label}: {F64_ROWS} sampled rows against float64 attention: max err {err:.3e} "
          f"(limit {tol:.3e}, one bf16 ulp of the largest)")
    need(err <= tol, f"{label}: rows differ from float64 by {err}")
    return err


def int8_decode_rows(torch, dev, cfg, flush):
    """Phase 25 (a): the int8 decode kernel at the served shape (SERVE_B
    sequences, the SERVE_S + SERVE_NEW cache, lengths SERVE_S + 1 ..) and at
    lengths around its 64-position tile, a warp's 16-position slices, its
    3-slice ring and its plan's split against its plain version; timed
    beside the bf16-cache kernel over the same K and V unquantized, its
    bound and scaled_dot_product_attention over the dequantized cache;
    beside its PR 28 design in turns (tools/time_int8_decode_designs.py);
    and at split lengths around its plan's, launched through the C entry
    point (not counted)."""
    import torch.nn.functional as F
    from time_int8_decode_designs import time_designs

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref, dequantize
    from repro_torch.models.attention import _quantize_kv

    bf, B, S = torch.bfloat16, SERVE_B, SERVE_S + SERVE_NEW
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(25)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf)
    kv = torch.randn(2, B, S, Hkv, D, generator=gen, device=dev).to(bf)
    codes, scales = _quantize_kv(kv)
    k8, v8, ks, vs = codes[0], codes[1], scales[0], scales[1]
    served = torch.arange(SERVE_S + 1, SERVE_S + 1 + B, device=dev,
                          dtype=torch.int32).clamp(max=S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_len = dk.mma_grid_plan(B, H, Hkv, S, D, sms, int8=True)[1]
    errs = []
    for name, lengths in (("served", served.tolist()),
                          ("tile", [1, 63, 64, 65, 127, 128, 129, S]),
                          ("slices", [15, 16, 17, 31, 32, 33, 47, 49]),
                          ("ring", [191, 192, 193, 255, 256, 257, SERVE_S + 1, S]),
                          ("split", [plan_len - 1, plan_len, plan_len + 1, 2 * plan_len - 1,
                                     2 * plan_len, 2 * plan_len + 1, S - 1, S])):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        errs.append(_held(torch, f"decode int8 {INT8_ARCH} bf16 B={B} H={H} Hkv={Hkv} D={D} "
                                 f"S={S} lengths {name} [{dk.design(bf, D)}]",
                          decode_attention(q, k8, v8, lens, ks, vs),
                          decode_attention(q, k8, v8, lens, ks, vs),
                          decode_attention_ref(q, k8, v8, lens, ks, vs), bf))
    kd, vd = dequantize(k8, ks, bf), dequantize(v8, vs, bf)
    mask = (torch.arange(S, device=dev)[None, :] < served[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2)
    valid = int(served.sum())
    # the int8 codes and scales of every valid position read once; q, out, lengths once
    n_bytes = 2 * valid * Hkv * D + 2 * 4 * valid * Hkv + 2 * 2 * B * H * D + 4 * B
    row = measure_attention(
        torch, "decode_attention", f"int8 cache B={B} S={S} (lengths {SERVE_S + 1}..)",
        (lambda: decode_attention(q, k8, v8, served, ks, vs),
         lambda: decode_attention_ref(q, k8, v8, served, ks, vs),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True),
         bound_ms(n_bytes, 4 * valid * H * D, BF16_OPS_PER_S)), 10, flush)
    bf16_bytes = 2 * 2 * valid * Hkv * D + 2 * 2 * B * H * D + 4 * B
    bf16_row = measure_attention(
        torch, "decode_attention", f"bf16 cache, the same K and V B={B} S={S}",
        (lambda: decode_attention(q, kv[0], kv[1], served),
         lambda: decode_attention_ref(q, kv[0], kv[1], served),
         lambda: F.scaled_dot_product_attention(qt, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                                                attn_mask=mask, enable_gqa=True),
         bound_ms(bf16_bytes, 4 * valid * H * D, BF16_OPS_PER_S)), 10, flush)
    print(f"int8 decode {row['ms'] * 1e3:.2f} us against the bf16-cache kernel's "
          f"{bf16_row['ms'] * 1e3:.2f} us at the same shape; bounds {row['bound_ms'] * 1e3:.2f} "
          f"and {bf16_row['bound_ms'] * 1e3:.2f} us; {nvidia_smi_line()}")
    earlier = time_designs(torch, q, k8, v8, ks, vs, served, flush)
    smem = dk.decode_plan(D, int8=True)["smem_bytes"]
    want = decode_attention_ref(q, k8, v8, served, ks, vs)
    splits = {}
    for t in INT8_SPLIT_TILES:
        split_len = dk.TILE * t
        n_splits = -(-S // split_len)
        part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)

        def call():
            _build.check(dk._entry_mma()(
                q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                served.data_ptr(), B, H, Hkv, D, S, n_splits, split_len, 1.0 / math.sqrt(D), smem,
                part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "int8 decode split sweep")

        call()
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        need(err <= 2.0 ** -7 * float(want.float().abs().max()),
             f"int8 decode split sweep, {t} tiles a split: |kernel - plain| = {err}")
        ms = timed_ms(torch, call, 20, flush)
        mark = " [mma_grid_plan]" if split_len == plan_len else ""
        print(f"int8 decode split sweep S={S}: {t} tiles a split, {n_splits} splits, "
              f"{B * Hkv * n_splits} blocks{mark}: cold {ms * 1e3:.2f} us (both passes)")
        splits[t] = ms
    return {**row, "max_abs_err": max(errs), "design": dk.design(bf, D),
            "shape": f"B={B} H={H} Hkv={Hkv} D={D} S={S} lengths {SERVE_S + 1}..{S}",
            "bf16_cache": {k: bf16_row[k] for k in ("ms", "warm_ms", "bound_ms", "library_ms")},
            "earlier": {k: earlier[k] for k in ("ms", "earlier_ms", "turns", "plan",
                                                "earlier_plan", "earlier_design")},
            "split_tiles_ms": splits, "plan_split_tiles": plan_len // dk.TILE}


def serve_int8(torch, dev, flush):
    """Phase 25 (a): mistral-nemo at full width, all 40 layers, its int8 KV
    cache, served behind an OGB page pool in FAMILY_CALLS generate calls;
    its logits against the plain versions'; the int8 decode timed."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import design_counts

    engine, prompts, first_out, launches, steady = serve_full_width(torch, dev, INT8_ARCH,
                                                                    calls=FAMILY_CALLS)
    cfg, L = engine.cfg, engine.cfg.n_layers
    designs = design_counts()
    want = {"flash_prefill": {"wgmma+tma, causal": L * FAMILY_CALLS},
            "decode_attention": {"mma.sync+cp.async, int8 cache": L * SERVE_NEW * FAMILY_CALLS}}
    print(f"{INT8_ARCH} launches by design and mode: {designs}")
    need(cfg.kv_cache_dtype == "int8" and all(designs.get(k) == v for k, v in want.items()),
         f"{INT8_ARCH}: launches by mode {designs}, expected {want}")
    err = family_against_plain(torch, cfg, engine.params,
                               {"tokens": torch.from_numpy(prompts).to(dev)}, engine.max_len,
                               dev, first_out[:, 0])
    del engine
    torch.cuda.empty_cache()
    decode = int8_decode_rows(torch, dev, get_arch(INT8_ARCH), flush)
    return {"serving": steady, "launches": launches, "max_logit_err": err, "decode": decode}


def d96_prefill_rows(torch, dev, cfg, flush):
    """Phase 25 (b): the D = 96 prefill (the wgmma design) against its plain
    version non-causal (S = T = D96_T), cross (WHISPER_PROMPT rows over
    D96_T) and causal at the served shape (SERVE_B prompts of the image
    embeddings and VLM_TEXT tokens), each launch counted by design and mode;
    at the served shape timed cold beside the CUDA-core design it replaced
    (the same inputs, through its C entry point, uncounted), the plain
    version, scaled_dot_product_attention and its bound, in one call."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, design_counts, reset_launch_counts
    from repro_torch.kernels.flash_prefill import kernel as pk
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    bf, B, S = torch.bfloat16, SERVE_B, cfg.n_image_tokens + VLM_TEXT
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(96)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    errs = {}
    for mode, rows, keys in (("non-causal", D96_T, D96_T), ("cross", WHISPER_PROMPT, D96_T),
                             ("causal", S, S)):
        q, k, v = randn(B, rows, H, D), randn(B, keys, Hkv, D), randn(B, keys, Hkv, D)
        causal = mode == "causal"
        reset_launch_counts()
        errs[mode] = _held(torch, f"prefill {VLM_ARCH} D={D} {mode} B={B} S={rows} T={keys} "
                                  f"H={H} Hkv={Hkv} [{pk.design(bf, D)}]",
                           flash_prefill(q, k, v, causal), flash_prefill(q, k, v, causal),
                           flash_prefill_ref(q, k, v, causal), bf)
        want = {f"{pk.design(bf, D)}, {mode}": 2}
        need(pk.design(bf, D) == pk.WGMMA and design_counts()["flash_prefill"] == want,
             f"D={D} {mode}: launches {design_counts()['flash_prefill']}, expected {want}")
        if not causal:
            del q, k, v
            torch.cuda.empty_cache()
    core_out = torch.empty_like(q)

    def cuda_core():  # the CUDA-core design at the same inputs
        _build.check(pk._entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), core_out.data_ptr(),
                                 None, B, S, S, H, Hkv, D, 1.0 / math.sqrt(D), 1, 1,
                                 _build.stream_of(q)), "flash_prefill (cuda-core)")

    cuda_core()
    torch.cuda.synchronize()
    want = flash_prefill_ref(q, k, v)
    core_err = float((core_out.float() - want.float()).abs().max())
    need(core_err <= 2.0 ** -7 * float(want.float().abs().max()),
         f"the CUDA-core D={D} prefill: |kernel - plain| = {core_err}")
    del want
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = timed_ms(torch, lambda: flash_prefill(q, k, v), 20, flush)
    warm = timed_ms(torch, lambda: flash_prefill(q, k, v), 20)
    core_ms = timed_ms(torch, cuda_core, 3, flush)
    plain_ms = timed_ms(torch, lambda: flash_prefill_ref(q, k, v), 3, flush)
    lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                    enable_gqa=True), 20, flush)
    # 4 B H (S^2 / 2) D operations over the bf16 tensor-core peak
    b, by = bound_ms(2 * (2 * B * S * H * D + 2 * B * S * Hkv * D),
                     4 * B * H * (S * S / 2) * D, BF16_OPS_PER_S)
    print(f"flash_prefill {VLM_ARCH} D={D} B={B} S={S}: cold {ms * 1e3:.2f} us, warm in L2 "
          f"{warm * 1e3:.2f} us [{pk.design(bf, D)}]; the CUDA-core design at the same inputs "
          f"{core_ms * 1e3:.2f} us ({core_ms / ms:.2f}x); plain {plain_ms * 1e3:.2f} us, "
          f"scaled_dot_product_attention {lib_ms * 1e3:.2f} us, bound {b * 1e3:.3f} us by {by}; "
          f"kernel / library {ms / lib_ms:.2f}; {nvidia_smi_line()}")
    return {"ms": ms, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, "earlier_ms": core_ms, "earlier_design": pk.CUDA_CORE,
            "max_abs_err": errs["causal"], "max_abs_err_by_mode": errs,
            "earlier_max_abs_err": core_err}


def serve_vlm(torch, dev, flush):
    """Phase 25 (b): phi-3-vision at full width, all 32 layers: prefill of
    SERVE_B prompts of its image embeddings (a seeded normal) and VLM_TEXT
    tokens, SERVE_NEW decode steps, and its D = 96 prefill's rows
    (d96_prefill_rows)."""
    import numpy as np

    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_prefill.kernel import design as prefill_design
    from repro_torch.models.model import decode_step, prefill

    cfg, params = draw_full_width(torch, dev, VLM_ARCH)
    L, V, n_img = cfg.n_layers, cfg.vocab_size, cfg.n_image_tokens
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.default_rng(25)
    batch = {"tokens": torch.from_numpy(rng.integers(1, V, (SERVE_B, VLM_TEXT))).to(dev),
             "image_embeds": torch.randn(SERVE_B, n_img, cfg.d_model, generator=gen,
                                         device=dev).to(torch.bfloat16)}
    max_len = n_img + VLM_TEXT + SERVE_NEW
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, max_len, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.argmax(logits[:, :V], -1)
    first = tok.cpu().numpy()
    for _ in range(SERVE_NEW):
        logits, cache = decode_step(cfg, params, cache, tok, dev)
        tok = torch.argmax(logits[:, :V], -1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, designs = launch_counts(), design_counts()
    print(f"{VLM_ARCH}: prefill of {SERVE_B} x ({n_img} image + {VLM_TEXT} text) positions "
          f"{t1 - t0:.4f} s, decode {(t2 - t1) * 1e3 / SERVE_NEW:.3f} ms a step; launches by "
          f"design and mode {designs}")
    want = {"flash_prefill": {f"{prefill_design(torch.bfloat16, cfg.head_dim)}, causal": L},
            "decode_attention": {"mma.sync+cp.async, compute-type cache": L * SERVE_NEW}}
    need(cache["pos"] == max_len and bool(torch.isfinite(logits[:, :V]).all()),
         f"{VLM_ARCH}: cache at {cache['pos']}, or non-finite logits")
    need(all(designs.get(k) == v for k, v in want.items())
         and sum(launches.values()) == L * (1 + SERVE_NEW),
         f"{VLM_ARCH}: launches {launches} by mode {designs}, expected {want}")
    del cache, logits
    err = family_against_plain(torch, cfg, params, batch, max_len, dev, first)
    del params, batch
    torch.cuda.empty_cache()
    timed = d96_prefill_rows(torch, dev, cfg, flush)
    torch.cuda.empty_cache()
    return {"prefill_s": t1 - t0, "decode_ms_a_step": (t2 - t1) * 1e3 / SERVE_NEW,
            "launches": {k: launches[k] for k in ("flash_prefill", "decode_attention")},
            "max_logit_err": err,
            "prefill_d96": {**timed, "design": prefill_design(torch.bfloat16, cfg.head_dim),
                            "shape": f"B={SERVE_B} S={n_img + VLM_TEXT} H={cfg.n_heads} "
                                     f"Hkv={cfg.n_kv_heads} D={cfg.head_dim}"}}


def non_causal_job(torch, dev, S, T, H, D, seed):
    """A timed non-causal call of S query rows over T keys (B = SERVE_B,
    H = Hkv, bf16): kernel, plain version, one scaled_dot_product_attention
    call and the bound (4 B H S T D operations at the bf16 tensor-core peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(SERVE_B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(SERVE_B, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n_bytes = 2 * (2 * SERVE_B * S * H * D + 2 * SERVE_B * T * H * D)
    return (lambda: flash_prefill(q, k, v, causal=False),
            lambda: flash_prefill_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            bound_ms(n_bytes, 4 * SERVE_B * H * S * T * D, BF16_OPS_PER_S))


def serve_encdec(torch, dev, flush):
    """Phase 25 (c): whisper at full width, 32 encoder and 32 decoder layers:
    prefill of SERVE_B utterances (frames a seeded normal) and
    WHISPER_PROMPT-token prompts, SERVE_NEW decode steps; rows of its first
    encoder and cross calls against float64; both new modes timed."""
    import numpy as np

    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.models.model import decode_step, prefill

    cfg, params = draw_full_width(torch, dev, ENCDEC_ARCH)
    L, V, T = cfg.n_layers, cfg.vocab_size, cfg.n_audio_frames
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.default_rng(25)
    batch = {"tokens": torch.from_numpy(rng.integers(1, V, (SERVE_B, WHISPER_PROMPT))).to(dev),
             "frames": torch.randn(SERVE_B, T, cfg.d_model, generator=gen,
                                   device=dev).to(torch.bfloat16)}
    reset_launch_counts()
    t0 = time.perf_counter()
    with first_prefill_calls() as rec:
        logits, cache = prefill(cfg, params, batch, WHISPER_MAX_LEN, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.argmax(logits[:, :V], -1)
    first = tok.cpu().numpy()
    for _ in range(SERVE_NEW):
        logits, cache = decode_step(cfg, params, cache, tok, dev)
        tok = torch.argmax(logits[:, :V], -1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, designs = launch_counts(), design_counts()
    print(f"{ENCDEC_ARCH}: prefill of {SERVE_B} x ({T} frames, {WHISPER_PROMPT} tokens) "
          f"{t1 - t0:.4f} s, decode {(t2 - t1) * 1e3 / SERVE_NEW:.3f} ms a step; launches by "
          f"design and mode {designs}")
    want = {"flash_prefill": {"wgmma+tma, non-causal": cfg.n_encoder_layers,
                              "wgmma+tma, causal": L, "wgmma+tma, cross": L},
            "decode_attention": {"mma.sync+cp.async, compute-type cache": 2 * L * SERVE_NEW}}
    need(cache["pos"] == WHISPER_PROMPT + SERVE_NEW
         and bool(torch.isfinite(logits[:, :V]).all()),
         f"{ENCDEC_ARCH}: cache at {cache['pos']}, or non-finite logits")
    need(all(designs.get(k) == v for k, v in want.items())
         and sum(launches.values()) == 3 * L + 2 * L * SERVE_NEW,
         f"{ENCDEC_ARCH}: launches {launches} by mode {designs}, expected {want}")
    del cache, logits
    f64 = {}
    for name in ("non-causal", "cross"):
        q, k, v = rec.calls[name]
        f64[name] = rows_against_f64(torch, f"{ENCDEC_ARCH} first {name} call {tuple(q.shape)} "
                                            f"over {tuple(k.shape)}",
                                     q, k, v, flash_prefill(q, k, v, causal=False), gen)
    del rec
    err = family_against_plain(torch, cfg, params, batch, WHISPER_MAX_LEN, dev, first)
    del params, batch
    torch.cuda.empty_cache()
    timed = {}
    for name, S in (("non_causal", T), ("cross", WHISPER_PROMPT)):
        timed[name] = measure_attention(
            torch, "flash_prefill", f"{name} B={SERVE_B} S={S} T={T} H={cfg.n_heads} "
                                    f"D={cfg.head_dim}",
            non_causal_job(torch, dev, S, T, cfg.n_heads, cfg.head_dim, 26), 3, flush)
        timed[name].update(shape=f"B={SERVE_B} S={S} T={T} H=Hkv={cfg.n_heads} D={cfg.head_dim}",
                           max_abs_err_f64_rows=f64["non-causal" if S == T else "cross"])
        torch.cuda.empty_cache()
    return {"prefill_s": t1 - t0, "decode_ms_a_step": (t2 - t1) * 1e3 / SERVE_NEW,
            "launches": {k: launches[k] for k in ("flash_prefill", "decode_attention")},
            "launches_by_mode": designs, "cross_decode_launches": L * SERVE_NEW,
            "max_logit_err": err, "timed": timed}


def check_families(torch, dev):
    """Phase 25: the remaining attention families at full width and depth,
    each drawn in bf16 on the card and freed before the next."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"attention families phase 25 on {nvidia_smi_line()}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated at its start")
    need(torch.cuda.memory_allocated(dev) < 4e9, "an earlier phase's weights are still held")
    flush = l2_flush(torch, dev)
    out, secs = {}, {}
    for name, fn in (("int8", serve_int8), ("vlm", serve_vlm), ("encdec", serve_encdec)):
        t1 = time.perf_counter()
        out[name] = fn(torch, dev, flush)
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t1
        print(f"phase 25 {name}: {secs[name]:.2f} s on {nvidia_smi_line()}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 25: {out['seconds']:.2f} s ({secs})")
    return out


# -- the SSM family (phase 26) --------------------------------------------------------

def wkv6_inputs(torch, dev, B, S, H, n, seed, decay="slow", state="zero"):
    """The recurrence's inputs at (B, S, H, n), drawn on the card: r, k, v
    N(0, 1) (the served model's projections of a normed x are of unit
    scale), w = exp(-exp(w0 + 0.12 N(0, 1))) at w0 = WKV_DECAYS[decay] (the
    "slow" -6 is w0's N(0, 0.1) - 6 with its LoRA's spread, about 0.9975), u
    0.1 N(0, 1); the state zero or, "mid-run", the plain version's after
    WKV_WARM steps of such inputs from zero."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(steps):
        r, k, v = (torch.randn(B, steps, H, n, generator=gen, device=dev) for _ in range(3))
        w = torch.exp(-torch.exp(WKV_DECAYS[decay] + 0.12 * torch.randn(
            B, steps, H, n, generator=gen, device=dev)))
        return r, k, v, w

    u = 0.1 * torch.randn(H, n, generator=gen, device=dev)
    s0 = torch.zeros(B, H, n, n, device=dev)
    if state == "mid-run":
        s0 = wkv6_ref(*draw(WKV_WARM), u, s0)[1].contiguous()
    return (*draw(S), u, s0)


def wkv6_errors(torch, y, s, want_y, want_s):
    """max |kernel - plain| over the largest |plain|, of y and of the state."""
    return {"y": float((y - want_y).abs().max()) / float(want_y.abs().max()),
            "state": float((s - want_s).abs().max()) / float(want_s.abs().max())}


def check_wkv6_kernel(torch, dev, flush):
    """Phase 26 (a): the WKV-6 kernel against its plain version on the card
    at WKV_CASES, each from a copy of its state, y and the final state within
    WKV_TOL of the largest magnitude, two runs bit for bit; at the served
    layer and a decode step timed cold beside its PR 30 design in turns, its
    bound, the plain version and the floor (tools/time_wkv6_designs.py);
    warm at the served layer."""
    from tools.time_wkv6_designs import time_designs

    from repro_torch.kernels.wkv6.kernel import PLANS, launch
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    need({n for _, _, _, _, n, _, _ in WKV_CASES} == set(PLANS), "a head dim without a case")
    worst, served = 0.0, None
    for i, (label, B, S, H, n, decay, state) in enumerate(WKV_CASES):
        r, k, v, w, u, s0 = wkv6_inputs(torch, dev, B, S, H, n, seed=26 + i, decay=decay,
                                         state=state)
        s1, s2 = s0.clone(), s0.clone()
        y1, y2 = launch(r, k, v, w, u, s1), launch(r, k, v, w, u, s2)
        want_y, want_s = wkv6_ref(r, k, v, w, u, s0)
        errs = wkv6_errors(torch, y1, s1, want_y, want_s)
        abs_err = float((y1 - want_y).abs().max())
        print(f"wkv6 {label} B={B} S={S} H={H} n={n} (plan P, C = {PLANS[n]}), {decay} decay, "
              f"{state} state: |kernel - plain| / largest: y {errs['y']:.3e}, state "
              f"{errs['state']:.3e} (limit {WKV_TOL:.0e}; max |y| {float(want_y.abs().max()):.3f}, "
              f"max |S| {float(want_s.abs().max()):.3f})")
        need(bool(torch.isfinite(y1).all() and torch.isfinite(s1).all())
             and float(y1.abs().max()) > 0, f"wkv6 {label}: empty, zero or non-finite")
        need(max(errs.values()) <= WKV_TOL, f"wkv6 {label}: {errs} > {WKV_TOL}")
        need(torch.equal(y1, y2) and torch.equal(s1, s2), f"wkv6 {label}: two runs differ")
        worst = max(worst, max(errs.values()))
        if (B, S, H, n) == WKV_SERVED and state == "zero" and decay == "slow":
            served = {"max_abs_err": abs_err, "relative_err": errs}
    need(served is not None, "no served-shape case")
    timed = time_designs(torch, dev, flush)
    B, S, H, n = WKV_SERVED
    r, k, v, w, u, s0 = wkv6_inputs(torch, dev, B, S, H, n, seed=26)
    work = s0.clone()
    warm = timed_ms(torch, lambda: launch(r, k, v, w, u, work), 20,
                    reset=lambda: work.copy_(s0))
    cold = timed["served"]
    print(f"wkv6 served layer B={B} S={S} H={H} n={n}: cold {cold['ms'] * 1e3:.2f} us (PR 30's "
          f"design {cold['earlier_ms'] * 1e3:.2f}), warm in L2 {warm * 1e3:.2f} us (plain "
          f"{cold['plain_ms'] * 1e3:.1f} us, library call: none, bound "
          f"{cold['bound_ms'] * 1e3:.2f} us by {cold['bound_by']}; kernel / bound "
          f"{cold['ms'] / cold['bound_ms']:.2f}); decode step {timed['decode']['ms'] * 1e3:.2f} us "
          f"(PR 30's design {timed['decode']['earlier_ms'] * 1e3:.2f}, floor "
          f"{timed['floor_ms'] * 1e3:.2f})")
    return {"ms": cold["ms"], "warm_ms": warm, "plain_ms": cold["plain_ms"],
            "bound_ms": cold["bound_ms"], "bound_by": cold["bound_by"], "library_ms": None,
            "earlier_ms": cold["earlier_ms"], "earlier_design": timed["earlier_design"],
            "turns": cold["turns"], "decode_step": timed["decode"], "floor_ms": timed["floor_ms"],
            "plans": {str(n): list(pc) for n, pc in PLANS.items()},
            **served, "worst_relative_err": worst, "cases": len(WKV_CASES)}


class plain_wkv:
    """Within this block the RWKV layers run the plain version on the card
    (the state written into the tensor given, as the wrapper does), and no
    kernel is launched."""

    def __enter__(self):
        from repro_torch.kernels.wkv6.ref import wkv6_ref
        from repro_torch.models import rwkv

        def plain(r, k, v, w, u, state):
            y, final = wkv6_ref(r, k, v, w, u, state)
            state.copy_(final)
            return y, state

        self.saved, rwkv.wkv6 = rwkv.wkv6, plain

    def __exit__(self, *exc):
        from repro_torch.models import rwkv

        rwkv.wkv6 = self.saved


def held_cache(torch, label, got, want):
    """tm_x and cm_x within SPLIT_ULPS bf16 ulps of their largest |value|,
    the float32 tm_s within SPLIT_STATE_TOL of its largest |value|."""
    errs = {}
    for name in ("tm_x", "tm_s", "cm_x"):
        a, b = got[name].float(), want[name].float()
        top = float(b.abs().max())
        errs[name] = float((a - b).abs().max())
        if name == "tm_s":
            tol, why = SPLIT_STATE_TOL * top, f"{SPLIT_STATE_TOL:.0e} of"
        else:
            tol, why = SPLIT_ULPS * bf16_ulp(top), f"{SPLIT_ULPS} bf16 ulps of"
        print(f"{label}, {name}: max |difference| {errs[name]:.4e} (limit {tol:.4e}, "
              f"{why} the largest {top:.4f})")
        need(errs[name] <= tol, f"{label}: {name} differs by {errs[name]}")
    return errs


def check_ssm_against_plain(torch, engine, prompts, first_out):
    """Phase 26 (c): the served rwkv6 through the kernel against the same
    model through the plain version on the card: last-token logits after
    prefill and TEACHER_STEPS teacher-forced decode steps within phase 15's
    8 bf16 ulps of the largest |logit|, the plain steps from a copy of the
    kernel's prefill state (as phase 25 holds the int8 decode: each step
    holds the decode kernel on the same state); beside them, printed as a
    yardstick, the plain steps from the plain prefill's own state, which
    carries how far bf16 rounding spreads the prefill's difference over 24
    layers and 2048 steps; and prefill of S tokens against prefill of S - 1
    and one decode step, through the kernel."""
    import numpy as np

    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import decode_step, prefill

    cfg, params, dev, V = engine.cfg, engine.params, engine.device, engine.cfg.vocab_size
    tokens = torch.from_numpy(prompts).to(dev)
    t0 = time.perf_counter()
    lk, ck = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    before = launch_counts()
    with plain_wkv():
        lp, cp = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    torch.cuda.synchronize()
    need(launch_counts() == before, "the plain run launched a kernel")
    print(f"{cfg.name}: a prefill through the kernel and one through the plain version in "
          f"{time.perf_counter() - t0:.2f} s")
    errs = [held_logits(torch, f"{cfg.name} prefill, last token", lk, lp, V)[0]]
    state = float((ck["tm_s"] - cp["tm_s"]).abs().max()) / float(cp["tm_s"].abs().max())
    print(f"{cfg.name} prefill: the kernel's states against the plain version's, max "
          f"|difference| / largest {state:.3e} over the {cfg.n_layers} layers")
    tok = torch.argmax(lk[:, :V], -1)
    need(np.array_equal(tok.cpu().numpy(), first_out[:, 0]), "prefill does not repeat generate")
    cq = {k: v.clone() if torch.is_tensor(v) else v for k, v in ck.items()}
    own = []
    for step in range(TEACHER_STEPS):
        lk, ck = decode_step(cfg, params, ck, tok, dev)
        with plain_wkv():
            lq, cq = decode_step(cfg, params, cq, tok, dev)
            lp, cp = decode_step(cfg, params, cp, tok, dev)
        errs.append(held_logits(torch, f"{cfg.name} decode step {step + 1}, teacher-forced",
                                lk, lq, V)[0])
        own.append(float((lk[:, :V].float() - lp[:, :V].float()).abs().max()))
        tok = torch.argmax(lk[:, :V], -1)
    print(f"yardstick, the plain steps from the plain prefill's own state: max |logit kernels - "
          f"plain| by step {[round(e, 6) for e in own]}")
    # prefill(S) against prefill(S - 1) and one decode step, both through the kernel
    whole_logits, whole = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    part_logits, part = prefill(cfg, params, {"tokens": tokens[:, :-1]}, engine.max_len, dev)
    part_logits, part = decode_step(cfg, params, part, tokens[:, -1], dev)
    split_err = held_logits(torch, f"{cfg.name} prefill of {tokens.shape[1]} against "
                            f"{tokens.shape[1] - 1} and a decode step", part_logits,
                            whole_logits, V)[0]
    split_cache = held_cache(torch, f"{cfg.name} prefill against prefill and a decode step",
                             part, whole)
    need(part["pos"] == whole["pos"] == tokens.shape[1], "the split run's position")
    return {"max_logit_err": max(errs), "prefill_state_relative_err": state,
            "own_state_decode_logit_err": own,
            "split_logit_err": split_err, "split_cache_err": split_cache}


def check_ssm(torch, dev):
    """Phase 26: the SSM family.  (a) the WKV-6 kernel against its plain
    version and timed; (b) rwkv6-1.6b at full width and depth, random bf16
    weights (w0 and u float32) drawn on the card, served behind an OGB page
    pool in SERVE_CALLS generate calls as phase 14 serves glm4-9b, exactly
    n_layers * (1 + SERVE_NEW) wkv6 launches a call and no attention launch;
    (c) its logits against the plain version's, and prefill against a
    shorter prefill and a decode step."""
    import gc

    from repro_torch.kernels import design_counts

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"SSM family phase 26 on {nvidia_smi_line()}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated at its start")
    need(torch.cuda.memory_allocated(dev) < 4e9, "an earlier phase's weights are still held")
    flush = l2_flush(torch, dev)
    kernel = check_wkv6_kernel(torch, dev, flush)
    del flush
    t1 = time.perf_counter()
    engine, prompts, first_out, launches, steady = serve_full_width(torch, dev, SSM_ARCH)
    L = engine.cfg.n_layers
    kept = {name: str(engine.params["blocks"][0][name].dtype) for name in ("w0", "u", "w_k")}
    print(f"{SSM_ARCH} served leaves: {kept}")
    need(kept == {"w0": "torch.float32", "u": "torch.float32", "w_k": "torch.bfloat16"},
         f"{SSM_ARCH}: w0 and u are not float32 beside bf16 weights: {kept}")
    designs = design_counts()
    print(f"{SSM_ARCH} launches by design: {designs}")
    need(designs.get("wkv6") == {DESIGNS["wkv6"]: L * (1 + SERVE_NEW) * SERVE_CALLS},
         f"{SSM_ARCH}: wkv6 launches by design {designs.get('wkv6')}")
    t2 = time.perf_counter()
    against = check_ssm_against_plain(torch, engine, prompts, first_out)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    secs = {"kernel": t1 - t0, "serving": t2 - t1, "against_plain": time.perf_counter() - t2,
            "all": time.perf_counter() - t0}
    print(f"phase 26: {secs['all']:.2f} s ({secs}) on {nvidia_smi_line()}")
    return {"kernel": kernel, "serving": steady, "launches": launches,
            "launches_a_generate": L * (1 + SERVE_NEW), **against, "seconds": secs}


# -- the hybrid family (phase 27) -----------------------------------------------------

#: phase 27, the hybrid family: jamba-1.5-large at full width, its depth cut
#: from 72 layers (9 super-blocks of 8) to one super-block of HYBRID_LAYERS:
#: Mamba + MLP, Mamba + MoE, Mamba + MLP, attention + MoE, every layer kind
#: of the full model at its width, 23 776 305 152 parameters (47.55 GB in
#: bf16; a super-block of 8 holds 47.0 G, 94.0 GB, past the card's 80 GB)
HYBRID_ARCH, HYBRID_LAYERS = "jamba-1.5-large-398b", 4
#: the scan at the served layer: (B, S, d_in, n)
SCAN_SERVED = (SERVE_B, SERVE_S, 16384, 16)
#: the kernel against its plain version, y and the final state: within this
#: share of the largest |value|.  Both are float32 and round every step in
#: the reference's order (exp(dt A), (dt x) B, dec h + drv); the plain
#: version's einsum sums y over n in its own order, about 1e-7 of |y|
SCAN_TOL = 1e-5
#: steps of the plain version that make a "mid-run" state
SCAN_WARM = 256
#: dt = softplus(c + s N(0, 1)) for (c, s): "served", the served layer's
#: (dt_bias 0, xin @ w_dt at w_dt's scale 0.01 over d_in 16 384: s ~ 0.6,
#: dt ~ 0.7); "slow", dt ~ 1e-3; "fast", dt ~ 5
SCAN_DT = {"served": (0.0, 0.6), "slow": (math.log(math.expm1(1e-3)), 0.1), "fast": (5.0, 0.1)}
#: (label, B, S, d_in, n, dt, start state)
SCAN_CASES = (
    ("served prefill", 8, 2048, 16384, 16, "served", "zero"),
    ("served, from a mid-run state", 8, 2048, 16384, 16, "served", "mid-run"),
    ("served, slow dt", 8, 2048, 16384, 16, "slow", "mid-run"),
    ("served, fast dt", 8, 2048, 16384, 16, "fast", "mid-run"),
    ("decode step", 8, 1, 16384, 16, "served", "mid-run"),
    ("7 steps", 8, 7, 16384, 16, "served", "mid-run"),
    ("one past the served length", 8, 2049, 16384, 16, "served", "zero"),
    ("n=8 (the smoke state)", 4, 2049, 4096, 8, "served", "mid-run"),
    ("n=8 decode step", 4, 1, 4096, 8, "fast", "mid-run"),
    ("ragged d_in", 4, 2049, 200, 16, "served", "mid-run"),
    ("ragged d_in, n=8", 2, 33, 200, 8, "slow", "zero"),
)
#: an H100 SXM's boost clock and its SFU results an SM a clock (exp2 and the
#: other special functions: the CUDA programming guide's throughput table,
#: compute capability 9.0): the floor of the scan's exponentials
SM_CLOCK_HZ, SFU_PER_SM_CLOCK = 1.98e9, 16


def jamba_cut():
    """jamba-1.5-large at full width, one super-block of HYBRID_LAYERS."""
    import dataclasses

    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch(HYBRID_ARCH), n_layers=HYBRID_LAYERS,
                               attn_period=HYBRID_LAYERS)


def scan_inputs(torch, dev, B, S, d_in, n, seed, dt="served", state="zero"):
    """The scan's inputs at (B, S, d_in, n), drawn on the card: x, B and C
    N(0, 1), dt = softplus(c + s N(0, 1)) at SCAN_DT[dt], a learned-looking
    A = -(1 .. n) exp(0.3 N(0, 1)) (not A_log's initial -(1 .. n)), D = 1 +
    0.1 N(0, 1); the state zero or, "mid-run", the plain version's after
    SCAN_WARM steps of such inputs from zero."""
    import torch.nn.functional as F

    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    c, spread = SCAN_DT[dt]

    def draw(steps):
        return (randn(B, steps, d_in), F.softplus(c + spread * randn(B, steps, d_in)),
                randn(B, steps, n), randn(B, steps, n))

    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev) * torch.exp(0.3 * randn(d_in, n))
    D = 1.0 + 0.1 * randn(d_in)
    h0 = torch.zeros(B, d_in, n, device=dev)
    if state == "mid-run":
        x, dts, Bm, Cm = draw(SCAN_WARM)
        h0 = selective_scan_ref(x, dts, A, Bm, Cm, D, h0)[1].contiguous()
    x, dts, Bm, Cm = draw(S)
    return x, dts, A, Bm, Cm, D, h0


def scan_bound(torch, dev, B, S, d_in, n):
    """The scan's bound: x and dt read and y written once, B, C, A and D
    read once, the state read and written; ~6 float32 flops a (b, t, d, k)
    and 3 a (b, t, d).  Beside it the exponentials' floor, which the bound
    rule does not count: one SFU result each."""
    n_bytes = 4 * (3 * B * S * d_in + 2 * B * S * n + d_in * n + d_in + 2 * B * d_in * n)
    b, by = bound_ms(n_bytes, 6 * B * S * d_in * n + 3 * B * S * d_in)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return b, by, B * S * d_in * n / (SFU_PER_SM_CLOCK * sms * SM_CLOCK_HZ) * 1e3


def scan_errors(y, h, want_y, want_h):
    """max |kernel - plain| over the largest |plain|, of y and of the state."""
    return {"y": float((y - want_y).abs().max()) / float(want_y.abs().max()),
            "state": float((h - want_h).abs().max()) / float(want_h.abs().max())}


def check_scan_kernel(torch, dev, flush):
    """Phase 27 (a): the selective-scan kernel against its plain version on
    the card at SCAN_CASES, each from a copy of its state, y and the final
    state within SCAN_TOL of the largest magnitude, two runs bit for bit;
    at the served layer and a decode step timed cold beside its earlier design
    in turns, and warm, beside its bound, the exponentials' floor, the plain
    version and the floor of the timing (the kernel at B = S = 1, one block)
    (tools/time_selective_scan_designs.py)."""
    from tools.time_selective_scan_designs import time_designs

    from repro_torch.kernels.selective_scan.kernel import launch
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    worst, served = 0.0, None
    for i, (label, B, S, d_in, n, dt, state) in enumerate(SCAN_CASES):
        x, dts, A, Bm, Cm, D, h0 = scan_inputs(torch, dev, B, S, d_in, n, seed=27 + i, dt=dt,
                                               state=state)
        h1, h2 = h0.clone(), h0.clone()
        y1, y2 = launch(x, dts, A, Bm, Cm, D, h1), launch(x, dts, A, Bm, Cm, D, h2)
        want_y, want_h = selective_scan_ref(x, dts, A, Bm, Cm, D, h0)
        errs = scan_errors(y1, h1, want_y, want_h)
        same_state = torch.equal(h1, want_h)
        print(f"selective_scan {label} B={B} S={S} d_in={d_in} n={n}, {dt} dt (mean "
              f"{float(dts.mean()):.4g}), {state} state: |kernel - plain| / largest: y "
              f"{errs['y']:.3e}, state {errs['state']:.3e} (limit {SCAN_TOL:.0e}; max |y| "
              f"{float(want_y.abs().max()):.3f}, max |h| {float(want_h.abs().max()):.3f}; state "
              f"bit for bit the plain version's: {same_state})")
        need(bool(torch.isfinite(y1).all() and torch.isfinite(h1).all())
             and float(y1.abs().max()) > 0, f"selective_scan {label}: empty, zero or non-finite")
        need(max(errs.values()) <= SCAN_TOL, f"selective_scan {label}: {errs} > {SCAN_TOL}")
        need(torch.equal(y1, y2) and torch.equal(h1, h2), f"selective_scan {label}: two runs differ")
        worst = max(worst, max(errs.values()))
        if (B, S, d_in, n) == SCAN_SERVED and state == "zero" and dt == "served":
            served = {"max_abs_err": float((y1 - want_y).abs().max()), "relative_err": errs,
                      "state_bit_for_bit": same_state}
        del x, dts, Bm, Cm, y1, y2, h1, h2, want_y, want_h
    need(served is not None, "no served-shape case")
    torch.cuda.empty_cache()
    timed = time_designs(torch, dev, flush)
    torch.cuda.empty_cache()
    floor = timed["floor_ms"]
    for key in ("served", "decode"):
        row = timed[key]
        print(f"selective_scan {key} {row['shape']}: cold {row['ms'] * 1e3:.2f} us (the earlier "
              f"design {row['earlier_ms'] * 1e3:.2f}), warm in L2 {row['warm_ms'] * 1e3:.2f} us "
              f"(plain {row['plain_ms'] * 1e3:.1f} us, library call: none, bound "
              f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}, the exponentials' floor "
              f"{row['exp_floor_ms'] * 1e3:.2f} us; kernel / bound "
              f"{row['ms'] / row['bound_ms']:.2f}); floor of the timing (B = S = 1, d_in 128: one "
              f"block, one step) {floor * 1e3:.2f} us cold")
    served_row = {k: v for k, v in timed["served"].items() if k != "relative_err"}
    return {**served_row, "library_ms": None, "decode_step": timed["decode"], "floor_ms": floor,
            "earlier_design": timed["earlier_design"], "ptxas": timed["ptxas"], **served,
            "worst_relative_err": worst, "cases": len(SCAN_CASES)}


def check_jamba_attention(torch, dev, cfg, flush):
    """Phase 27 (a): both attention kernels held against their plain
    versions at jamba's heads (H 64, Hkv 8, D 128) and the served shapes
    (prefill B 8 x S 2048; decode B 8 over S 2080, lengths 2049 ..), two
    runs bit for bit, and timed beside their plain versions,
    scaled_dot_product_attention and their bounds."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_prefill.kernel import design as prefill_design

    bf, H, Hkv, D = torch.bfloat16, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    decode_job, prefill_job = attention_jobs(torch, dev, H, Hkv, D, 27)
    S = SERVE_S + SERVE_NEW
    lengths = torch.arange(SERVE_S + 1, SERVE_S + 1 + SERVE_B, device=dev,
                           dtype=torch.int32).clamp(max=S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{HYBRID_ARCH} attention: decode design {dk.design(bf, D)}, plan (splits, split "
          f"length) {dk.mma_grid_plan(SERVE_B, H, Hkv, S, D, sms)} at B={SERVE_B} S={S}; prefill "
          f"design {prefill_design(bf, D)}")
    errs = {}
    for name, label, make in (
            ("decode_attention", f"B={SERVE_B} S={S}", lambda: decode_job(SERVE_B, S, lengths)),
            ("flash_prefill", f"B={SERVE_B} S={SERVE_S}", lambda: prefill_job(SERVE_B, SERVE_S))):
        kern, plain = make()[:2]
        errs[name] = _held(torch, f"{name} at {HYBRID_ARCH}'s heads H={H} Hkv={Hkv} D={D}, "
                           f"{label}", kern(), kern(), plain(), bf)
        del kern, plain
        torch.cuda.empty_cache()
    timed = time_served_attention(torch, dev, decode_job, prefill_job,
                                  lambda *a: measure_attention(torch, *a, flush))
    return {name: {"max_abs_err": errs[name], **timed[name]["serving"]} for name in errs}


class plain_scan:
    """Within this block the Mamba layers run the plain version on the card
    (the state written into the tensor given, as the wrapper does), and no
    kernel is launched."""

    def __enter__(self):
        from repro_torch.kernels.selective_scan.ref import selective_scan_ref
        from repro_torch.models import mamba

        def plain(x, dt, A, Bm, Cm, D, state):
            y, final = selective_scan_ref(x, dt, A, Bm, Cm, D, state)
            state.copy_(final)
            return y

        self.saved, mamba.selective_scan = mamba.selective_scan, plain

    def __exit__(self, *exc):
        from repro_torch.models import mamba

        mamba.selective_scan = self.saved


def plain_prefill_rows(q, k, v, causal=True):
    """The plain prefill version a sequence at a time: its (B, H, S, S)
    float32 scores at jamba's heads would be 8.6 GB, three times over, beside
    47.55 GB of weights."""
    import torch

    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    return torch.cat([flash_prefill_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal)
                      for b in range(q.shape[0])])


def kept_rows(torch, cfg, seen, B):
    """Sequences none of whose (token, k) assignments was dropped past an
    expert's capacity in any MoE call of ``seen`` (a decode step of B
    tokens has capacity 1 an expert at jamba's 16 experts, top-2)."""
    from repro_torch.models import moe

    rows = torch.ones(B, dtype=torch.bool, device=seen[0].device)
    for eidx in seen:
        T = eidx.shape[0]
        cap = moe.capacity(T, cfg)
        slot = moe.dispatch(moe.Routing(None, None, None, eidx), cfg.n_experts, cap)
        rows &= (slot != cfg.n_experts * cap).view(B, -1).all(dim=-1)
    return rows


def held_hybrid_cache(torch, label, got, want, rows):
    """k, v and conv (in the compute type) and the float32 ssm state of the
    sequences ``rows``, each within SPLIT_ULPS bf16 ulps of its largest
    |value|: the state's inputs (x, dt, B, C) are bf16 products cast to
    float32, and its decay forgets within a few steps, so the last token's
    rounding is what it holds."""
    errs = {}
    for name, axis in (("k", 1), ("v", 1), ("conv", 2), ("ssm", 2)):
        a = got[name].index_select(axis, rows).float()
        b = want[name].index_select(axis, rows).float()
        top = float(b.abs().max())
        errs[name] = float((a - b).abs().max())
        tol = SPLIT_ULPS * bf16_ulp(top)
        print(f"{label}, {name}: max |difference| {errs[name]:.4e} over {len(rows)} rows (limit "
              f"{tol:.4e}, {SPLIT_ULPS} bf16 ulps of the largest {top:.4f})")
        need(errs[name] <= tol, f"{label}: {name} differs by {errs[name]}")
    return errs


def check_hybrid_against_plain(torch, engine, prompts, first_out):
    """Phase 27 (c): the served jamba through the kernels against the same
    model through the plain versions on the card (the plain scan, the plain
    attention, its prefill a sequence at a time): last-token logits after
    prefill and TEACHER_STEPS teacher-forced decode steps within phase 15's
    8 bf16 ulps of the largest |logit|.  The two MoE layers sit after the
    scan and the attention, so a rounding apart can flip a near-tie of
    router scores: the flips are counted (routing_flips), the plain prefill
    with its own routing is held on the rows with none, and the plain runs
    routed as the kernels' on every row; the plain steps run from a copy of
    the kernels' prefill cache (as phase 26), and beside them, printed as a
    yardstick, from the plain prefill's own cache.  Then prefill of S tokens
    against prefill of S - 1 and one decode step, through the kernels, held
    on the rows routed alike whose assignments no expert's capacity dropped
    (a decode step's capacity is 1 an expert, the prefill's 2560)."""
    import numpy as np

    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import decode_step, prefill

    cfg, params, dev, V = engine.cfg, engine.params, engine.device, engine.cfg.vocab_size
    tokens = torch.from_numpy(prompts).to(dev)
    B, S = prompts.shape
    t0 = time.perf_counter()
    with moe_routes() as kern:
        lk, ck = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    before = launch_counts()
    with plain_attention(prefill=plain_prefill_rows), plain_scan(), moe_routes() as own:
        lp, cp = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    need(launch_counts() == before, "the plain run launched a kernel")
    by_layer, clean = routing_flips(torch, kern.seen, own.seen, S)
    print(f"{cfg.name} prefill routing, kernels against the plain versions with their own "
          f"routing: {sum(by_layer)} (token, layer) flips of {B * S * len(by_layer)}, by MoE layer "
          f"{by_layer}; {int(clean.sum())} of {B} rows with none")
    errs = []
    if bool(clean.any()):
        errs.append(held_logits(torch, f"{cfg.name} prefill, last token, rows routed alike",
                                lk[clean], lp[clean], V)[0])
    with plain_attention(prefill=plain_prefill_rows), plain_scan(), moe_routes(forced=kern.seen):
        lf, cf = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: a prefill through the kernels and two through the plain versions in "
          f"{time.perf_counter() - t0:.2f} s")
    errs.append(held_logits(torch, f"{cfg.name} prefill, last token, plain routed as the kernels",
                            lk, lf, V)[0])
    state = float((ck["ssm"] - cf["ssm"]).abs().max()) / float(cf["ssm"].abs().max())
    print(f"{cfg.name} prefill: the kernels' scan states against the plain versions', max "
          f"|difference| / largest {state:.3e} over its {cfg.n_layers - 1} Mamba layers")
    tok = torch.argmax(lk[:, :V], -1)
    need(np.array_equal(tok.cpu().numpy(), first_out[:, 0]), "prefill does not repeat generate")
    cq = {k: v.clone() if torch.is_tensor(v) else v for k, v in ck.items()}
    own_drift, decode_flips = [], 0
    for step in range(TEACHER_STEPS):
        with moe_routes() as kr:
            lk, ck = decode_step(cfg, params, ck, tok, dev)
        with plain_attention(), plain_scan():
            with moe_routes(forced=kr.seen) as pr:
                lq, cq = decode_step(cfg, params, cq, tok, dev)
            with moe_routes(forced=kr.seen):
                lo, cf = decode_step(cfg, params, cf, tok, dev)
        decode_flips += sum(routing_flips(torch, kr.seen, pr.seen, 1)[0])
        errs.append(held_logits(torch, f"{cfg.name} decode step {step + 1}, teacher-forced, "
                                "routed alike", lk, lq, V)[0])
        own_drift.append(float((lk[:, :V].float() - lo[:, :V].float()).abs().max()))
        tok = torch.argmax(lk[:, :V], -1)
    print(f"decode routing over {TEACHER_STEPS} teacher-forced steps: {decode_flips} (token, "
          f"layer) flips where the plain versions routed by their own scores; yardstick, the "
          f"plain steps from the plain prefill's own cache: max |logit kernels - plain| by step "
          f"{[round(e, 6) for e in own_drift]} (the gate above: 8 bf16 ulps of the largest)")
    # prefill(S) against prefill(S - 1) and one decode step, both through the kernels
    with moe_routes() as whole_r:
        whole_logits, whole = prefill(cfg, params, {"tokens": tokens}, engine.max_len, dev)
    with moe_routes() as part_r:
        part_logits, part = prefill(cfg, params, {"tokens": tokens[:, :-1]}, engine.max_len, dev)
        part_logits, part = decode_step(cfg, params, part, tokens[:, -1], dev)
    n_moe = len(whole_r.seen)
    K = cfg.experts_per_token
    joined = [torch.cat([part_r.seen[i].view(B, S - 1, K), part_r.seen[n_moe + i].view(B, 1, K)],
                        dim=1).reshape(B * S, K) for i in range(n_moe)]
    split_flips, alike = routing_flips(torch, whole_r.seen, joined, S)
    rows = alike & kept_rows(torch, cfg, whole_r.seen, B) & kept_rows(torch, cfg, part_r.seen, B)
    print(f"{cfg.name} prefill of {S} against {S - 1} and a decode step: routing flips by MoE "
          f"layer {split_flips}; rows routed alike with no assignment dropped in either run: "
          f"{rows.nonzero().flatten().tolist()} of {B}")
    need(bool(rows.any()), "no row of the split run to hold")
    rows_idx = rows.nonzero().flatten()
    split_err = held_logits(torch, f"{cfg.name} prefill of {S} against {S - 1} and a decode step",
                            part_logits[rows_idx], whole_logits[rows_idx], V)[0]
    split_cache = held_hybrid_cache(torch, f"{cfg.name} prefill against prefill and a decode step",
                                    part, whole, rows_idx)
    need(part["pos"] == whole["pos"] == S, "the split run's position")
    return {"max_logit_err": max(errs), "prefill_flips": sum(by_layer),
            "prefill_flips_by_layer": by_layer, "rows_routed_alike": int(clean.sum()),
            "decode_flips": decode_flips, "prefill_state_relative_err": state,
            "own_state_decode_logit_err": own_drift, "split_logit_err": split_err,
            "split_cache_err": split_cache, "split_rows_held": int(rows.sum())}


def check_hybrid(torch, dev):
    """Phase 27: the hybrid family.  (a) the selective-scan kernel against
    its plain version and timed, and both attention kernels at jamba's heads;
    (b) jamba-1.5-large at full width, its depth cut to one super-block of
    HYBRID_LAYERS (random bf16 weights drawn on the card, A_log, dt_bias, D
    and the routers float32), served behind an OGB page pool in SERVE_CALLS
    generate calls as phase 14 serves glm4-9b: exactly 3 + 3 x 32
    selective_scan, 1 flash_prefill and 32 decode_attention launches a call,
    and where a prefill and a decode step go; (c) its logits against the
    plain versions', and prefill against a shorter prefill and a decode
    step."""
    import dataclasses
    import gc

    from repro_torch.kernels import design_counts

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hybrid family phase 27 on {nvidia_smi_line()}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated at its start")
    need(torch.cuda.memory_allocated(dev) < 4e9, "an earlier phase's weights are still held")
    cfg = jamba_cut()
    flush = l2_flush(torch, dev)
    kernel = check_scan_kernel(torch, dev, flush)
    attention = check_jamba_attention(torch, dev, cfg, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    print(f"{HYBRID_ARCH} served at full width, depth cut to one super-block: "
          f"{dataclasses.asdict(cfg)}")
    engine, prompts, first_out, launches, steady = serve_full_width(torch, dev, HYBRID_ARCH,
                                                                    cfg=cfg)
    kept = {f"{i}/{kind}/{name}": str(engine.params["blocks"][i][kind][name].dtype)
            for i, kind, name in ((0, "mamba", "A_log"), (0, "mamba", "dt_bias"),
                                  (0, "mamba", "D"), (1, "moe", "router"), (0, "mamba", "w_in"))}
    print(f"{HYBRID_ARCH} served leaves: {kept}")
    need(list(kept.values()) == ["torch.float32"] * 4 + ["torch.bfloat16"],
         f"{HYBRID_ARCH}: the SSM dynamics and the router are not float32 beside bf16 weights")
    mamba_layers = cfg.n_layers - cfg.n_layers // cfg.attn_period
    designs = design_counts()
    print(f"{HYBRID_ARCH} launches by design: {designs}")
    need(designs.get("selective_scan") == {
        DESIGNS["selective_scan"]: mamba_layers * SERVE_CALLS,
        SCAN_STEP_DESIGN: mamba_layers * SERVE_NEW * SERVE_CALLS},
         f"{HYBRID_ARCH}: selective_scan launches by design {designs.get('selective_scan')}")
    serve_breakdown(torch, engine, prompts)
    t2 = time.perf_counter()
    against = check_hybrid_against_plain(torch, engine, prompts, first_out)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    secs = {"kernel_and_attention": t1 - t0, "serving": t2 - t1,
            "against_plain": time.perf_counter() - t2, "all": time.perf_counter() - t0}
    print(f"phase 27: {secs['all']:.2f} s ({secs}) on {nvidia_smi_line()}")
    a_generate = {"selective_scan": mamba_layers * (1 + SERVE_NEW),
                  "flash_prefill": cfg.n_layers // cfg.attn_period,
                  "decode_attention": cfg.n_layers // cfg.attn_period * SERVE_NEW}
    return {"kernel": kernel, "attention": attention, "serving": steady, "launches": launches,
            "launches_a_generate": a_generate, **against, "seconds": secs,
            "depth": f"{cfg.n_layers} of 72 layers, attn_period {cfg.attn_period} of 8"}


# -- training the attention families (phase 28) -------------------------------------------

TRAIN_ARCH, TRAIN_DEPTH = "glm4-9b", 4  # full width, the depth cut to 4 of 40 layers
#: gemma-7b (head_dim 256) at full width, the depth cut to 4 of 28 layers (all
#: 28 need ~136 GB of float32 state), its step in 4 microbatches of 1 x 4096
#: (a microbatch's float32 logits over the 256 000 vocab are 4.2 GB a sequence)
GEMMA_ARCH, GEMMA_DEPTH, GEMMA_MICRO = "gemma-7b", 4, 4
#: the step: train_4k's sequence length, a global batch of 4 sequences in 2
#: microbatches, 8 steps of SyntheticLM data (made by a worker meanwhile)
TRAIN_S, TRAIN_B, TRAIN_MICRO, TRAIN_STEPS = 4096, 4, 2, 8
TRAIN_LR, TRAIN_WARMUP = 1e-4, 2
#: the kernel run against the plain-version run: tokens of one sequence, and
#: the limits on the loss (relative), grad_norm (relative) and each attention
#: weight's gradient (relative Frobenius error)
TRAIN_PLAIN_TOKENS = 1024
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_FROB = 1e-3, 1e-2, 2e-2
#: the backward kernel's cases: label, (B, S, T, H, Hkv, D), bf16 or not, causal
BWD_CASES = (
    ("glm4-9b train", (2, 4096, 4096, 32, 2, 128), True, True),
    ("gemma-7b D=256", (2, 4096, 4096, 16, 16, 256), True, True),
    ("granite-moe D=64", (2, 2048, 2048, 16, 8, 64), True, True),
    ("phi-3-vision D=96", (1, 2048, 2048, 32, 32, 96), True, True),
    ("whisper encoder", (2, 1500, 1500, 20, 20, 64), True, False),
    ("whisper cross", (2, 224, 1500, 20, 20, 64), True, False),
    ("smoke f32 D=16", (2, 100, 100, 8, 2, 16), False, True),
)
BWD_ULPS = 8  # bf16: within 8 ulps of each output's largest
BWD_F32_TOL = 1e-4  # float32: of each output's largest
#: the forward's log-sum-exp against the plain version's (natural log, absolute):
#: ex2.approx and a float32 sum of up to 4096 terms in another order
LSE_TOL = 1e-4
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")
MATMUL_WEIGHTS = ATTN_WEIGHTS + ("w_gate", "w_up", "w_down")


def train_batches(n, vocab, seq_len, batch):
    """Phase 28's and 29's SyntheticLM batches, in a worker process (numpy only)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.train.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab, seq_len, batch))
    return [data.next_batch() for _ in range(n)]


def start_train_batches(archs):
    """Start the trained models' data (TRAIN_STEPS batches each, at their
    vocabularies) in a spawned worker, so that it overlaps the card's
    earlier phases (a batch of 4 x 4096 tokens takes seconds): the pool and
    arch -> future."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs.base import get_arch

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, {arch: pool.submit(train_batches, TRAIN_STEPS, get_arch(arch).vocab_size,
                                     TRAIN_S, TRAIN_B) for arch in archs}


def bwd_bound(B, S, T, H, Hkv, D, itemsize, causal):
    """Five products of 2 D a (query head, query, key) pair the mask keeps,
    over the tensor-core (bf16) or CUDA-core (float32) peak; q, k, v, o, dO
    and the lse read once, dq, dk and dv written once."""
    pairs = S * (S + 1) // 2 if causal else S * T
    n_ops = 5 * 2 * B * H * D * pairs
    n_bytes = itemsize * (4 * B * S * H * D + 4 * B * T * Hkv * D) + 4 * B * H * S
    return bound_ms(n_bytes, n_ops, BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S)


def check_bwd_case(torch, dev, label, shape, bf16, causal, flush):
    """Phase 28 (a) and (b) at one shape: the forward's output and lse, and the
    backward kernel against its plain version, two runs bit for bit, the
    CUDA-core design's (and, where the call takes the wgmma design, the
    earlier mma.sync design's) errors, its time cold beside its bound, the
    earlier design's in turns (tools/time_flash_bwd_designs.py), its plain
    version's and SDPA's forward and backward."""
    import torch.nn.functional as F

    from tools.time_flash_bwd_designs import earlier_bwd, own_bound, time_in_turns

    from repro_torch.kernels.flash_prefill.ops import (
        flash_prefill,
        flash_prefill_bwd,
        flash_prefill_lse,
    )
    from repro_torch.kernels.flash_prefill.kernel import (
        CUDA_CORE,
        WGMMA,
        bwd_design,
        bwd_heads_per_block,
        grid_prefill,
        grid_prefill_bwd,
    )
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref, flash_prefill_lse_ref

    B, S, T, H, Hkv, D = shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(S * 7 + D)
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    out, lse = flash_prefill_lse(q, k, v, causal)  # training's forward: P split where wgmma
    # the serving design with an lse buffer: the same launch, the same output
    serve_lse = torch.empty_like(lse)
    served = grid_prefill(q, k, v, causal, lse=serve_lse)
    need(torch.equal(served, flash_prefill(q, k, v, causal)),
         f"{label}: an lse buffer changed the serving call's output")
    if not bf16:
        need(torch.equal(out, served), f"{label}: training's forward is not the serving call")
    design = bwd_design(dtype, D)
    got = flash_prefill_bwd(q, k, v, out, do, lse, causal)
    again = flash_prefill_bwd(q, k, v, out, do, lse, causal)
    # the CUDA-core design at the same inputs, where the call takes the wgmma
    # one, and the earlier mma.sync design there
    core = (grid_prefill_bwd(q, k, v, out, do, lse, causal, which=CUDA_CORE)
            if design != CUDA_CORE else got)
    mma = earlier_bwd(q, k, v, out, do, lse, causal) if design == WGMMA else got
    torch.cuda.synchronize()
    need(all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: two runs differ")
    lse_err, out_err, out_lim, errs, lims = 0.0, 0.0, 0.0, [0.0] * 3, [0.0] * 3
    core_errs, mma_errs = [0.0] * 3, [0.0] * 3
    for b in range(B):  # the plain versions a sequence at a time: (H, S, T) float32 scores
        sl = slice(b, b + 1)
        want_out, want_lse = flash_prefill_lse_ref(q[sl], k[sl], v[sl], causal)
        lse_err = max(lse_err, float((lse[sl] - want_lse).abs().max()),
                      float((serve_lse[sl] - want_lse).abs().max()))
        out_err = max(out_err, float((out[sl].float() - want_out.float()).abs().max()))
        top = float(want_out.float().abs().max())
        out_lim = max(out_lim, BWD_ULPS * bf16_ulp(top) if bf16 else BWD_F32_TOL * top)
        del want_out
        want = flash_prefill_bwd_ref(q[sl], k[sl], v[sl], out[sl], do[sl], lse[sl], causal)
        for i, (g, w) in enumerate(zip(got, want)):
            errs[i] = max(errs[i], float((g[sl].float() - w.float()).abs().max()))
            core_errs[i] = max(core_errs[i], float((core[i][sl].float() - w.float()).abs().max()))
            mma_errs[i] = max(mma_errs[i], float((mma[i][sl].float() - w.float()).abs().max()))
            top = float(w.float().abs().max())
            lims[i] = max(lims[i], BWD_ULPS * bf16_ulp(top) if bf16 else BWD_F32_TOL * top)
        del want
    need(lse_err <= LSE_TOL, f"{label}: lse differs from the plain version's by {lse_err}")
    need(out_err <= out_lim, f"{label}: training's forward differs by {out_err} (limit {out_lim})")
    need(all(e <= lim for e, lim in zip(errs + core_errs + mma_errs, lims * 3)),
         f"{label}: dq, dk, dv differ from the plain version by {errs} (the CUDA-core design "
         f"by {core_errs}, the earlier mma.sync design by {mma_errs}; limits {lims})")
    del core, mma
    reps = 3 if S * T >= 4096 * 4096 // 2 else 10

    def kern():
        return flash_prefill_bwd(q, k, v, out, do, lse, causal)

    if design == WGMMA:
        # the earlier mma.sync design in turns with the wgmma one: new, old, old, new
        ms, earlier_ms, turns = time_in_turns(
            torch, kern, lambda: earlier_bwd(q, k, v, out, do, lse, causal), flush, reps)
    else:
        ms, earlier_ms, turns = timed_ms(torch, kern, reps, flush), None, None
    fwd_ms = timed_ms(torch, lambda: flash_prefill_lse(q, k, v, causal), reps, flush)
    serve_ms = timed_ms(torch, lambda: flash_prefill(q, k, v, causal), reps, flush)
    torch.cuda.empty_cache()
    plain_ms = timed_ms(torch, lambda: flash_prefill_bwd_ref(q, k, v, out, do, lse, causal), 1,
                        flush)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    lib_out = sdpa()
    sdpa_fwd_ms = timed_ms(torch, sdpa, reps, flush)
    sdpa_bwd_ms = timed_ms(
        torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True), reps,
        flush)
    bound, by = bwd_bound(B, S, T, H, Hkv, D, q.element_size(), causal)
    own = own_bound(B, S, T, H, Hkv, D, causal, bwd_heads_per_block(H, Hkv))[0]
    earlier = ("" if earlier_ms is None else
               f"; the earlier mma.sync design in turns {earlier_ms * 1e3:.1f} us "
               f"({earlier_ms / ms:.2f}x); the design's own bound {own * 1e3:.1f} us")
    print(f"flash_prefill_bwd {label} B={B} S={S} T={T} H={H} Hkv={Hkv} D={D} "
          f"{'bf16' if bf16 else 'f32'} {'causal' if causal else 'non-causal'} [{design}]: cold "
          f"{ms * 1e3:.1f} us{earlier} (bound {bound * 1e3:.1f} us by {by}, {ms / bound:.1f}x; "
          f"plain "
          f"{plain_ms * 1e3:.1f} us; SDPA forward {sdpa_fwd_ms * 1e3:.1f} us, backward "
          f"{sdpa_bwd_ms * 1e3:.1f} us); max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
          f"{errs[2]:.3e} (CUDA-core design {max(core_errs):.3e}, earlier design "
          f"{max(mma_errs):.3e}; limits {lims[0]:.3e} "
          f"{lims[1]:.3e} {lims[2]:.3e}); both forward designs' lse "
          f"max |err| {lse_err:.3e}; training's forward max |err| {out_err:.3e} (limit "
          f"{out_lim:.3e}), cold {fwd_ms * 1e3:.1f} us (the serving design {serve_ms * 1e3:.1f} "
          f"us); two runs bit for bit")
    return {"label": label, "shape": {"B": B, "S": S, "T": T, "H": H, "Hkv": Hkv, "D": D},
            "dtype": "bf16" if bf16 else "f32", "causal": causal, "design": design, "ms": ms,
            "earlier_ms": earlier_ms, "turns": turns, "cuda_core_max_abs_err": max(core_errs),
            "earlier_max_abs_err": max(mma_errs), "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "own_bound_ms": own if earlier_ms else None,
            "library_ms": sdpa_bwd_ms,
            "sdpa_forward_ms": sdpa_fwd_ms, "max_abs_err": max(errs), "errs": errs,
            "limits": lims, "lse_max_abs_err": lse_err, "forward_max_abs_err": out_err,
            "forward_ms": fwd_ms, "serving_forward_ms": serve_ms}


#: phase 28's and 29's profiled steps: the attention and the recurrence kernels by
#: the names of their functions
TRAIN_ATTENTION_KERNELS = ("prefill_wgmma_kernel", "prefill_kernel", "dq_kernel", "dkv_kernel",
                           "dkv_sum_kernel")
TRAIN_RECURRENCE_KERNELS = ("wkv6_kernel", "wkv6_bwd_kernel", "wkv6_bwd_sum")


def train_breakdown(torch, step_fn, state, batch):
    """Phase 28 (c) and 29 (b): where one more training step goes, from
    torch.profiler: wall and device busy time, device kernels, the attention
    and recurrence kernels', and the matrix products' shares, and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    need(busy_ms > 0, "training breakdown: the profiler saw no device time")

    def share(pick):
        return sum(e.self_device_time_total for e in rows if pick(e.key)) / 1e3

    attention_ms = share(lambda key: any(name in key for name in TRAIN_ATTENTION_KERNELS))
    recurrence_ms = share(lambda key: any(name in key for name in TRAIN_RECURRENCE_KERNELS))
    gemm_ms = share(lambda key: any(name in key.lower()
                                    for name in ("nvjet", "gemm", "xmma", "cutlass")))
    elementwise_ms = share(lambda key: "elementwise_kernel" in key)
    rest_ms = busy_ms - attention_ms - recurrence_ms - gemm_ms - elementwise_ms
    print(f"training breakdown, one step (profiled): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in rows)} device kernels; attention kernels {attention_ms:.1f} ms, "
          f"recurrence kernels {recurrence_ms:.1f} ms, matrix products (cuBLAS) {gemm_ms:.1f} ms, "
          f"elementwise passes {elementwise_ms:.1f} ms, the rest {rest_ms:.1f} ms")
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return state, {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                   "attention_ms": attention_ms, "recurrence_ms": recurrence_ms,
                   "gemm_ms": gemm_ms,
                   "elementwise_ms": elementwise_ms,
                   "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top]}


class plain_training_attention:
    """Within this block training's attention function runs the plain
    versions on the card: its forward and backward wrappers are swapped for
    them, and put back on leaving."""

    def __enter__(self):
        from repro_torch.kernels.flash_prefill import ref
        from repro_torch.models import attention

        self.saved = attention.flash_prefill_lse, attention.flash_prefill_bwd
        attention.flash_prefill_lse = ref.flash_prefill_lse_ref
        attention.flash_prefill_bwd = ref.flash_prefill_bwd_ref

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_prefill_lse, attention.flash_prefill_bwd = self.saved


class plain_training_wkv:
    """Within this block training's recurrence function (``WKV6``) runs the
    plain versions on the card: its forward's kernel call and its backward
    wrapper are swapped for them, and put back on leaving."""

    def __enter__(self):
        from repro_torch.kernels.wkv6 import ops, ref

        def forward(r, k, v, w, u, state):
            y, final = ref.wkv6_ref(r, k, v, w, u, state)
            state.copy_(final)
            return y

        self.saved = ops._forward, ops.wkv6_bwd
        ops._forward, ops.wkv6_bwd = forward, ref.wkv6_bwd_ref

    def __exit__(self, *exc):
        from repro_torch.kernels.wkv6 import ops

        ops._forward, ops.wkv6_bwd = self.saved


class jittered_plain_wkv(plain_training_wkv):
    """As :class:`plain_training_wkv`, with each output of the plain
    backward scaled by 1 + 2^-23 N(0, 1) (about one float32 ulp, a fixed
    seed): the same function rounded otherwise, the noise floor of a
    comparison through bf16 products."""

    def __enter__(self):
        super().__enter__()
        import torch

        from repro_torch.kernels.wkv6 import ops, ref

        def backward(*args):
            gen = torch.Generator(device=args[0].device).manual_seed(29)
            return tuple(g * (1 + 2.0 ** -23 * torch.randn(g.shape, generator=gen,
                                                            device=g.device))
                         for g in ref.wkv6_bwd_ref(*args))

        ops.wkv6_bwd = backward


def grads_of(torch, cfg, params, batch, names):
    """loss, grad_norm and the gradient (a copy) of every block weight named
    in ``names``, by (layer, path), of one forward and backward of
    ``batch``."""
    from repro_torch.models.model import forward_train
    from repro_torch.train.optimizer import global_norm, tree_map

    tree_map(lambda p: setattr(p, "grad", None), params)
    loss, _ = forward_train(cfg, params, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    picked = {}

    def walk(tree, i, path):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, i, f"{path}{key}/")
            elif key in names:
                picked[(i, path + key)] = leaf.grad.clone()

    for i, p in enumerate(params["blocks"]):
        walk(p, i, "")
    need(len(picked) == cfg.n_layers * len(names), f"{cfg.name}: {len(picked)} weights compared")
    gnorm = float(global_norm(grads))
    tree_map(lambda p: setattr(p, "grad", None), params)
    return float(loss.detach()), gnorm, picked


def train_full_width(torch, dev, cfg, micro, batches, spec):
    """Train ``cfg`` (a full-width configuration, its depth cut or not) on the
    card for TRAIN_STEPS steps of ``batches`` (TRAIN_B x TRAIN_S tokens) in
    ``micro`` microbatches from seed 0: the parameters the configuration's, the
    loss finite and the last step's below the first, exactly ``spec["want"]``
    launches by kernel over the steps (``spec["designs"]`` by design), the
    peak below 80 GB; one more step profiled; and a kernel run against a
    plain-version run (``spec["plain"]``, a context) from the trained weights
    at 1 x ``spec["plain_tokens"]`` tokens (``spec["short"]`` launches), in
    each compute type of ``spec["compare_in"]``: the loss within
    TRAIN_LOSS_TOL, grad_norm within TRAIN_GNORM_TOL and, in
    ``spec["weights_gated_in"]``, each block weight named in
    ``spec["weights"]`` within TRAIN_GRAD_FROB relative Frobenius; where
    ``spec["floor"]`` (a context) is given, the plain versions against
    themselves rounded otherwise, printed beside the bf16 comparison.  The
    MFU counts 6 x the products' parameters (blocks' weights
    named in ``spec["matmuls"]`` and the lm_head) x tokens, and
    ``spec["extra_ops"]`` a step."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import design_counts, launch_counts, reset_launch_counts
    from repro_torch.models.model import padded_vocab
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.train_step import create_train_state, make_train_step

    full_layers = get_arch(cfg.name).n_layers
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = create_train_state(cfg, opt_cfg, seed=0, device=dev)
    n_params = sum(p.numel() for _, p in tree_leaves(state.params))
    need(n_params == expected_params(cfg), f"{cfg.name}: {n_params} parameters, expected "
         f"{expected_params(cfg)}")
    n_matmul = sum(p.numel() for path, p in tree_leaves(state.params)
                   if path.split("/")[-1] in spec["matmuls"] or path == "lm_head")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt_cfg, micro)
    reset_launch_counts()
    losses, gnorms, seconds = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        seconds.append(time.perf_counter() - t0)
        gnorms.append(float(metrics["grad_norm"]))
        need(math.isfinite(losses[-1]) and math.isfinite(gnorms[-1]),
             f"{cfg.name} step {len(losses)}: loss {losses[-1]}, grad_norm {gnorms[-1]}")
    launches, designs = launch_counts(), design_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = {name: 0 for name in launches}
    want.update(spec["want"])
    print(f"{cfg.name} training launches over {TRAIN_STEPS} steps: {launches} by design {designs}")
    need(launches == want, f"{cfg.name} training launched {launches}, expected {want}")
    need(designs == spec["designs"], f"{cfg.name} training's designs {designs}, expected "
         f"{spec['designs']}")
    need(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: {losses}")
    need(peak_gb < 80, f"{cfg.name}: peak memory {peak_gb:.2f} GB")
    state, breakdown = train_breakdown(torch, step_fn, state, batches[-1])

    tokens = TRAIN_B * TRAIN_S
    step_s = float(np.median(seconds[1:]))
    model_ops = 6 * n_matmul * tokens + spec["extra_ops"]
    mfu = model_ops / (step_s * BF16_OPS_PER_S)
    print(f"training {cfg.name} at full width, {cfg.n_layers} of {full_layers} layers "
          f"({n_params} parameters, {n_matmul} in products, vocab {cfg.vocab_size} padded to "
          f"{padded_vocab(cfg)}), {TRAIN_B} x {TRAIN_S} tokens a step in {micro} microbatches: "
          f"losses {losses}, grad_norms {gnorms}; step seconds {seconds} (median after the first "
          f"{step_s:.4f} s, {tokens / step_s:.1f} tokens/s, MFU {mfu:.4f} = {model_ops:.4e} "
          f"operations a step over 989 TFLOP/s{spec['ops_note']}); peak memory {peak_gb:.2f} GB; "
          f"weights drawn in {init_s:.2f} s on {nvidia_smi_line()}")

    # the same weights through the kernels and through the plain versions
    short = {k: v[:1, :spec["plain_tokens"]] for k, v in batches[0].items()}
    against = {"tokens": spec["plain_tokens"]}
    for compute in spec["compare_in"]:
        ccfg = dataclasses.replace(cfg, compute_dtype=compute)
        reset_launch_counts()
        loss_k, gnorm_k, grads_k = grads_of(torch, ccfg, state.params, short, spec["weights"])
        counts = launch_counts()
        need(all(counts[name] == n for name, n in spec["short"].items()),
             f"{cfg.name}: the kernel run launched {counts}, expected {spec['short']}")
        with spec["plain"]():
            loss_p, gnorm_p, grads_p = grads_of(torch, ccfg, state.params, short,
                                                spec["weights"])
        need(launch_counts() == counts, "the plain run launched a kernel")
        frob = {key: float(torch.linalg.vector_norm(grads_k[key] - grads_p[key])
                           / torch.linalg.vector_norm(grads_p[key])) for key in grads_p}
        worst = max(frob, key=frob.get)
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        gnorm_err = abs(gnorm_k - gnorm_p) / gnorm_p
        gated = compute == spec["weights_gated_in"]
        floor = {}
        if "floor" in spec and compute == "bfloat16":  # plain against plain, rounded otherwise
            with spec["floor"]():
                floor = grads_of(torch, ccfg, state.params, short, spec["weights"])[2]
            floor = {key: float(torch.linalg.vector_norm(floor[key] - grads_p[key])
                                / torch.linalg.vector_norm(grads_p[key])) for key in grads_p}
        by_name = {}
        for (_, name), e in frob.items():
            by_name[name] = max(by_name.get(name, 0.0), e)
        floor_by_name = {}
        for (_, name), e in floor.items():
            floor_by_name[name] = max(floor_by_name.get(name, 0.0), e)
        print(f"{cfg.name} kernels against the plain versions at 1 x {spec['plain_tokens']} tokens "
              f"in {compute}: loss {loss_k} vs {loss_p} ({loss_err:.3e} relative, limit "
              f"{TRAIN_LOSS_TOL}), grad_norm {gnorm_k} vs {gnorm_p} ({gnorm_err:.3e}, limit "
              f"{TRAIN_GNORM_TOL}), worst of {len(frob)} weight gradients {frob[worst]:.3e} "
              f"relative Frobenius ({worst}; "
              f"{f'limit {TRAIN_GRAD_FROB}' if gated else 'not gated in this compute type'}); "
              f"worst by weight {({k: float(f'{e:.3e}') for k, e in by_name.items()})}"
              + (f"; the plain versions against themselves with a one-ulp jitter of the "
                 f"recurrence's gradients, worst by weight "
                 f"{({k: float(f'{e:.3e}') for k, e in floor_by_name.items()})}" if floor else ""))
        need(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
             and (not gated or frob[worst] <= TRAIN_GRAD_FROB),
             f"{cfg.name}: the kernels' step is not the plain versions' in {compute}")
        against[compute] = {"loss": [loss_k, loss_p], "grad_norm": [gnorm_k, gnorm_p],
                            "worst_grad_frobenius": frob[worst], "worst_weight": list(worst),
                            "gated": gated, "by_weight": by_name,
                            "floor_by_weight": floor_by_name or None}
    del state, grads_k, grads_p, floor
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": full_layers,
            "parameters": n_params, "matmul_parameters": n_matmul, "tokens_a_step": tokens,
            "microbatches": micro, "steps": TRAIN_STEPS, "losses": losses, "grad_norms": gnorms,
            "step_seconds": seconds, "median_step_s": step_s, "tokens_per_s": tokens / step_s,
            "mfu": mfu, "peak_memory_gb": peak_gb, "init_s": init_s, "breakdown": breakdown,
            "launches": launches, "against_plain": against}


def check_guards(torch, dev):
    """Phase 28 (d): every kernel wrapper without a backward raises on a CUDA
    tensor that requires grad, before it launches anything."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.selective_scan.ops import selective_scan

    f32, bf = torch.float32, torch.bfloat16

    def t(*shape, dtype=f32, grad=False):
        return torch.randn(*shape, device=dev).to(dtype).requires_grad_(grad)

    calls = {
        "decode_attention": lambda: decode_attention(
            t(2, 8, 128, dtype=bf, grad=True), t(2, 64, 2, 128, dtype=bf),
            t(2, 64, 2, 128, dtype=bf), torch.full((2,), 64, dtype=torch.int32, device=dev)),
        "flash_prefill": lambda: flash_prefill(
            t(1, 64, 8, 128, dtype=bf), t(1, 64, 2, 128, dtype=bf, grad=True),
            t(1, 64, 2, 128, dtype=bf)),
        "selective_scan": lambda: selective_scan(
            t(1, 4, 128), t(1, 4, 128, grad=True), t(128, 16), t(1, 4, 16), t(1, 4, 16), t(128),
            torch.zeros(1, 128, 16, device=dev)),
    }
    before = launch_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as exc:
            need("no backward" in str(exc), f"{name} raised another error: {exc}")
        else:
            raise Failed(f"{name} ran on a tensor that requires grad")
    need(launch_counts() == before, "a guarded wrapper launched its kernel")
    print(f"guards: {sorted(calls)} raise on a CUDA tensor that requires grad, before any launch")
    return sorted(calls)


def check_training(torch, dev, batches):
    """Phase 28: the backward kernel and the forward's lse against their
    plain versions at the training shapes; glm4-9b and gemma-7b (head_dim
    256) trained at full width for TRAIN_STEPS steps through the kernels
    with exact launch counts, each with a kernel run against a plain-version
    run from the same weights; and the guards.  ``batches``: arch -> the
    data worker's future."""
    from repro_torch.kernels.flash_prefill.kernel import BWD_LAUNCHES, bwd_design, train_design
    from repro_torch.launch.train import config

    from tools.time_flash_bwd_designs import floor_ms

    flush = l2_flush(torch, dev)
    cases = [check_bwd_case(torch, dev, label, shape, bf16, causal, flush)
             for label, shape, bf16, causal in BWD_CASES]
    floor = floor_ms(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()

    bf16 = torch.bfloat16
    trained = {}
    for arch, depth, micro in ((TRAIN_ARCH, TRAIN_DEPTH, TRAIN_MICRO),
                               (GEMMA_ARCH, GEMMA_DEPTH, GEMMA_MICRO)):
        cfg = config(arch, smoke=False, depth=depth)
        L, D = cfg.n_layers, cfg.head_dim
        n_bwd = BWD_LAUNCHES[bwd_design(bf16, cfg.head_dim)]  # launches a backward call
        fwd = L * micro * 2 * TRAIN_STEPS  # a layer's forward and its recomputation under remat
        bwd = L * micro * n_bwd * TRAIN_STEPS
        t0 = time.perf_counter()
        data = batches[arch].result(timeout=900)
        print(f"{arch}: waited {time.perf_counter() - t0:.2f} s for the data")
        trained[arch] = train_full_width(torch, dev, cfg, micro, data, {
            "want": {"flash_prefill": fwd, "flash_prefill_bwd": bwd},
            "designs": {"flash_prefill": {f"{train_design(bf16, D)}, causal, lse": fwd},
                        "flash_prefill_bwd": {f"{bwd_design(bf16, D)}, causal": bwd}},
            "short": {"flash_prefill": 2 * L, "flash_prefill_bwd": n_bwd * L},
            "plain": plain_training_attention, "plain_tokens": TRAIN_PLAIN_TOKENS,
            "compare_in": ("bfloat16",), "weights_gated_in": "bfloat16",
            "weights": ATTN_WEIGHTS, "matmuls": MATMUL_WEIGHTS,
            "extra_ops": L * 7 * 2 * TRAIN_B * cfg.n_heads * D * (TRAIN_S * (TRAIN_S + 1) // 2),
            "ops_note": ", attention's 7 products a layer counted"})
        trained[arch].update(forward_design=train_design(bf16, D),
                             backward_design=bwd_design(bf16, D),
                             launches_8_steps={"flash_prefill": fwd, "flash_prefill_bwd": bwd})
    guarded = check_guards(torch, dev)

    glm4 = cases[0]
    glm4_train = trained[TRAIN_ARCH]
    return {
        "kernel": {"max_abs_err": max(c["max_abs_err"] for c in cases),
                   **{k: glm4[k] for k in ("ms", "earlier_ms", "turns", "plain_ms", "bound_ms",
                                           "bound_by", "own_bound_ms", "library_ms",
                                           "sdpa_forward_ms")},
                   "floor_ms": floor,
                   "library": "scaled_dot_product_attention backward (torch.autograd.grad)",
                   "design": glm4_train["backward_design"],
                   "launches_a_step": glm4_train["launches_8_steps"]["flash_prefill_bwd"]
                   // TRAIN_STEPS,
                   "gemma_d256": {k: cases[1][k] for k in (
                       "design", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                       "max_abs_err", "forward_ms", "lse_max_abs_err")},
                   "cases": cases},
        "lse_max_abs_err": max(c["lse_max_abs_err"] for c in cases),
        "launches": glm4_train["launches_8_steps"],
        "train": glm4_train, "gemma": trained[GEMMA_ARCH],
        "guarded": guarded,
    }


# -- training the SSM family (phase 29) -----------------------------------------------

#: phase 29: rwkv6-1.6b trained at full width and full depth (24 layers) in
#: TRAIN_MICRO microbatches; the wkv6 backward kernel at its training
#: microbatch (B, S, H, n), where it is timed
SSM_TRAIN_PLAIN_TOKENS, WKV_TRAIN = 256, (TRAIN_B // TRAIN_MICRO, TRAIN_S, 32, 64)
#: the backward kernel against its plain version: each of dr, dk, dv, dw and du
#: within this share of its largest |value|: float32 sums in another order
#: (the lane's columns, then two xor shuffles; dv's row pairs and slices in
#: order), carried by G over up to 4096 steps at w ~ 0.9975
WKV_BWD_TOL = 1e-4
#: (label, B, S, H, n, decay, start state): every head dim at S of one step,
#: one short of a 16-step chunk, one chunk, one past it and 2049; slow decay
#: (rwkv6's w0 = -6, w ~ 0.9975) and fast (w ~ 1e-3); a mid-run start state;
#: the training microbatch
WKV_BWD_CASES = tuple(
    (f"n={n} S={S} {decay}", 2, S, 4, n, decay, "zero")
    for n in (16, 32, 64) for S in (1, 15, 16, 17, 2049) for decay in ("slow", "1e-3")
) + (("from a mid-run state", 2, 2049, 4, 64, "slow", "mid-run"),
     ("training microbatch", *WKV_TRAIN, "slow", "zero"))
#: the time-mix weights whose gradients the kernel run is held to the plain
#: run's, in float32 compute: through bf16 products a one-ulp jitter of the
#: plain recurrence's own gradients moves them about as far as the kernel's
#: float32 sums in another order do (mu_w's most: its gradient is two bf16
#: sums over the tokens, x and x_prev, that nearly cancel), so the bf16
#: comparison gates the loss and grad_norm and prints the weights beside that
#: floor
TIME_MIX_WEIGHTS = ("w_r", "w_k", "w_v", "w_g", "w_o", "w_lora_a", "w_lora_b", "w0", "u",
                    "mu_r", "mu_k", "mu_v", "mu_w", "mu_g")
RWKV_MATMUL_WEIGHTS = ("w_r", "w_k", "w_v", "w_g", "w_o", "w_lora_a", "w_lora_b", "w_ck", "w_cv",
                       "w_cr")


def wkv6_bwd_bound(B, S, H, n):
    """r, k, v, w and dy read once, dr, dk, dv and dw written once (and the
    start state, u and du); 14 float32 flops an (b, t, h, i, j): S (3), G
    (3), and a product and a sum for each of dr, dk, dv, dw."""
    n_bytes = 4 * (9 * B * S * H * n + B * H * n * n + 2 * H * n)
    return bound_ms(n_bytes, 14 * B * S * H * n * n)


def check_wkv6_bwd_kernel(torch, dev, flush):
    """Phase 29 (a): the wkv6 backward kernel against its plain version on
    the card at WKV_BWD_CASES, each of dr, dk, dv, dw and du within
    WKV_BWD_TOL of its largest, two runs bit for bit; at the training
    microbatch timed cold beside the forward kernel, its bound, the plain
    version and the floor of the timing (B = H = S = 1, n = 16)."""
    from repro_torch.kernels.wkv6.kernel import BWD_LAUNCHES, launch, launch_bwd
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref

    names = ("dr", "dk", "dv", "dw", "du")
    worst, train = 0.0, None
    for i, (label, B, S, H, n, decay, state) in enumerate(WKV_BWD_CASES):
        r, k, v, w, u, s0 = wkv6_inputs(torch, dev, B, S, H, n, seed=290 + i, decay=decay,
                                         state=state)
        dy = torch.randn(B, S, H, n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(i))
        got, again = launch_bwd(r, k, v, w, u, s0, dy), launch_bwd(r, k, v, w, u, s0, dy)
        want = wkv6_bwd_ref(r, k, v, w, u, s0, dy)
        errs = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for name, a, b in zip(names, got, want)}
        print(f"wkv6_bwd {label} B={B} S={S} H={H} n={n}, {state} start state: |kernel - plain| / "
              f"largest: {', '.join(f'{k_} {e:.3e}' for k_, e in errs.items())} (limit "
              f"{WKV_BWD_TOL:.0e})")
        need(all(bool(torch.isfinite(a).all()) for a in got), f"wkv6_bwd {label}: non-finite")
        need(max(errs.values()) <= WKV_BWD_TOL, f"wkv6_bwd {label}: {errs} > {WKV_BWD_TOL}")
        need(all(torch.equal(a, b) for a, b in zip(got, again)), f"wkv6_bwd {label}: two runs "
             f"differ")
        worst = max(worst, max(errs.values()))
        if (B, S, H, n) == WKV_TRAIN:
            train = {"max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                     "relative_err": errs}
        del r, k, v, w, u, s0, dy, got, again, want
    need(train is not None, "no training-microbatch case")
    torch.cuda.empty_cache()
    B, S, H, n = WKV_TRAIN
    r, k, v, w, u, s0 = wkv6_inputs(torch, dev, B, S, H, n, seed=290)
    dy = torch.randn_like(r)
    ms = timed_ms(torch, lambda: launch_bwd(r, k, v, w, u, s0, dy), 10, flush)
    work = s0.clone()
    fwd_ms = timed_ms(torch, lambda: launch(r, k, v, w, u, work), 10, flush,
                      reset=lambda: work.copy_(s0))
    plain_ms = timed_ms(torch, lambda: wkv6_bwd_ref(r, k, v, w, u, s0, dy), 1, flush)
    tiny = wkv6_inputs(torch, dev, 1, 1, 1, 16, seed=291)
    dy1 = torch.randn_like(tiny[0])
    floor = timed_ms(torch, lambda: launch_bwd(*tiny, dy1), 20, flush)
    bound, by = wkv6_bwd_bound(B, S, H, n)
    print(f"wkv6_bwd training microbatch B={B} S={S} H={H} n={n}: cold {ms * 1e3:.1f} us, "
          f"{BWD_LAUNCHES} launches (the forward kernel at the same shape {fwd_ms * 1e3:.1f} us; "
          f"bound {bound * 1e3:.1f} us by {by}, kernel / bound {ms / bound:.2f}; plain "
          f"{plain_ms * 1e3:.1f} us; library call: none; floor of the timing "
          f"{floor * 1e3:.2f} us) on {nvidia_smi_line()}")
    return {"ms": ms, "forward_ms": fwd_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "floor_ms": floor,
            "launches_a_call": BWD_LAUNCHES, **train, "worst_relative_err": worst,
            "cases": len(WKV_BWD_CASES)}


def check_ssm_training(torch, dev, batches):
    """Phase 29: (a) the wkv6 backward kernel against its plain version and
    timed; (b) rwkv6-1.6b trained at full width and full depth through the
    wkv6 and wkv6_bwd kernels, exact launch counts (two wkv6 a layer and
    microbatch, the forward and its recomputation under remat; one backward
    call), no attention launch, a kernel run against a plain-version run."""
    from repro_torch.kernels.wkv6.kernel import BWD_DESIGN, BWD_LAUNCHES
    from repro_torch.launch.train import config

    t0 = time.perf_counter()
    print(f"SSM training phase 29 on {nvidia_smi_line()}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated at its start")
    flush = l2_flush(torch, dev)
    kernel = check_wkv6_bwd_kernel(torch, dev, flush)
    del flush
    t1 = time.perf_counter()
    cfg = config(SSM_ARCH, smoke=False)
    L, micro = cfg.n_layers, TRAIN_MICRO
    fwd = L * micro * 2 * TRAIN_STEPS
    bwd = L * micro * BWD_LAUNCHES * TRAIN_STEPS
    data = batches[SSM_ARCH].result(timeout=900)
    train = train_full_width(torch, dev, cfg, micro, data, {
        "want": {"wkv6": fwd, "wkv6_bwd": bwd},
        "designs": {"wkv6": {DESIGNS["wkv6"]: fwd}, "wkv6_bwd": {BWD_DESIGN: bwd}},
        "short": {"wkv6": 2 * L, "wkv6_bwd": BWD_LAUNCHES * L},
        "plain": plain_training_wkv, "plain_tokens": SSM_TRAIN_PLAIN_TOKENS,
        "compare_in": ("bfloat16", "float32"), "weights_gated_in": "float32",
        "floor": jittered_plain_wkv, "weights": TIME_MIX_WEIGHTS, "matmuls": RWKV_MATMUL_WEIGHTS, "extra_ops": 0,
        "ops_note": "; the recurrence's flops are left out"})
    secs = {"kernel": t1 - t0, "training": time.perf_counter() - t1,
            "all": time.perf_counter() - t0}
    print(f"phase 29: {secs['all']:.2f} s ({secs}) on {nvidia_smi_line()}")
    return {"kernel": kernel, "train": train, "launches": {"wkv6": fwd, "wkv6_bwd": bwd},
            "seconds": secs}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6.kernel import BWD_DESIGN as WKV6_BWD_DESIGN

    dev = torch.device("cuda", torch.cuda.current_device())
    card = nvidia_smi_line()
    t_main = time.perf_counter()
    print(f"python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    # phase 28's yardstick, the backward's earlier design (kept as text by
    # tools/time_flash_bwd_designs.py), builds beside the package's sources
    from tools.time_flash_bwd_designs import earlier_entry

    earlier_build = threading.Thread(target=earlier_entry, daemon=True)
    earlier_build.start()
    _libs, logs = _build.build_all()
    earlier_build.join()
    print(f"build: {time.perf_counter() - t0:.2f} s, {sorted(_libs)} and the earlier "
          f"flash_prefill_bwd design")
    serialized = []
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
            if "serialized" in line or "C7514" in line or "C7518" in line:
                print(f"  {name}: {line.strip()}")
                serialized.append(f"{name}: {line.strip()}")
    need(not serialized, f"ptxas serialized a wgmma: {serialized}")

    from repro_torch.configs.base import get_arch

    # phase 28's and 29's data, made by a worker process while the card runs phases 1-27
    train_pool, train_data = start_train_batches((TRAIN_ARCH, GEMMA_ARCH, SSM_ARCH))
    t0 = time.perf_counter()
    trace = zipf(N, T, alpha=ALPHA, seed=0)
    print(f"trace: zipf N={N} T={T} alpha={ALPHA}, {time.perf_counter() - t0:.2f} s")
    eta = theoretical_eta(C, N, T, 1)

    t_lap = [time.perf_counter()]

    def lap(phases):  # the seconds since the last lap, by phase
        now = time.perf_counter()
        print(f"phases {phases}: {now - t_lap[0]:.2f} s")
        t_lap[0] = now

    carry = tree_state(trace, eta)
    rows = check_kernels(torch, dev, trace, eta, dense_tau(trace, eta), carry)
    rows.update(check_tree_kernels(torch, dev, carry, eta))
    rows.update(check_tree_sums(torch, dev, carry, trace, rows.pop("segsum")))
    lap("1-3 (the trace, the kernels against their plain versions)")
    launches, designs = check_main_path(torch, trace, eta)
    check_card_against_cpu(trace, eta)
    check_resume(torch, trace, eta)
    breakdown(torch, trace, eta)
    lap("4-7 (the dense main path)")
    tree_launches, tree_designs = check_tree_main_path(trace, eta)
    check_tree_card_against_cpu(trace, eta)
    check_tree_repeat_and_resume(torch, trace, eta)
    reanchor_histograms = check_reanchor(torch, trace, eta)
    madow_segsum = check_madow(trace, eta)
    tree_profile = breakdown(torch, trace, eta, kind="ogb_tree")
    lap("8-11 (the lazy main path, Madow)")
    attn_errs = check_attention_kernels(torch, dev)
    rows.update(time_attention_kernels(torch, dev, attn_errs))
    lap("12-13 (attention)")
    engine, prompts, first_out, serve_launches, _ = serve_full_width(torch, dev)
    serve_breakdown(torch, engine, prompts)
    check_served_against_plain(torch, engine, prompts, first_out)
    del engine
    lap("14-15 (serving)")

    t_scenarios = time.perf_counter()
    pool, cpu_futures = start_cpu_quick()
    try:
        rows["slot_automaton"] = check_slot_automaton(torch, dev)
        lap("16 (the slot automaton)")
        scenario_launches = check_scenarios(torch, cpu_futures)
        fig8_launches = check_paper_scale(torch)
        print(f"scenario phases 16-18: {time.perf_counter() - t_scenarios:.2f} s")
        t_tree = time.perf_counter()
        tree_rows, int32_build = check_tree_automata(torch, dev)
        rows.update(tree_rows)
        print(f"tree automata phase 19: {time.perf_counter() - t_tree:.2f} s")
        t_sized = time.perf_counter()
        sized_rows = check_sized_kernels(torch, dev)
        print(f"sized kernels phase 20: {time.perf_counter() - t_sized:.2f} s")
        t_sized = time.perf_counter()
        sized_launches, sized_full, sized_flip, sized_groups, sized_chunk = check_sized_scenario(
            torch, cpu_futures[SIZED])
        print(f"sized scenario phase 21: {time.perf_counter() - t_sized:.2f} s")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    expert_pool, expert_runs = start_cpu_expert_runs()
    try:
        swept = check_sweep(torch, dev, trace)
        fleet23 = check_fleet(torch, dev, trace, cpu_futures[EDGE])
        moe24 = check_moe(torch, dev, expert_runs)
    finally:
        expert_pool.shutdown(wait=True, cancel_futures=True)
    families25 = check_families(torch, dev)
    lap("17-25 (scenarios, sized, sweep, streams and fleets, MoE, the attention families)")
    ssm26 = check_ssm(torch, dev)
    lap("26 (the SSM family)")
    hybrid27 = check_hybrid(torch, dev)
    lap("27 (the hybrid family)")
    try:
        train28 = check_training(torch, dev, train_data)
        lap("28 (training the attention families)")
        ssm29 = check_ssm_training(torch, dev, train_data)
        lap("29 (training the SSM family)")
    finally:
        train_pool.shutdown(wait=True, cancel_futures=True)
    # training (phase 28): the backward kernel's launches in glm4-9b's 8
    # steps, and the forward's training launches (with the lse) beside its row
    launches["flash_prefill_bwd"] = train28["launches"]["flash_prefill_bwd"]
    rows["flash_prefill_bwd"] = train28["kernel"]
    rows["flash_prefill"]["training"] = {
        "launches_8_steps": train28["launches"]["flash_prefill"],
        "design": train28["train"]["forward_design"],
        "lse_max_abs_err": train28["lse_max_abs_err"],
        "forward_ms_glm4_train": train28["kernel"]["cases"][0]["forward_ms"],
        "forward_ms_gemma_train": train28["kernel"]["cases"][1]["forward_ms"],
        "launches_8_steps_gemma": train28["gemma"]["launches_8_steps"]["flash_prefill"]}
    rows["flash_prefill_bwd"]["launches_8_steps_gemma"] = \
        train28["gemma"]["launches_8_steps"]["flash_prefill_bwd"]
    # training the SSM family (phase 29): the recurrence's backward kernel and its
    # launches in rwkv6's 8 steps, and the forward's training launches
    launches["wkv6_bwd"] = ssm29["launches"]["wkv6_bwd"]
    rows["wkv6_bwd"] = {**ssm29["kernel"], "design": WKV6_BWD_DESIGN}
    # the SSM family (phase 26): the recurrence's launches in rwkv6's serving
    launches["wkv6"] = ssm26["launches"]["wkv6"]
    rows["wkv6"] = {**ssm26["kernel"], "launches_a_generate": ssm26["launches_a_generate"],
                    "generate_calls": SERVE_CALLS,
                    "training": {"launches_8_steps": ssm29["launches"]["wkv6"],
                                 "forward_ms_rwkv6_train": ssm29["kernel"]["forward_ms"]}}
    # the hybrid family (phase 27): the scan's launches in jamba's serving, and
    # the attention kernels at its heads with their launches there
    launches["selective_scan"] = hybrid27["launches"]["selective_scan"]
    rows["selective_scan"] = {
        **hybrid27["kernel"], "generate_calls": SERVE_CALLS, "design_step": SCAN_STEP_DESIGN,
        "launches_a_generate": hybrid27["launches_a_generate"]["selective_scan"]}
    for name in ("flash_prefill", "decode_attention"):
        rows[name]["jamba"] = {"launches": hybrid27["launches"][name],
                               "launches_a_generate": hybrid27["launches_a_generate"][name],
                               **hybrid27["attention"][name]}

    # launches: the dense main path's for its kernels, the lazy main path's
    # for the prefix-tree kernels (segsum also ran 1 a chunk on madow_tree)
    launches.update({k: tree_launches[k] for k in ("segsum", "tree_update", "bucket_mass")})
    launches.update({k: serve_launches[k] for k in ("flash_prefill", "decode_attention")})
    # the automata's: the seven quick scenarios on the card (phase 17); the
    # tree kernels' on fig8_cdn full beside them (phase 18)
    for name in ("slot_automaton", "tree_lru", "minpair_automaton", "fifo_queue"):
        launches[name] = scenario_launches[name]
    for name in ("tree_lru", "minpair_automaton", "fifo_queue"):
        rows.setdefault(name, {})
    rows["fifo_queue"].update(sized_rows["fifo_queue"])
    for name in ("tree_lru", "minpair_automaton", "fifo_queue"):
        rows[name]["launches_fig8_full"] = fig8_launches[name]
    # the sized scenario at full, this slice's path: its launches beside
    # each kernel it runs, and the new modes' own measurements
    for name in ("tree_lru", "minpair_automaton", "tree_update", "bucket_mass", "histogram",
                 "segsum"):
        rows[name]["launches_sized_cdn_full"] = sized_launches[name]
    rows["minpair_automaton"]["gds"] = sized_rows["gds"]
    rows["tree_update"]["stacked"] = sized_rows["stacked_update"]
    rows["tree_update"]["int32"] = sized_rows["int32_update"]
    rows["bucket_mass"]["sized"] = sized_rows["solve_sized"]
    rows["bucket_mass"]["sized"]["sized_cdn_full_groups"] = sized_groups
    rows["sized_cdn_full"] = {"rows": sized_full, "ranking_flip": sized_flip,
                              "ogb_sized_tree_chunk": sized_chunk}
    rows["tree_update"]["stacked"]["in_chunk"] = sized_chunk["port_kernels"].get(
        "tree_update_kernel")
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
    rows["tree_update"]["design"] = " + ".join(tree_designs["tree_update"])
    for name, design in DESIGNS.items():
        rows[name]["design"] = design
    # the tree kernels in an ogb_tree chunk, and the chunk itself (phase 11)
    for name, key in (("tree_update", "tree_update_kernel"), ("segsum", "tree_build_kernel")):
        rows[name]["in_chunk"] = tree_profile["port_kernels"].get(key)
    rows["tree_update"]["ogb_tree_chunk"] = {k: v for k, v in tree_profile.items()
                                             if k != "port_kernels"}
    # the sweep's grid forms (phase 22): the warm solve over R rows (its f'
    # epilogue the clip), the automata's grids, their launches in the sweep
    rows["mass"]["batched"] = {"launches_sweep": swept["dense"]["launches"]["mass"],
                               "chunks": swept["dense"]["chunks"],
                               **swept["warm_solve"]}
    rows["apply"]["batched"] = {"launches_sweep": swept["dense"]["launches"]["mass"],
                                "in": "the batched warm solve's epilogue (rows_R.with_epilogue "
                                      "of mass)"}
    rows["histogram"]["sweep_launches"] = swept["dense"]["launches"]["histogram"]
    for kind, name in (("lru", "tree_lru"), ("lfu", "minpair_automaton"),
                       ("fifo", "fifo_queue")):
        rows[name]["batched"] = {**swept["automaton_grids"][kind],
                                 "launches_sweep": swept["automata"][kind]["launches"],
                                 "chunks": swept["automata"][kind]["chunks"]}
    rows["minpair_automaton"]["batched"]["launches_sweep_ftpl"] = \
        swept["automata"]["ftpl"]["launches"]
    # the fleets (phase 23): each per-row kernel's launches in its fleet over
    # edge_fleet_cdn full's edge tier and its time at those shapes
    fleet, row_kernels = fleet23["fleet"], fleet23["row_kernels"]
    rows["histogram"]["fleet"] = {"launches_ogb_fleet": fleet["ogb"]["launches"]["histogram"],
                                  "chunks": fleet["ogb"]["chunks"], **row_kernels["histogram"]}
    rows["mass"]["fleet"] = {"launches_ogb_fleet": fleet["ogb"]["launches"]["mass"],
                             "chunks": fleet["ogb"]["chunks"], **row_kernels["mass"]}
    rows["apply"]["fleet"] = {"launches_ogb_fleet": fleet["ogb"]["launches"]["mass"],
                              "in": "the fleet's warm solve's epilogue (fleet of mass)"}
    rows["tree_lru"]["fleet"] = {"launches_lru_fleet": fleet["lru"]["launches"]["tree_lru"],
                                 "chunks": fleet["lru"]["chunks"], **row_kernels["tree_lru"]}
    rows["minpair_automaton"]["fleet"] = {
        "launches_lfu_fleet": fleet["lfu"]["launches"],
        "launches_ftpl_fleet": fleet["ftpl"]["launches"], "chunks": fleet["lfu"]["chunks"],
        **row_kernels["minpair_automaton"]}
    rows["fifo_queue"]["fleet"] = {"launches_fifo_fleet": fleet["fifo"]["launches"],
                                   "chunks": fleet["fifo"]["chunks"], **row_kernels["fifo_queue"]}
    # MoE serving and the expert cache (phase 24): granite-moe's attention
    # launches and times at its served shapes, ogb_grad's projection a step
    for name in ("flash_prefill", "decode_attention"):
        rows[name]["granite_moe"] = moe24["served"]["attention"][name]
    # the attention families (phase 25): the new modes at the shapes their
    # models launch them, with those models' launches
    encdec, vlm, int8 = families25["encdec"], families25["vlm"], families25["int8"]
    for name in ("non_causal", "cross"):
        rows["flash_prefill"][name] = {
            "launches_whisper_prefill": encdec["launches_by_mode"]["flash_prefill"][
                "wgmma+tma, " + name.replace("_", "-")], **encdec["timed"][name]}
    rows["flash_prefill"]["phi3_vision"] = {"launches": vlm["launches"]["flash_prefill"],
                                            **vlm["prefill_d96"]}
    rows["decode_attention"]["int8"] = {"launches_mistral_serving":
                                        int8["launches"]["decode_attention"], **int8["decode"]}
    rows["decode_attention"]["whisper"] = {"launches": encdec["launches"]["decode_attention"],
                                           "of_them_cross": encdec["cross_decode_launches"]}
    rows["decode_attention"]["phi3_vision"] = {"launches": vlm["launches"]["decode_attention"]}
    for name, per_step in (("mass", 50), ("apply", 1)):
        rows[name]["ogb_grad"] = {
            "launches_a_step": per_step,
            "steps": {c: EXPERT_STEPS + DRIFT_STEPS for c in EXPERT_CATALOGS},
            **moe24["projection"][name]}
    print(f"segsum launches: ogb_tree main path {launches['segsum']}, madow_tree "
          f"{madow_segsum} over {MADOW_CHUNKS} chunks")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in KERNELS
    ]
    print(f"chip_smoke.py: every phase in {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels, "sized_cdn_full": rows["sized_cdn_full"],
                      "sweep": {"dense": swept["dense"], "automata": swept["automata"]},
                      "stream": fleet23["stream"], "fleet": fleet,
                      "edge_quick": fleet23["edge_quick"],
                      "moe": {k: moe24[k] for k in ("served", "dispatch", "experts")},
                      "families": {
                          name: {k: v for k, v in families25[name].items()
                                 if k not in ("decode", "timed", "prefill_d96")}
                          for name in ("int8", "vlm", "encdec")},
                      "ssm": {k: v for k, v in ssm26.items() if k != "kernel"},
                      "hybrid": {k: v for k, v in hybrid27.items()
                                 if k not in ("kernel", "attention")},
                      "training": {"train": train28["train"], "gemma": train28["gemma"],
                                   "rwkv6": ssm29["train"], "guarded": train28["guarded"]}}))
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
