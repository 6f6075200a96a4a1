"""The prefix-tree block reductions: one tree level, and bucket masses.

Counterpart of ``repro.kernels.prefix_tree.kernel``.  On a CUDA tensor
:func:`block_segment_sums` launches ``csrc/segsum.cu``'s one-level kernel
(the trees themselves are built in one launch a tree by
:func:`.ops.tree_build`), and
:func:`bucket_masses`, :func:`solve_buckets` (``ogb_tree``'s whole
threshold solve, one persistent launch) and :func:`solve_sized` (the sized
OGB's Newton solve over its size classes, one launch)
``csrc/bucket_mass.cu``; on a CPU tensor each runs its plain version in
:mod:`.ref`.  The thresholds stay on
the device and the kernels read them by pointer, so no call waits on the
host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.capped_simplex.ops import Scalar, as_scalar
from repro_torch.kernels.prefix_tree.ref import (
    SIZED_GROUP,
    bucket_masses_ref,
    segment_sums_ref,
    solve_buckets_ref,
    solve_rounds,
    solve_sized_ref,
    tree_storage,
)

#: the design :func:`block_segment_sums` counts its launches under
ONE_LEVEL = "one level"
#: buckets of one bucket-mass partials block; the grid is capped so that
#: the finishing block sums at most this many partials
_MASS_ITEMS_PER_BLOCK = 1024
_MASS_MAX_BLOCKS = 1024
#: threads of a solve block, buckets it keeps in shared memory, and the
#: partials a block writes a round (kSolveThreads, kChipBuckets and
#: kSolvePoints of csrc/bucket_mass.cu)
SOLVE_THREADS, SOLVE_CHIP_BUCKETS, SOLVE_POINTS = 1024, 4096, 63


@functools.lru_cache(maxsize=None)
def _segsum_entry():
    fn = _build.library("segsum").repro_segsum
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bucket_mass_entry():
    fn = _build.library("bucket_mass").repro_bucket_masses
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _solve_entry():
    fn = _build.library("bucket_mass").repro_solve_buckets
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def block_segment_sums(values: torch.Tensor, out_size: int, radix: int) -> torch.Tensor:
    """One tree-build level: (out_size,) sums of ``radix`` consecutive
    float32 children, the last group zero-padded."""
    if values.dim() != 1 or radix < 1 or out_size * radix < values.shape[0]:
        raise ValueError(
            f"{values.shape[0]} values do not fit {out_size} groups of {radix}"
        )
    if values.device.type == "cpu":
        return segment_sums_ref(values, out_size, radix)
    _build.require(values, torch.float32, "values")
    out = torch.empty(out_size, dtype=torch.float32, device=values.device)
    _build.check(
        _segsum_entry()(
            values.data_ptr(), values.numel(), radix, out.data_ptr(), out_size,
            _build.stream_of(values),
        ),
        "block_segment_sums",
    )
    _build.counted(block_segment_sums, ONE_LEVEL)
    return out


block_segment_sums.launches = 0
block_segment_sums.designs = {}


def bucket_masses(cnt: torch.Tensor, total: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[k] = sum_b cnt_b * clip(mean_b - taus[k], 0, 1) over (V,)
    bucket counts and sums: float32 terms summed in float64, rounded to
    float32.  Any K >= 1."""
    if cnt.dim() != 1 or cnt.shape != total.shape or cnt.numel() == 0:
        raise ValueError(
            f"cnt and total must be non-empty 1-D of one shape, got "
            f"{tuple(cnt.shape)} and {tuple(total.shape)}"
        )
    if taus.dim() != 1 or taus.numel() == 0:
        raise ValueError(f"taus must be non-empty 1-D, got {tuple(taus.shape)}")
    if cnt.device.type == "cpu":
        return bucket_masses_ref(cnt, total, taus)
    for t, name in ((cnt, "cnt"), (total, "total"), (taus, "taus")):
        _build.require(t, torch.float32, name, cnt.device)
    v, k = cnt.numel(), taus.numel()
    blocks = min(-(-v // _MASS_ITEMS_PER_BLOCK), _MASS_MAX_BLOCKS)
    pmass = torch.empty(k * blocks, dtype=torch.float64, device=cnt.device)
    mass = torch.empty(k, dtype=torch.float32, device=cnt.device)
    _build.check(
        _bucket_mass_entry()(
            cnt.data_ptr(), total.data_ptr(), taus.data_ptr(), k, v, blocks,
            pmass.data_ptr(), mass.data_ptr(), _build.stream_of(cnt),
        ),
        "bucket_masses",
    )
    _build.counted(bucket_masses, "k-way, partials and finish")
    return mass


bucket_masses.launches = 0
bucket_masses.designs = {}


def solve_plan(v: int, iters: int, sms: int, chip_blocks_per_sm: int,
               stream_blocks_per_sm: int) -> dict:
    """The persistent bucket solve's launch over ``v`` buckets.

    One block per resident slot: ``sms`` times the blocks an SM holds of the
    kernel that keeps the buckets' counts and means in shared memory, if each
    block's share of the ``v`` buckets fits there (``SOLVE_CHIP_BUCKETS``);
    else of the kernel that re-reads them every round.  ``partials`` is the
    length of the (rounds, SOLVE_POINTS, blocks) float64 partials buffer."""
    blocks = sms * chip_blocks_per_sm
    on_chip = -(-v // blocks) <= SOLVE_CHIP_BUCKETS
    if not on_chip:
        blocks = sms * stream_blocks_per_sm
    rounds = len(solve_rounds(iters))
    return {"blocks": blocks, "on_chip": on_chip, "rounds": rounds,
            "partials": rounds * SOLVE_POINTS * blocks,
            "design": "persistent, means " + ("in shared memory" if on_chip else "re-read from L2")}


def solve_buckets(cnt: torch.Tensor, total: torch.Tensor, cap: Scalar, lo: Scalar,
                  hi: Scalar, iters: int) -> torch.Tensor:
    """The largest threshold in [lo, hi], to ``iters`` halvings, whose bucket
    mass over the (V,) counts and sums is at least ``cap``, as
    :func:`.ref.solve_buckets_ref` finds it; a 0-d float32 tensor.  On the
    card the whole solve is one persistent launch."""
    if cnt.dim() != 1 or cnt.shape != total.shape or cnt.numel() == 0:
        raise ValueError(
            f"cnt and total must be non-empty 1-D of one shape, got "
            f"{tuple(cnt.shape)} and {tuple(total.shape)}"
        )
    dev = cnt.device
    cap, lo, hi = (as_scalar(x, dev) for x in (cap, lo, hi))
    if dev.type == "cpu":
        return solve_buckets_ref(cnt, total, cap, lo, hi, iters)
    for t, name in ((cnt, "cnt"), (total, "total"), (cap, "cap"), (lo, "lo"), (hi, "hi")):
        _build.require(t, torch.float32, name, dev)
    v = cnt.numel()
    plan = solve_plan(v, iters, _build.sm_count(dev.index),
                      *(_build.blocks_per_sm("bucket_mass", "repro_solve_buckets_occupancy",
                                             dev.index, on_chip)
                        for on_chip in (True, False)))
    pmass = torch.empty(plan["partials"], dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _build.check(
        _solve_entry()(
            cnt.data_ptr(), total.data_ptr(), cap.data_ptr(), lo.data_ptr(), hi.data_ptr(), v,
            iters, plan["blocks"], int(plan["on_chip"]), pmass.data_ptr(), out.data_ptr(),
            _build.stream_of(cnt),
        ),
        "solve_buckets",
    )
    _build.counted(solve_buckets, plan["design"])
    return out


solve_buckets.launches = 0
solve_buckets.designs = {}


#: the design :func:`solve_sized` counts its launches under; the card picks
#: the plan by G, the groups of 64 buckets that hold an item
SIZED_DESIGN = ("one block: the groups of 64 buckets that hold an item from the trees' first "
                "level, their (count, mean) in shared memory; to 32 groups a step is a warp a "
                "group and a warp a class among max(G, K) warps on a named barrier, Newton by "
                "every thread; past 32 a warp a group, a warp a class, Newton by one thread, "
                "three block barriers")
#: the most size classes one launch takes (kSizedMaxClasses)
SIZED_MAX_CLASSES = 32
#: the most groups the few-groups plan takes, and the tally's bins of G
#: (kSizedWarps, kTallyBins; the last bin counts G >= SIZED_TALLY_BINS - 1)
SIZED_FEW_GROUPS, SIZED_TALLY_BINS = 32, 256
_sized_tallies = {}


def sized_tally(device: torch.device) -> torch.Tensor:
    """The device's counters of :func:`solve_sized` launches, which the
    kernel adds to: (2 + SIZED_TALLY_BINS,) int32, the few-groups and the
    block plan's launches, then the launches by G.  Zero when first asked
    for; read it off the hot path (:func:`read_sized_tally`)."""
    key = (device.type, device.index)
    if key not in _sized_tallies:
        _sized_tallies[key] = torch.zeros(2 + SIZED_TALLY_BINS, dtype=torch.int32, device=device)
    return _sized_tallies[key]


def read_sized_tally(device: torch.device) -> dict:
    """The device's tally, read on the host: ``{"few groups": n, "block": n,
    "groups": {G: launches}}`` (G = SIZED_TALLY_BINS - 1 standing for that
    many or more)."""
    counts = sized_tally(device).tolist()
    return {"few groups": counts[0], "block": counts[1],
            "groups": {g: n for g, n in enumerate(counts[2:]) if n}}


def reset_sized_tally(device: torch.device) -> None:
    sized_tally(device).zero_()


@functools.lru_cache(maxsize=None)
def _sized_entry():
    fn = _build.library("bucket_mass").repro_solve_sized
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, i, p, p, p, p, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def solve_sized(ycnt: torch.Tensor, ysum: torch.Tensor, v: int, s: torch.Tensor, cap: Scalar,
                lo: Scalar, hi: Scalar, iters: int) -> torch.Tensor:
    """The sized OGB's threshold: ``iters`` safeguarded Newton steps on the
    base multiplier from ``lo`` in [lo, hi] over K classes' stacked radix-64
    count and sum trees (``ycnt``, ``ysum``: (K, tree_storage(v, 64))
    float32; ``s`` the (K,) float32 class sizes), as
    :func:`.ref.solve_sized_ref` takes them over the trees' leaves; a 0-d
    float32 tensor.  On the card one launch, which finds the buckets that
    hold an item from the trees' first level and picks its plan by how many
    groups of them there are (:func:`sized_tally` counts each)."""
    kk = s.numel()
    if ycnt.dim() != 2 or ycnt.shape != ysum.shape or ycnt.shape[0] != kk or \
            ycnt.shape[1] != tree_storage(v, SIZED_GROUP) or v <= SIZED_GROUP or v % SIZED_GROUP:
        raise ValueError(f"ycnt and ysum must be (K, {tree_storage(v, SIZED_GROUP)}) radix-64 "
                         f"trees over v > 64 leaves (a multiple of 64), K = {kk}; got "
                         f"{tuple(ycnt.shape)} and {tuple(ysum.shape)}")
    dev = ycnt.device
    cap, lo, hi = (as_scalar(x, dev) for x in (cap, lo, hi))
    if dev.type == "cpu":
        return solve_sized_ref(ycnt[:, :v], ysum[:, :v], s, cap, lo, hi, iters)
    for t, name in ((ycnt, "ycnt"), (ysum, "ysum"), (s, "s"), (cap, "cap"), (lo, "lo"),
                    (hi, "hi")):
        _build.require(t, torch.float32, name, dev)
    if kk > SIZED_MAX_CLASSES:
        raise ValueError(f"the sized solve takes at most {SIZED_MAX_CLASSES} classes, got {kk}")
    groups = torch.empty(kk * (v // SIZED_GROUP), dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _build.check(
        _sized_entry()(
            ycnt.data_ptr(), ysum.data_ptr(), ycnt.shape[1], v, kk, s.data_ptr(),
            cap.data_ptr(), lo.data_ptr(), hi.data_ptr(), iters, groups.data_ptr(),
            out.data_ptr(), sized_tally(dev).data_ptr(), _build.stream_of(ycnt),
        ),
        "solve_sized",
    )
    _build.counted(solve_sized, SIZED_DESIGN)
    return out


solve_sized.launches = 0
solve_sized.designs = {}
