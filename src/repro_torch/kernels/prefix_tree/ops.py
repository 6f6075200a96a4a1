"""Packed radix prefix trees on the device.

Counterpart of ``repro.kernels.prefix_tree.ops``: the float trees, the
int32 count trees of the tree LRU and the lexicographic (hi, lo) min-pair
trees of the tree LFU and FTPL.  A tree over ``n`` leaves with branching
factor ``radix`` (a power of two) is ONE flat tensor: level 0 is the
leaves, level l+1 holds the per-group sums (or min pairs) of level l, until
a level fits in a single radix group.

The tree's two sums are hand-written kernels on the card.
:func:`tree_build` writes the whole tree in one launch (``csrc/segsum.cu``,
each level summed from the level below as
:func:`.kernel.block_segment_sums` sums one; float32 or int32).
:func:`tree_update_` sums each touched node's deltas of a float32 tree in
float64, in input order, and rounds the node once (``csrc/tree_update.cu``:
a level's blocks, split by node, sort the call's deltas into runs by node
in shared memory and sum each run alone), so a float tree comes out the
same on every run and on either device; an int32 tree's deltas add
exactly, in any order.  :func:`stacked_tree_update_` updates K trees of
one shape, stacked in a (K, TOT) tensor, in the same one launch (the
sized OGB's per-class trees).  On a CPU tensor both run their
plain versions in :mod:`.ref`.  The prefix reads, the weighted selection
and the min-pair trees are plain tensor code, as the reference computes
them outside Pallas; the tree automata's kernels walk the min-pair trees on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_tree.ref import (
    radix_shift,
    stacked_tree_update_ref,
    tree_build_ref,
    tree_offsets,
    tree_sizes,
    tree_storage,
    tree_update_ref,
)

#: leaves a tree-build block owns at most (kTileLeaves of csrc/segsum.cu):
#: the card's build takes a radix up to this
TILE_LEAVES = 4096
#: the design :func:`tree_build` counts its launches under
WHOLE_TREE = "whole tree, one launch"


#: the most deltas one card update takes (kMaxDeltas of csrc/tree_update.cu)
MAX_UPDATE_DELTAS = 2**29
#: the most deltas an update stages in shared memory (kOnChipDeltas): past
#: them its workspace is a global buffer (:func:`update_work_bytes`)
ON_CHIP_DELTAS = 4096
#: the update's plan, by where its workspace lies: the designs
#: :func:`tree_update_` counts its launches under
UPDATE_DESIGN = ("hashed runs: 1-8 blocks a level (a block a 512 of its possible nodes) stage "
                 "the deltas in shared memory, hash their nodes, sort them into runs by node "
                 "and sum each run alone, a warp a long run where any order is exact, else a "
                 "thread in input order")
UPDATE_DESIGN_L2 = UPDATE_DESIGN.replace("in shared memory", "in a global workspace")


#: the largest int32 value: the key of padding and inactive min-pair nodes
I32_MAX = 2**31 - 1
#: the tree dtypes the card's build takes, and their C entry points
_BUILD_ENTRIES = {torch.float32: "repro_tree_build", torch.int32: "repro_tree_build_i32"}


@functools.lru_cache(maxsize=None)
def _tree_build_entry(dtype: torch.dtype = torch.float32):
    fn = getattr(_build.library("segsum"), _BUILD_ENTRIES[dtype])
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tree_update_entry():
    fn = _build.library("tree_update").repro_tree_update
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, i, i, p, p, i, i, ll, p, ll, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def update_work_bytes(deltas: int, n: int, radix: int, n_rows: int) -> int:
    """Bytes of global workspace the card's update of ``deltas`` deltas over
    ``n_rows`` trees of ``n`` leaves takes (``csrc/tree_update.cu``): 0
    where it stages the call in shared memory, as every chunk's call does."""
    fn = _build.library("tree_update").repro_tree_update_work_bytes
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    count, sizes = _levels(n, radix)
    return int(fn(deltas, ctypes.addressof(sizes), count, n_rows))


@functools.lru_cache(maxsize=None)
def _levels(n: int, radix: int):
    """The level sizes of a tree over ``n`` leaves, as the C entry points
    take them: (count, a C array of int64)."""
    sizes = tree_sizes(n, radix)
    return len(sizes), (ctypes.c_longlong * len(sizes))(*sizes)


def _lanes(radix: int, device: torch.device) -> torch.Tensor:
    return torch.arange(radix, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def leaves_for_storage(total: int, radix: int) -> int:
    """Invert :func:`tree_storage` (leaf counts are powers of two here), so
    a chunk step recovers a tree's level geometry from its carry's shape."""
    n = 1
    while n < total:
        if tree_storage(n, radix) == total:
            return n
        n *= 2
    raise ValueError(f"no power-of-two leaf count stores {total} nodes")


def tree_build(values: torch.Tensor, radix: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat packed tree from a float32 or int32 leaf vector, into ``out``
    where given (a contiguous tensor of the tree's size and dtype); on the
    card one launch writes the whole tree, leaves included."""
    radix_shift(radix)
    if values.dtype not in _BUILD_ENTRIES:
        raise TypeError(f"tree_build takes float32 or int32 leaves, got {values.dtype}")
    n = values.shape[0]
    if out is not None and (out.dtype != values.dtype or out.shape != (tree_storage(n, radix),)):
        raise ValueError(f"out must be a {values.dtype} tensor of {tree_storage(n, radix)} "
                         f"nodes, got {out.dtype} of shape {tuple(out.shape)}")
    if values.device.type == "cpu":
        tree = tree_build_ref(values, radix)
        return tree if out is None else out.copy_(tree)
    _build.require(values, values.dtype, "values")
    if values.dim() != 1 or radix > TILE_LEAVES:
        raise ValueError(f"the card builds a tree over 1-D leaves at radix <= {TILE_LEAVES}, "
                         f"got shape {tuple(values.shape)} at radix {radix}")
    if out is None:
        tree = torch.empty(tree_storage(n, radix), dtype=values.dtype, device=values.device)
    else:
        _build.require(out, values.dtype, "out", values.device)
        tree = out
    if n == 0:
        return tree
    count, sizes = _levels(n, radix)
    _build.check(
        _tree_build_entry(values.dtype)(values.data_ptr(), tree.data_ptr(),
                                        ctypes.addressof(sizes), count, radix,
                                        _build.stream_of(values)),
        "tree_build",
    )
    _build.counted(tree_build, WHOLE_TREE)
    return tree


tree_build.launches = 0
tree_build.designs = {}

#: the design a grid's int32 trees are built by: one launch, a row a tree
WHOLE_TREES = "whole trees of a grid, one launch"


@functools.lru_cache(maxsize=None)
def _tree_build_rows_entry():
    fn = _build.library("segsum").repro_tree_build_i32_rows
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, p, ll, i, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def tree_build_rows_(leaves: torch.Tensor, radix: int, out: torch.Tensor) -> torch.Tensor:
    """R int32 trees of one shape, in place: ``out[r]`` becomes the tree of
    ``leaves[r]`` (R, n), as :func:`tree_build` builds one.  On the card one
    launch builds them all (counted as a ``tree_build`` launch, design
    :data:`WHOLE_TREES`); each row is bit for bit its own build (integer
    sums).  ``leaves`` and ``out`` are (R, ·) with rows of unit stride,
    ``out``'s rows a multiple of 4 ints apart (16-byte stores)."""
    radix_shift(radix)
    rows, n = leaves.shape
    if leaves.dtype != torch.int32 or out.dtype != torch.int32 or \
            out.shape != (rows, tree_storage(n, radix)):
        raise ValueError(f"int32 leaves (R, n) and out (R, {tree_storage(n, radix)}) expected, "
                         f"got {leaves.dtype} {tuple(leaves.shape)} and {out.dtype} "
                         f"{tuple(out.shape)}")
    if leaves.device.type == "cpu":
        for r in range(rows):
            out[r].copy_(tree_build_ref(leaves[r], radix))
        return out
    if leaves.device != out.device or leaves.stride(1) != 1 or out.stride(1) != 1 or \
            out.stride(0) % 4 != 0 or out.data_ptr() % 16 != 0 or radix > TILE_LEAVES:
        raise ValueError("the card builds rows of unit stride into 16-byte aligned tree rows "
                         f"a multiple of 4 ints apart, at radix <= {TILE_LEAVES}")
    if rows == 0 or n == 0:
        return out
    count, sizes = _levels(n, radix)
    _build.check(
        _tree_build_rows_entry()(leaves.data_ptr(), leaves.stride(0), out.data_ptr(),
                                 out.stride(0), rows, ctypes.addressof(sizes), count, radix,
                                 _build.stream_of(leaves)),
        "tree_build_rows_",
    )
    _build.counted(tree_build, WHOLE_TREES)
    return out


def tree_update_(tree: torch.Tensor, n: int, radix: int, idx: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """Batched point update, in place: add ``delta[q]`` along the ancestor
    path of leaf ``idx[q]`` (``idx`` < n); entries with ``idx < 0`` add
    nothing.

    Each node's deltas are summed in float64 in input order and the node is
    rounded once, so the result does not depend on the device: the card and
    the CPU agree bit for bit, where float32 adds of the same deltas in the
    two devices' orders drift apart chunk by chunk.  (The reference adds
    them one by one in float32; integer-valued trees come out the same.)
    An int32 tree adds its int32 deltas, exact in any order.  On the card
    one launch updates the touched nodes and writes no other.
    """
    radix_shift(radix)
    if tree.device.type == "cpu":
        return tree_update_ref(tree, n, radix, idx, delta)
    if tree.numel() != tree_storage(n, radix):
        raise ValueError(f"{n} leaves at radix {radix} make {tree_storage(n, radix)} nodes, "
                         f"got {tree.numel()}")
    _launch_update(tree, n, radix, None, idx, delta, 1, tree.numel())
    return tree


tree_update_.launches = 0
tree_update_.designs = {}


def stacked_tree_update_(trees: torch.Tensor, n: int, radix: int, rows: torch.Tensor,
                         idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Batched point update of K stacked float32 trees of one shape, a
    (K, tree_storage(n, radix)) tensor, in place: add ``delta[q]`` along
    the path of leaf ``idx[q]`` in tree ``rows[q]``; entries with
    ``idx < 0`` add nothing.  Each node's deltas summed in float64 in input
    order and rounded once, as :func:`tree_update_` does; on the card one
    launch updates every tree.  (The reference's ``_stacked_tree_update``
    is one float32 scatter-add.)"""
    radix_shift(radix)
    if trees.dim() != 2 or trees.shape[1] != tree_storage(n, radix):
        raise ValueError(f"trees must be (K, {tree_storage(n, radix)}), got "
                         f"{tuple(trees.shape)}")
    if rows.shape != idx.shape:
        raise ValueError(f"rows and idx must have one shape, got {tuple(rows.shape)} and "
                         f"{tuple(idx.shape)}")
    if trees.device.type == "cpu":
        return stacked_tree_update_ref(trees, n, radix, rows, idx, delta)
    _build.require(rows, idx.dtype, "rows", trees.device)
    _launch_update(trees, n, radix, rows, idx, delta, trees.shape[0], trees.shape[1])
    return trees


def _launch_update(tree, n, radix, rows, idx, delta, n_rows, row_stride):
    """One ``csrc/tree_update.cu`` launch over ``n_rows`` trees (``rows``
    None: one), counted as a ``tree_update_`` launch."""
    dev = tree.device
    if tree.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"the card's tree update takes float32 or int32 trees, got {tree.dtype}")
    _build.require(tree, tree.dtype, "tree")
    _build.require(delta, tree.dtype, "delta", dev)
    _build.require(idx, torch.int64 if idx.dtype == torch.int64 else torch.int32, "idx", dev)
    if idx.shape != delta.shape:
        raise ValueError(f"idx and delta must have one shape, got {tuple(idx.shape)} and "
                         f"{tuple(delta.shape)}")
    if n * n_rows >= 2**31 or idx.numel() > MAX_UPDATE_DELTAS:
        raise ValueError(f"the card updates fewer than 2^31 leaves by at most "
                         f"{MAX_UPDATE_DELTAS} deltas; got {n_rows} trees of {n} leaves and "
                         f"{idx.numel()} deltas")
    if idx.numel() == 0 or n == 0:
        return
    count, sizes = _levels(n, radix)
    work_bytes = update_work_bytes(idx.numel(), n, radix, n_rows)
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev) if work_bytes else None
    _build.check(
        _tree_update_entry()(tree.data_ptr(), int(tree.dtype == torch.int32),
                             ctypes.addressof(sizes), count, radix_shift(radix), idx.data_ptr(),
                             rows.data_ptr() if rows is not None else None, idx.element_size(),
                             n_rows, row_stride, delta.data_ptr(), idx.numel(),
                             work.data_ptr() if work is not None else None,
                             _build.stream_of(tree)),
        "tree_update_",
    )
    _build.counted(tree_update_, UPDATE_DESIGN if work is None else UPDATE_DESIGN_L2)


EXACT_ANY_ORDER, INPUT_ORDER = "exact, any order", "input order"


def update_order(n: int, idx: torch.Tensor, delta: torch.Tensor,
                 rows: Optional[torch.Tensor] = None, n_rows: int = 1) -> str:
    """The order in which the card's update adds a node's deltas, as the
    kernel decides it on the device (``csrc/tree_update.cu``), for the
    whole call: in any order when every float64 partial sum of the deltas
    that add (a leaf in [0, n) and, with ``rows``, a row in [0, n_rows)) is
    exact (finite, and their count times the largest magnitude within 2^53
    of the smallest ulp), else in input order; int32 deltas always in any
    order.  Both give the plain version's bits.  Reads the tensors: for
    tests and measurements, not the replay."""
    if not delta.dtype.is_floating_point:
        return EXACT_ANY_ORDER
    ok = (idx >= 0) & (idx < n)
    if rows is not None:
        ok &= (rows >= 0) & (rows < n_rows)
    bits = delta[ok].float().contiguous().view(torch.int32).cpu().numpy().astype("uint32")
    field = (bits >> 23) & 0xFF
    nonzero = (bits & 0x7FFFFFFF) != 0
    if (field == 255).any():
        return INPUT_ORDER
    if not nonzero.any():
        return EXACT_ANY_ORDER
    lo, hi = int(max(field[nonzero].min(), 1)), int(field[nonzero].max())
    log2_count = (int(ok.sum()) - 1).bit_length() if int(ok.sum()) > 1 else 0
    return EXACT_ANY_ORDER if hi - lo <= 29 - log2_count else INPUT_ORDER


def tree_update(tree: torch.Tensor, n: int, radix: int, idx: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """:func:`tree_update_` into a copy, as the reference's functional form."""
    return tree_update_(tree.clone(), n, radix, idx, delta)


def tree_total(tree: torch.Tensor, n: int, radix: int) -> torch.Tensor:
    off = tree_offsets(n, radix)[-1]
    return tree[off:off + tree_sizes(n, radix)[-1]].sum(dtype=tree.dtype)


def tree_prefix(tree: torch.Tensor, n: int, radix: int, idx: torch.Tensor) -> torch.Tensor:
    """Batched inclusive prefix sums over leaves [0, idx]; idx < 0 -> 0.

    Per level: gather the query ancestor's whole sibling group and mask the
    left part.
    """
    sizes = tree_sizes(n, radix)
    sh = radix_shift(radix)
    lane = _lanes(radix, tree.device)
    ok = idx >= 0
    node = torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int64)
    acc = None
    for l, off in enumerate(tree_offsets(n, radix)):
        grp = (node >> sh) << sh
        gidx = off + torch.clamp(grp[..., None] + lane, max=sizes[l] - 1)
        vals = tree[gidx]
        lim = (node & (radix - 1))[..., None]
        within = lane <= lim if l == 0 else lane < lim
        part = torch.where(within & ok[..., None], vals, torch.zeros_like(vals)).sum(
            dim=-1, dtype=tree.dtype)
        acc = part if acc is None else acc + part
        node = node >> sh
    return acc


def tree_range(tree: torch.Tensor, n: int, radix: int, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Batched sums over leaf ranges [lo, hi] (empty when hi < lo)."""
    return tree_prefix(tree, n, radix, hi) - tree_prefix(tree, n, radix, lo - 1)


def tree_select(tree: torch.Tensor, n: int, radix: int, targets: torch.Tensor) -> torch.Tensor:
    """Batched weighted selection: smallest leaf with inclusive prefix
    strictly above ``targets`` (the Madow descent).  int64 leaf ids."""
    offs = tree_offsets(n, radix)
    sizes = tree_sizes(n, radix)
    sh = radix_shift(radix)
    lane = _lanes(radix, tree.device)
    node = torch.zeros(targets.shape, dtype=torch.int64, device=tree.device)
    rem = targets
    for l in range(len(offs) - 1, -1, -1):
        base = node << sh if l < len(offs) - 1 else node
        child = base[..., None] + lane
        vals = tree[offs[l] + torch.clamp(child, max=sizes[l] - 1)]
        vals = torch.where(child < sizes[l], vals, torch.zeros_like(vals))
        csum = torch.cumsum(vals, dim=-1)
        # first child whose cumulative mass exceeds the remaining target
        take = torch.clamp((csum <= rem[..., None]).sum(dim=-1), max=radix - 1)
        node = base + take
        before = csum.gather(-1, torch.clamp(take - 1, min=0)[..., None])[..., 0]
        rem = rem - torch.where(take > 0, before, torch.zeros_like(before))
    return torch.clamp(node, max=n - 1)


def madow_sample_tree(f: torch.Tensor, u: torch.Tensor, capacity: int,
                      radix: int = 64) -> torch.Tensor:
    """Madow/systematic sample of ``capacity`` items by tree descent: a
    tree build (one launch on the card) and O(C log N) selection.  Returns
    ascending int64 leaf ids (the targets ascend); distinct whenever all
    f <= 1."""
    tree = tree_build(f, radix)
    targets = u + torch.arange(capacity, dtype=f.dtype, device=f.device)
    return tree_select(tree, f.shape[0], radix, targets)


def sortable_f32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> int32 (IEEE-754 total order; +0.0 is
    added first, so -0.0 and +0.0 map alike)."""
    b = (x.to(torch.float32) + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


# ---------------------------------------------------------------------------
# lexicographic (hi, lo) min-trees: the eviction keys of the tree LFU / FTPL
# ---------------------------------------------------------------------------
def _lex_group_min(hi2: torch.Tensor, lo2: torch.Tensor):
    """Per-row lexicographic min over the last axis -> (hi, lo, argmin),
    the first index among equal pairs."""
    mh = hi2.min(dim=-1).values
    lo_m = torch.where(hi2 == mh[..., None], lo2, I32_MAX)
    ml = lo_m.min(dim=-1).values
    arg = torch.argmin((lo_m != ml[..., None]).to(torch.int32), dim=-1)
    return mh, ml, arg


def minpair_build(hi: torch.Tensor, lo: torch.Tensor, radix: int):
    """Flat (tree_hi, tree_lo) int32 min-trees over (hi, lo) key pairs.
    Padding children count as (I32_MAX, I32_MAX)."""
    parts_h, parts_l = [hi], [lo]
    ch, cl = hi, lo
    for size in tree_sizes(hi.shape[0], radix)[1:]:
        pad = size * radix - ch.shape[0]
        ch = torch.nn.functional.pad(ch, (0, pad), value=I32_MAX).reshape(size, radix)
        cl = torch.nn.functional.pad(cl, (0, pad), value=I32_MAX).reshape(size, radix)
        ch, cl, _ = _lex_group_min(ch, cl)
        parts_h.append(ch)
        parts_l.append(cl)
    return torch.cat(parts_h), torch.cat(parts_l)


def _group(tree_hi: torch.Tensor, tree_lo: torch.Tensor, off: int, size: int, base,
           radix: int):
    """The ``radix`` nodes of a level from node ``base`` on, nodes past the
    level's ``size`` read as (I32_MAX, I32_MAX)."""
    lane = _lanes(radix, tree_hi.device)
    child = base + lane
    idx = off + torch.clamp(child, max=size - 1)
    valid = child < size
    return (torch.where(valid, tree_hi[idx], I32_MAX),
            torch.where(valid, tree_lo[idx], I32_MAX))


def minpair_root(tree_hi: torch.Tensor, tree_lo: torch.Tensor, n: int,
                 radix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lexicographic minimum (hi, lo) over all leaves, from the top level."""
    off, size = tree_offsets(n, radix)[-1], tree_sizes(n, radix)[-1]
    mh, ml, _ = _lex_group_min(tree_hi[off:off + size], tree_lo[off:off + size])
    return mh, ml


def minpair_argmin(tree_hi: torch.Tensor, tree_lo: torch.Tensor, n: int,
                   radix: int) -> torch.Tensor:
    """Leaf index of the lexicographic minimum (the first index wins ties:
    group argmins prefer the lowest child at every level).  int64."""
    offs, sizes = tree_offsets(n, radix), tree_sizes(n, radix)
    sh = radix_shift(radix)
    node = torch.zeros((), dtype=torch.int64, device=tree_hi.device)
    for l in range(len(offs) - 1, -1, -1):
        base = node << sh if l < len(offs) - 1 else node
        h, lo = _group(tree_hi, tree_lo, offs[l], sizes[l], base, radix)
        node = base + _lex_group_min(h, lo)[2]
    return node


def minpair_update_plan(tree_hi: torch.Tensor, tree_lo: torch.Tensor, n: int, radix: int,
                        idx: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Plan a point update: the (nodes, hi_vals, lo_vals) that set leaf
    ``idx`` to (hi, lo) and refresh its ancestors' group mins, each computed
    against the current trees with the new child substituted."""
    offs, sizes = tree_offsets(n, radix), tree_sizes(n, radix)
    sh = radix_shift(radix)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=tree_hi.device)
    node, nh, nl = idx, torch.as_tensor(hi, dtype=torch.int32), torch.as_tensor(lo, dtype=torch.int32)
    nodes, vals_h, vals_l = [offs[0] + idx], [nh], [nl]
    for l in range(1, len(offs)):
        grp = node >> sh
        h, lo_ = _group(tree_hi, tree_lo, offs[l - 1], sizes[l - 1], grp << sh, radix)
        at = _lanes(radix, tree_hi.device) == node - (grp << sh)
        nh, nl, _ = _lex_group_min(torch.where(at, nh, h), torch.where(at, nl, lo_))
        node = grp
        nodes.append(offs[l] + node)
        vals_h.append(nh)
        vals_l.append(nl)
    return torch.stack(nodes), torch.stack(vals_h), torch.stack(vals_l)


def minpair_update(tree_hi: torch.Tensor, tree_lo: torch.Tensor, n: int, radix: int,
                   idx, hi, lo):
    """Single point update into copies: set leaf ``idx`` to (hi, lo) and
    recompute its ancestor groups (the eager form of
    :func:`minpair_update_plan`)."""
    sidx, vh, vl = minpair_update_plan(tree_hi, tree_lo, n, radix, idx, hi, lo)
    th, tl = tree_hi.clone(), tree_lo.clone()
    th[sidx] = vh.to(th.dtype)
    tl[sidx] = vl.to(tl.dtype)
    return th, tl
