"""Packed radix prefix trees on the device.

Counterpart of ``repro.kernels.prefix_tree.ops`` (the float trees; the
integer min-pair trees of the tree automata are not ported yet).  A tree
over ``n`` leaves with branching factor ``radix`` (a power of two) is ONE
flat tensor: level 0 is the leaves, level l+1 holds the per-group sums of
level l, until a level fits in a single radix group.

The tree's two sums are hand-written kernels on the card.
:func:`tree_build` writes the whole tree in one launch (``csrc/segsum.cu``,
each level summed from the float32 level below as
:func:`.kernel.block_segment_sums` sums one).  :func:`tree_update_` sums
each touched node's deltas in float64, in input order, and rounds the node
once (``csrc/tree_update.cu``), so a float tree comes out the same on
every run and on either device.  On a CPU tensor both run their plain
versions in :mod:`.ref`.  The prefix reads and the weighted selection are
plain tensor code, as the reference computes them outside Pallas.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_tree.ref import (
    radix_shift,
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


@functools.lru_cache(maxsize=None)
def _tree_build_entry():
    fn = _build.library("segsum").repro_tree_build
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tree_update_entry():
    fn = _build.library("tree_update").repro_tree_update
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, ctypes.c_longlong, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _levels(n: int, radix: int):
    """The level sizes of a tree over ``n`` leaves, as the C entry points
    take them: (count, a C array of int64)."""
    sizes = tree_sizes(n, radix)
    return len(sizes), (ctypes.c_longlong * len(sizes))(*sizes)


@functools.lru_cache(maxsize=None)
def first_scratch(device: torch.device, nodes: int) -> torch.Tensor:
    """The card's update scratch for a tree of ``nodes`` nodes on
    ``device``: one int32 a node (``first`` in ``csrc/tree_update.cu``),
    INT_MAX between calls, as every call leaves it."""
    return torch.full((nodes,), 2**31 - 1, dtype=torch.int32, device=device)


def _lanes(radix: int, device: torch.device) -> torch.Tensor:
    return torch.arange(radix, dtype=torch.int64, device=device)


def tree_build(values: torch.Tensor, radix: int) -> torch.Tensor:
    """Flat packed float32 tree from a leaf vector; on the card one launch
    writes the whole tree, leaves included."""
    radix_shift(radix)
    if values.device.type == "cpu":
        return tree_build_ref(values, radix)
    _build.require(values, torch.float32, "values")
    if values.dim() != 1 or radix > TILE_LEAVES:
        raise ValueError(f"the card builds a tree over 1-D leaves at radix <= {TILE_LEAVES}, "
                         f"got shape {tuple(values.shape)} at radix {radix}")
    n = values.shape[0]
    tree = torch.empty(tree_storage(n, radix), dtype=torch.float32, device=values.device)
    if n == 0:
        return tree
    count, sizes = _levels(n, radix)
    _build.check(
        _tree_build_entry()(values.data_ptr(), tree.data_ptr(), ctypes.addressof(sizes), count,
                            radix, _build.stream_of(values)),
        "tree_build",
    )
    _build.counted(tree_build, WHOLE_TREE)
    return tree


tree_build.launches = 0
tree_build.designs = {}


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
    On the card one launch updates the touched nodes and writes no other.
    """
    sh = radix_shift(radix)
    if tree.device.type == "cpu":
        return tree_update_ref(tree, n, radix, idx, delta)
    dev = tree.device
    _build.require(tree, torch.float32, "tree")
    _build.require(delta, torch.float32, "delta", dev)
    _build.require(idx, torch.int64 if idx.dtype == torch.int64 else torch.int32, "idx", dev)
    if idx.shape != delta.shape:
        raise ValueError(f"idx and delta must have one shape, got {tuple(idx.shape)} and "
                         f"{tuple(delta.shape)}")
    if tree.numel() != tree_storage(n, radix) or max(n, idx.numel()) >= 2**31:
        raise ValueError(f"the card updates a tree over fewer than 2^31 leaves by fewer than "
                         f"2^31 deltas; {n} leaves at radix {radix} make "
                         f"{tree_storage(n, radix)} nodes, got {tree.numel()} and "
                         f"{idx.numel()} deltas")
    if idx.numel() == 0 or n == 0:
        return tree
    count, sizes = _levels(n, radix)
    first = first_scratch(dev, tree.numel())
    _build.check(
        _tree_update_entry()(tree.data_ptr(), ctypes.addressof(sizes), count, sh, idx.data_ptr(),
                             idx.element_size(), delta.data_ptr(), idx.numel(), first.data_ptr(),
                             _build.stream_of(tree)),
        "tree_update_",
    )
    tree_update_.launches += 1
    return tree


tree_update_.launches = 0

EXACT_ANY_ORDER, INPUT_ORDER = "exact, any order", "input order"


def update_order(n: int, idx: torch.Tensor, delta: torch.Tensor) -> str:
    """The order in which the card's update adds a node's deltas, as the
    kernel decides it on the device (``csrc/tree_update.cu``): in any order
    when every float64 partial sum of the deltas that add is exact (finite,
    and their count times the largest magnitude within 2^53 of the smallest
    ulp), else in input order.  Both give the plain version's bits.  Reads
    the tensors: for tests and measurements, not the replay."""
    ok = (idx >= 0) & (idx < n)
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
    return tree[off:off + tree_sizes(n, radix)[-1]].sum()


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
        part = torch.where(within & ok[..., None], vals, torch.zeros_like(vals)).sum(dim=-1)
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
