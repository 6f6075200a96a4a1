"""Packed radix prefix trees on the device.

Counterpart of ``repro.kernels.prefix_tree.ops`` (the float trees; the
integer min-pair trees of the tree automata are not ported yet).  A tree
over ``n`` leaves with branching factor ``radix`` (a power of two) is ONE
flat tensor: level 0 is the leaves, level l+1 holds the per-group sums of
level l, until a level fits in a single radix group.

Every build level goes through :func:`.kernel.block_segment_sums` (the
``segsum`` kernel on the card).  The batched point updates, prefix reads
and the weighted selection are plain tensor code, as the reference computes
them outside Pallas.  A point update sums its deltas per node in float64
(``index_put_(accumulate=True)``, which adds duplicates in a fixed order on
the card) and rounds each node once, so a float tree comes out the same on
every run and on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.prefix_tree.kernel import block_segment_sums


def tree_sizes(n: int, radix: int) -> Tuple[int, ...]:
    sizes = [int(n)]
    while sizes[-1] > radix:
        sizes.append(-(-sizes[-1] // radix))
    return tuple(sizes)


def tree_offsets(n: int, radix: int) -> Tuple[int, ...]:
    offs, off = [], 0
    for s in tree_sizes(n, radix):
        offs.append(off)
        off += s
    return tuple(offs)


def tree_storage(n: int, radix: int) -> int:
    return sum(tree_sizes(n, radix))


def _shift(radix: int) -> int:
    s = radix.bit_length() - 1
    if 1 << s != radix:
        raise ValueError(f"radix must be a power of two, got {radix}")
    return s


def _lanes(radix: int, device: torch.device) -> torch.Tensor:
    return torch.arange(radix, dtype=torch.int64, device=device)


def tree_build(values: torch.Tensor, radix: int) -> torch.Tensor:
    """Flat packed float32 tree from a leaf vector, one segsum per level."""
    _shift(radix)
    parts, cur = [values], values
    for size in tree_sizes(values.shape[0], radix)[1:]:
        cur = block_segment_sums(cur, size, radix)
        parts.append(cur)
    return torch.cat(parts)


def tree_update_(tree: torch.Tensor, n: int, radix: int, idx: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """Batched point update, in place: add ``delta[q]`` along the ancestor
    path of leaf ``idx[q]``; entries with ``idx < 0`` add nothing.

    The deltas of one call are summed per node in float64 and each node is
    rounded once, so the result does not depend on the order of the adds:
    the card and the CPU agree, where float32 adds of the same deltas in
    the two devices' orders drift apart chunk by chunk.  (The reference adds
    them one by one in float32; integer-valued trees come out the same.)
    """
    sh = _shift(radix)
    ok = idx >= 0
    node = torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int64)
    masked = torch.where(ok, delta, torch.zeros_like(delta)).to(torch.float64)
    nodes = []
    for off in tree_offsets(n, radix):
        nodes.append(off + node)
        node = node >> sh
    acc = torch.zeros(tree.shape, dtype=torch.float64, device=tree.device)
    acc.index_put_((torch.cat(nodes),), masked.repeat(len(nodes)), accumulate=True)
    return tree.copy_(tree.to(torch.float64) + acc)


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
    sh = _shift(radix)
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
    sh = _shift(radix)
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
    tree build (one segsum per level) and O(C log N) selection.  Returns
    ascending int64 leaf ids (the targets ascend); distinct whenever all
    f <= 1."""
    tree = tree_build(f, radix)
    targets = u + torch.arange(capacity, dtype=f.dtype, device=f.device)
    return tree_select(tree, f.shape[0], radix, targets)
