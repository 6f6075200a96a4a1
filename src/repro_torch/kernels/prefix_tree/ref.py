"""Plain PyTorch versions of the prefix-tree sums and block reductions.

Counterparts of ``repro.kernels.prefix_tree.kernel``'s ``segsum_kernel``
and ``bucket_mass_kernel``, of the reference's ``tree_build`` and
``tree_update`` (``repro.kernels.prefix_tree.ops``), and of ``ogb_tree``'s
whole threshold solve over the buckets (``csrc/bucket_mass.cu``'s
``repro_solve_buckets``).  The wrappers in :mod:`.kernel` and :mod:`.ops`
run these on a CPU tensor; on the card ``chip_smoke.py`` and the ``cuda``
tests hold the CUDA kernels against them.  Each term is rounded as the
kernels round it, so they differ only in summation order: not at all for
integer values or for the tree update (both add a node's deltas in input
order), and for the bucket masses, summed in float64 by both, only where a
float64 sum rounds to float32 on a tie.

:func:`stack_distance_hits_ref` is the tree LRU's oracle: LRU's hits
by the definition, one reuse distance at a time.

The tree geometry lives here too: a tree over ``n`` leaves with branching
factor ``radix`` is one flat tensor, level 0 the leaves and level l+1 the
sums of ``radix`` consecutive nodes of level l, until a level fits in one
group.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

#: bisection halvings of the bracket that one round of the threshold solve
#: resolves (a grid of 2^6 - 1 = 63 interior points)
HALVINGS_PER_ROUND = 6


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


def radix_shift(radix: int) -> int:
    """log2 of ``radix``, which must be a power of two."""
    s = radix.bit_length() - 1
    if s < 0 or 1 << s != radix:
        raise ValueError(f"radix must be a power of two, got {radix}")
    return s


def segment_sums_ref(values: torch.Tensor, out_size: int, radix: int) -> torch.Tensor:
    """(out_size,) sums of each group of ``radix`` consecutive values, the
    last group zero-padded."""
    pad = out_size * radix - values.shape[0]
    padded = torch.nn.functional.pad(values, (0, pad))
    return padded.reshape(out_size, radix).sum(dim=1, dtype=values.dtype)


def tree_build_ref(values: torch.Tensor, radix: int) -> torch.Tensor:
    """The flat tree over the leaf vector ``values``: each level summed
    from the one below, as it is stored (float32 from float32, int32 from
    int32)."""
    radix_shift(radix)
    parts, cur = [values], values
    for size in tree_sizes(values.shape[0], radix)[1:]:
        cur = segment_sums_ref(cur, size, radix)
        parts.append(cur)
    return torch.cat(parts)


def tree_update_ref(tree: torch.Tensor, n: int, radix: int, idx: torch.Tensor,
                    delta: torch.Tensor) -> torch.Tensor:
    """Batched point update, in place: add ``delta[q]`` along the ancestor
    path of leaf ``idx[q]``; entries with ``idx < 0`` add nothing.

    Each node's deltas are summed in float64 in input order (the order in
    which ``index_put_(accumulate=True)`` adds duplicates, on the CPU and,
    after its stable sort, on the card) and the node is rounded once.  An
    integer tree adds its deltas in place, exact in any order."""
    sh = radix_shift(radix)
    ok = idx >= 0
    node = torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int64)
    nodes = []
    for off in tree_offsets(n, radix):
        nodes.append(off + node)
        node = node >> sh
    if not tree.dtype.is_floating_point:
        masked = torch.where(ok, delta, torch.zeros_like(delta)).to(tree.dtype)
        return tree.index_add_(0, torch.cat(nodes), masked.repeat(len(nodes)))
    masked = torch.where(ok, delta, torch.zeros_like(delta)).to(torch.float64)
    acc = torch.zeros(tree.shape, dtype=torch.float64, device=tree.device)
    acc.index_put_((torch.cat(nodes),), masked.repeat(len(nodes)), accumulate=True)
    return tree.copy_(tree.to(torch.float64) + acc)


def stack_distance_hits_ref(trace, capacity: int) -> np.ndarray:
    """Exact LRU hit sequence by reuse (stack) distances: a request hits iff
    the number of distinct items since its previous occurrence is at most
    ``capacity - 1``.  O(T * window), numpy: the oracle of the tree LRU
    (reference: ``repro.kernels.prefix_tree.ref.stack_distance_hits_ref``)."""
    trace = np.asarray(trace)
    last = {}
    hits = np.zeros(len(trace), bool)
    for i, j in enumerate(trace):
        j = int(j)
        if j in last:
            hits[i] = len(set(trace[last[j] + 1: i].tolist())) <= capacity - 1
        last[j] = i
    return hits


def bucket_masses_ref(cnt: torch.Tensor, total: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[k] = sum_b cnt_b * clip(mean_b - taus[k], 0, 1), with
    mean_b = total_b / cnt_b for a non-empty bucket and 0 otherwise; the
    float32 terms are summed in float64 and rounded once, as the kernel does.

    An empty bucket adds an exact 0, so only the non-empty ones are summed
    (a histogram of y is mostly empty)."""
    nonempty = torch.nonzero(cnt).reshape(-1)
    cnt, total = cnt.index_select(0, nonempty), total.index_select(0, nonempty)
    mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1.0), torch.zeros_like(total))
    z = torch.clamp(mean[None, :] - taus[:, None], 0.0, 1.0)
    return (cnt[None, :] * z).sum(dim=1, dtype=torch.float64).to(torch.float32)


def solve_rounds(iters: int) -> List[int]:
    """Halvings of each round of an ``iters``-halving solve: rounds of
    :data:`HALVINGS_PER_ROUND`, and a last round that takes the remainder."""
    rounds = [HALVINGS_PER_ROUND] * (iters // HALVINGS_PER_ROUND)
    if iters % HALVINGS_PER_ROUND:
        rounds.append(iters % HALVINGS_PER_ROUND)
    return rounds


@functools.lru_cache(maxsize=None)
def _grid_fractions(halvings: int, device: torch.device) -> torch.Tensor:
    """j / 2^h for the 2^h - 1 interior points j = 1 .. 2^h - 1 (exact)."""
    m = 1 << halvings
    return torch.arange(1, m, dtype=torch.float32, device=device) / m


def solve_buckets_ref(cnt: torch.Tensor, total: torch.Tensor, cap: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor, iters: int) -> torch.Tensor:
    """The largest threshold in [lo, hi], to ``iters`` halvings, whose bucket
    mass is at least ``cap``: the reference's bisection, taken a round of
    :func:`solve_rounds` at a time.  A round of h halvings evaluates the mass
    at the 2^h - 1 interior points lo + (hi - lo) * (j / 2^h) and keeps the
    last point whose mass is at least C (or lo) and the point after it (or
    hi); in exact arithmetic that is the bracket h bisection steps reach.
    Requires mass(lo) >= cap; returns lo's counterpart of the final bracket,
    as the reference does.  The scalars are 0-d float32 tensors on cnt's
    device."""
    for h in solve_rounds(iters):
        taus = lo + (hi - lo) * _grid_fractions(h, lo.device)
        mass = bucket_masses_ref(cnt, total, taus)
        # mass is non-increasing in tau: the points with mass >= C come first
        c = (mass >= cap).sum().reshape(1)
        grid = torch.cat([lo.reshape(1), taus, hi.reshape(1)])
        lo, hi = grid.index_select(0, torch.cat([c, c + 1])).unbind()
    return lo
