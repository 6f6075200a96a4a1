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
    which ``index_put_(accumulate=True)`` adds duplicates on the CPU) and
    the node is rounded once.  On the card PyTorch's accumulate sums a long
    run of one index across a warp, so there this plain version gives the
    CPU's bits only where the order of the adds does not show (the card's
    kernel keeps input order: ``csrc/tree_update.cu``).  An integer tree
    adds its deltas in place, exact in any order."""
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


def stacked_tree_update_ref(trees: torch.Tensor, n: int, radix: int, rows: torch.Tensor,
                            idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """K stacked float32 trees of one shape, (K, TOT), updated in place:
    ``delta[q]`` along the path of leaf ``idx[q]`` in tree ``rows[q]``
    (entries with ``idx < 0`` or a row out of range add nothing), each
    node's deltas summed in float64 in input order and rounded once, as
    :func:`tree_update_ref` sums one tree's."""
    sh = radix_shift(radix)
    kk, tot = trees.shape
    ok = (idx >= 0) & (idx < n) & (rows >= 0) & (rows < kk)
    node = torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int64)
    base = torch.where(ok, rows, torch.zeros_like(rows)).to(torch.int64) * tot
    nodes = []
    for off in tree_offsets(n, radix):
        nodes.append(base + off + node)
        node = node >> sh
    masked = torch.where(ok, delta, torch.zeros_like(delta)).to(torch.float64)
    flat = trees.view(-1)
    acc = torch.zeros(flat.shape, dtype=torch.float64, device=trees.device)
    acc.index_put_((torch.cat(nodes),), masked.repeat(len(nodes)), accumulate=True)
    flat.copy_(flat.to(torch.float64) + acc)
    return trees


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


#: leaves a group of the sized solve (the count trees' radix), and the
#: warps of its block, which take the groups in turn
SIZED_GROUP, SIZED_WARPS = 64, 32


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """A warp's xor-butterfly sum over the last axis (32 lanes), as every
    lane ends it: lane 0's value."""
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def sized_groups(cnt: torch.Tensor) -> torch.Tensor:
    """The (class, group) pairs of the sized solve, in order: the groups of
    SIZED_GROUP leaves of each class's (V,) counts that hold an item, as
    int64 (G, 2)."""
    kk, v = cnt.shape
    busy = (cnt.reshape(kk, v // SIZED_GROUP, SIZED_GROUP) != 0).any(dim=2)
    return torch.nonzero(busy)


def _sized_prep(cnt: torch.Tensor, total: torch.Tensor):
    """The busy groups' counts and means, and the block plan's order of
    them: warp w's groups of class k, in order, (K, 32, R), -1 past the end."""
    kk, v = cnt.shape
    groups = sized_groups(cnt)
    k_of, g_of = groups[:, 0], groups[:, 1]
    leaf = (g_of[:, None] * SIZED_GROUP + torch.arange(SIZED_GROUP, device=cnt.device))
    c = cnt[k_of[:, None], leaf]
    tot = total[k_of[:, None], leaf]
    mean = torch.where(c > 0, tot / torch.clamp(c, min=1.0), torch.zeros_like(tot))
    g_idx = torch.arange(groups.shape[0], device=cnt.device)
    warp = g_idx % SIZED_WARPS
    rounds = 1
    slots = {}
    for g, (k, w) in enumerate(zip(k_of.tolist(), warp.tolist())):
        slots.setdefault((k, w), []).append(g)
        rounds = max(rounds, len(slots[k, w]))
    order = torch.full((kk, SIZED_WARPS, rounds), -1, dtype=torch.int64)
    for (k, w), gs in slots.items():
        order[k, w, :len(gs)] = torch.tensor(gs)
    order = order.to(cnt.device)
    return kk, k_of, c, mean, order


def _sized_sums(prep, s: torch.Tensor, t: torch.Tensor):
    """Each class's mass and interior count at base multiplier t, float64
    (K,) each, summed in the card's order."""
    kk, k_of, c, mean, order = prep
    valid = order >= 0
    pick = torch.clamp(order, min=0)
    tk = (s * t)[k_of]
    z = torch.clamp(mean - tk[:, None], 0.0, 1.0)
    term = (c * z).to(torch.float64)
    inner = torch.where((z > 0.0) & (z < 1.0), c, torch.zeros_like(c)).to(torch.float64)
    sums = []
    for x in (term, inner):
        per_group = _butterfly(x[:, :32] + x[:, 32:])
        acc = torch.zeros((kk, SIZED_WARPS), dtype=torch.float64, device=c.device)
        for r in range(order.shape[2]):
            acc = acc + torch.where(valid[..., r], per_group[pick[..., r]], torch.zeros_like(acc))
        sums.append(_butterfly(acc))
    return sums[0], sums[1]


def sized_class_sums(cnt: torch.Tensor, total: torch.Tensor, s: torch.Tensor,
                     t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`solve_sized_ref`'s float64 sums at one base multiplier ``t``:
    each class's mass m_k and interior count i_k, (K,) each, in the order
    the card adds them."""
    return _sized_sums(_sized_prep(cnt, total), s, t)


def solve_sized_ref(cnt: torch.Tensor, total: torch.Tensor, s: torch.Tensor, cap: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, iters: int) -> torch.Tensor:
    """The sized OGB's threshold solve over K classes' (V,) bucket counts and
    sums (``cnt``, ``total``: (K, V) float32, V a multiple of 64): ``iters``
    safeguarded Newton steps on the base multiplier rho from ``lo``, in the
    bracket [lo, hi], as the reference's ``make_sized_ogb_tree_chunk``
    takes them; returns the last iterate, a 0-d float32 tensor.

    Class k's mass at rho is its buckets' mean-clip mass at t_k = s_k * rho,
    sum_b cnt_b * clip(mean_b - t_k, 0, 1), and its interior count the
    buckets' counts whose clip lies strictly inside (0, 1): in exact
    arithmetic the reference's (its buckets above t_k + 1 whole, the ones
    between linear, the two boundary buckets mean-clipped).  The mass is
    sum_k s_k m_k and the slope sum_k s_k^2 i_k; a Newton point strictly
    inside the bracket is taken, else the midpoint.

    The sums are the card's (``csrc/bucket_mass.cu``'s
    ``repro_solve_sized``), order for order: float32 terms in float64, a
    group of 64 buckets as a warp sums it (lane l: buckets l and l + 32,
    then an xor butterfly), the groups of a class in turn by 32 warps (warp
    w the groups g = w mod 32, in order) and the warps' sums by a butterfly;
    then the classes in order, rounded once to float32."""
    prep = _sized_prep(cnt, total)
    kk = prep[0]
    s64 = s.to(torch.float64)
    ss64 = (s * s).to(torch.float64)
    t = lo
    for _ in range(iters):
        m_k, i_k = _sized_sums(prep, s, t)
        mass = torch.zeros((), dtype=torch.float64, device=cnt.device)
        slope = torch.zeros((), dtype=torch.float64, device=cnt.device)
        for k in range(kk):
            mass = mass + s64[k] * m_k[k]
            slope = slope + ss64[k] * i_k[k]
        mass, slope = mass.to(torch.float32), slope.to(torch.float32)
        too_much = mass >= cap
        lo = torch.where(too_much, t, lo)
        hi = torch.where(too_much, hi, t)
        t_newton = t + (mass - cap) / torch.clamp(slope, min=1e-12)
        t_mid = 0.5 * (lo + hi)
        ok = (slope > 0.0) & (t_newton > lo) & (t_newton < hi)
        t = torch.where(ok, t_newton, t_mid)
    return t
