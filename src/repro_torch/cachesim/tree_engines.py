"""Tree-backed engines: lazy bucketized OGB and the O(log) tree automata.

Counterpart of ``repro.cachesim.tree_engines``, in two parts.

**The tree automata** (``TREE_ENGINE_KINDS``: lru, lfu, ftpl), the
reference's default engines for those kinds, whose hit sequences are the
dense slot automata's bit for bit:

* **tree LRU** -- reuse distance over a ring of request positions with a
  radix-16 int32 count tree (:class:`TreeLRUCarry`); a chunk is one
  ``tree_lru`` launch on the card (:mod:`repro_torch.kernels.tree_lru`).
  A ring compaction, due when ``pos + window > m``, is decided on the card:
  the host keeps bounds on ``pos`` (:class:`LRUHost`) and, where one could
  be due, adds a compaction launch and an int32 tree build, which leave the
  carry as it was where it is not.  No chunk reads the device.
* **tree LFU / FTPL** -- per-request automata on a radix-64 lexicographic
  (hi, lo) min-tree over slots (:class:`TreeLFUCarry`,
  :class:`TreeFTPLCarry`); a chunk is one ``minpair_automaton`` launch
  (:mod:`repro_torch.kernels.minpair_automaton`).

The carries have the reference's leaves, dtypes and meanings (-1 out, -2
inactive, index N of ``last``/``imap`` scratch), so ``carry_from_numpy``
carries state across.  Each step updates its carry in place;
:func:`start_tree_run` gives ``api.run`` a private copy.  GDS, the sized
automata and FIFO past the slot kernel's size are not ported yet
(ROADMAP.md §1 item 5).

**Lazy bucketized OGB** (``OGB_TREE_*``, ``OGBTreeCarry``, ``_ogb_bucket``,
``init_ogb_tree_carry`` and ``make_ogb_tree_chunk``): per-chunk work that
does not grow with the catalog.  The state is the unprojected accumulation
``y`` with ``f = clip(y - rho, 0, 1)`` implicit; a V-bucket histogram of y
(count and sum trees) replaces the catalog in the per-chunk projection.

Two things differ from the reference, and neither changes what it computes:

* **Threshold solve.**  The reference bisects ``iters`` times, each step a
  few tree-prefix reads.  Here the solve goes in rounds of six halvings,
  each evaluating the bucket mass over the leaf level of the count and sum
  trees at the 63 interior points of a 64-way grid over the bracket and
  keeping the last point whose mass is at least C and the point after it.
  In exact arithmetic that is the bracket six bisection steps reach.  The
  whole solve is ONE
  :func:`~repro_torch.kernels.prefix_tree.kernel.solve_buckets` launch: the
  rounds, their reductions and the grid choice run on the device, with no
  read on the host.
* **Re-anchor without a read per chunk.**  The reference decides each chunk
  with ``lax.cond``.  Since ``rho_new <= rho + max(eta*B, 4w)``, the host
  carries a float64 upper bound on rho (:class:`TreeHost`) and reads the
  device's trigger and rho only when that bound could meet the trigger.
  It then re-anchors exactly when the reference would.

Every sum of a chunk adds in a fixed order, so two runs on the card agree
bit for bit, and with the CPU: a tree update sums each node's deltas in
float64 in input order and rounds once (the ``tree_update`` kernel on the
card), and the count of a chunk's requests by id goes through the
histogram kernel, as a re-anchor's leaf counts do.  The re-anchor's leaf
sums accumulate in float64 (:func:`_leaf_sums`, PyTorch's
``index_put_(accumulate=True)``, which adds duplicates in a fixed order).
The step updates the carry's tensors in place; :func:`start_run` gives
:func:`repro_torch.cachesim.api.run` a private copy to update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim.replay import sampling_keys
from repro_torch.core.ftpl import ftpl_initial_top_c, ftpl_noise, theoretical_zeta
from repro_torch.jaxcache.fractional import request_counts
from repro_torch.kernels.minpair_automaton.ops import minpair_automaton
from repro_torch.kernels.prefix_tree.kernel import solve_buckets
from repro_torch.kernels.prefix_tree.ops import (
    I32_MAX,
    leaves_for_storage,
    minpair_build,
    sortable_f32,
    tree_build,
    tree_prefix,
    tree_storage,
    tree_total,
    tree_update_,
)
from repro_torch.kernels.tree_lru.ops import tree_lru
from repro_torch.kernels.tree_lru.ref import check_window, max_window

#: bucket count of the value histogram the lazy projection solves over
OGB_TREE_BUCKETS = 65536
#: radix of the bucket count/sum trees
OGB_TREE_RADIX = 64
#: bisection halvings of the per-chunk threshold solve
OGB_TREE_ITERS = 30
#: grid headroom factor: the value grid spans ~2*GAIN chunk-updates of rho
#: growth before a re-anchor pass is needed
OGB_TREE_GAIN = 8.0

_I32_MAX = 2**31 - 1
#: relative slack of the host's float64 bound over float32 rounding on the
#: device (a few float32 ulps, 2**-23 each, per chunk)
_SLACK = 1e-6


class TreeHost(NamedTuple):
    """What the host knows of an :class:`OGBTreeCarry` without reading it.

    ``rho_hi`` is an upper bound on the carry's rho; ``eta`` and ``w`` are
    the carry's float32 eta and bucket width as Python floats.  ``syncs``
    and ``reanchors`` count, since the run started, the steps that read the
    device and the re-anchor passes."""

    rho_hi: float
    eta: float
    w: float
    syncs: int = 0
    reanchors: int = 0


class OGBTreeCarry(NamedTuple):
    """Lazy OGB state: absolute accumulated values + cumulative threshold.

    The ten tensor leaves are the reference's; ``host`` is the host-side
    bound the re-anchor check reads instead of the device (None until
    :func:`start_run` or the first step sets it)."""

    y: torch.Tensor  # (N,) float32 accumulated values (f = clip(y - rho, 0, 1))
    rho: torch.Tensor  # () float32 cumulative projection threshold
    eta: torch.Tensor  # () float32
    cap: torch.Tensor  # () float32
    p: torch.Tensor  # (N,) float32 permanent random numbers, or (0,)
    w: torch.Tensor  # () float32 bucket width of the value grid
    scratch: torch.Tensor  # (N,) int32 first-occurrence dedup scratch (I32_MAX)
    ycnt: torch.Tensor  # (TOT,) float32 bucket-count tree over y
    ysum: torch.Tensor  # (TOT,) float32 bucket-sum tree over y
    dcnt: torch.Tensor  # (TOT,) float32 bucket-count tree over y - p, or (0,)
    host: Optional[TreeHost] = None

    @property
    def device(self) -> torch.device:
        return self.y.device

    @property
    def catalog_size(self) -> int:
        return self.y.shape[0]

    def tensors(self) -> tuple:
        """The tensor leaves, without the host-side bound."""
        return tuple(self)[:-1]


def _ogb_bucket(x: torch.Tensor, wv: torch.Tensor, v: int) -> torch.Tensor:
    """Grid bucket of value ``x``: the grid covers [-1, v*w - 1) so both y
    (>= 0) and y - p (> -1) share it.  int64."""
    return torch.clamp(torch.floor((x + 1.0) / wv).to(torch.int64), 0, v - 1)


def _read_host(carry: OGBTreeCarry) -> TreeHost:
    """The host's view of ``carry``, from one read of the device."""
    rho, eta, w = torch.stack([carry.rho, carry.eta, carry.w]).tolist()
    return TreeHost(rho_hi=rho, eta=eta, w=w)


def start_run(carry: OGBTreeCarry) -> OGBTreeCarry:
    """A private copy of ``carry`` for a run to update in place, with the
    host's bound read afresh (one read of the device)."""
    fresh = OGBTreeCarry(*(t.clone() for t in carry.tensors()))
    return fresh._replace(host=_read_host(fresh))


def init_ogb_tree_carry(
    catalog_size: int,
    capacity: int,
    *,
    eta: float,
    seed: int = 0,
    sample: str = "poisson",
    buckets: int = OGB_TREE_BUCKETS,
    radix: int = OGB_TREE_RADIX,
    batch_hint: int = 4096,
    device: DeviceLike = None,
) -> OGBTreeCarry:
    """Initial carry at the uniform feasible state f = C/N.

    ``batch_hint`` sizes the value grid: headroom for ~2*OGB_TREE_GAIN
    chunks of worst-case rho growth (eta*B per chunk) between re-anchor
    passes.  The leaves are built on the host, as the reference builds
    them; the three trees are built on the device (one launch each)."""
    dev = resolve_device(device)
    n, v = int(catalog_size), int(buckets)
    span = 1.0 + 2.0 * OGB_TREE_GAIN * max(1.0, float(eta) * batch_hint)
    wv = (span + 1.0) / v
    y0 = float(capacity) / n
    p, _u_key = sampling_keys(seed, n, sample, dev)
    b0 = int(np.clip(np.floor((y0 + 1.0) / wv), 0, v - 1))
    cnt_leaf = np.zeros(v, np.float32)
    cnt_leaf[b0] = n
    sum_leaf = np.zeros(v, np.float32)
    sum_leaf[b0] = n * y0

    def build(leaf):
        return tree_build(torch.from_numpy(leaf).to(dev), radix)

    if sample == "poisson":
        d0 = y0 - p.cpu().numpy().astype(np.float64)
        db = np.clip(np.floor((d0 + 1.0) / wv), 0, v - 1).astype(np.int64)
        dcnt = build(np.bincount(db, minlength=v).astype(np.float32))
    else:
        dcnt = torch.zeros((0,), dtype=torch.float32, device=dev)
    w32 = float(np.float32(wv))
    return OGBTreeCarry(
        y=torch.full((n,), y0, dtype=torch.float32, device=dev),
        rho=torch.zeros((), dtype=torch.float32, device=dev),
        eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
        cap=torch.tensor(float(capacity), dtype=torch.float32, device=dev),
        p=p,
        w=torch.tensor(w32, dtype=torch.float32, device=dev),
        scratch=torch.full((n,), _I32_MAX, dtype=torch.int32, device=dev),
        ycnt=build(cnt_leaf),
        ysum=build(sum_leaf),
        dcnt=dcnt,
        host=TreeHost(rho_hi=0.0, eta=float(np.float32(eta)), w=w32),
    )


def _leaf_sums(idx: torch.Tensor, vals: torch.Tensor, v: int) -> torch.Tensor:
    """(v,) float32 sums of ``vals`` by bucket ``idx``, accumulated in float64.

    A re-anchor puts most of the catalog into one bucket (every item at
    y = 0 and the small y around it).  Summed in float32, in the
    reference's order or any other, that bucket's sum carries rounding
    noise of the size of a chunk's threshold step, and the card and the
    CPU step differently; in float64 both round the same sum to float32.
    A zero adds nothing, so each goes to a slot of its own past the v
    buckets: the card's accumulate walks a bucket's entries one by one, and
    the items clipped to 0 would make one run of nearly N.
    """
    n = vals.shape[0]
    spare = torch.arange(v, v + n, dtype=idx.dtype, device=idx.device)
    slot = torch.where(vals != 0, idx, spare)
    out = torch.zeros(v + n, dtype=torch.float64, device=vals.device)
    out.index_put_((slot,), vals.to(torch.float64), accumulate=True)
    return out[:v].to(torch.float32)


@functools.lru_cache(maxsize=None)
def make_ogb_tree_chunk(v: int, radix: int, sample: str, iters: int = OGB_TREE_ITERS):
    """Per-chunk lazy OGB step ``(carry, ids) -> (carry, (reward, hits,
    dtau, occ))``, updating the carry's tensors in place.

    Exactness notes (vs the dense chained projection), as the reference's:
    the gradient step, hit accounting and reward are exact; the threshold
    solve uses the bucket mean-clip mass, exact except for the buckets
    straddling rho and rho + 1; the upper clip y <- min(y, 1 + rho) reaches
    an item only when it is touched.
    """
    poisson = sample == "poisson"

    def reanchor(carry, rho_new):
        y = torch.clamp(carry.y - rho_new, 0.0, 1.0)
        wv = carry.w
        by = _ogb_bucket(y, wv, v)
        # counts are integers: the histogram kernel's atomic adds are exact
        ycnt = tree_build(request_counts(by.to(torch.int32), v), radix)
        ysum = tree_build(_leaf_sums(by, y, v), radix)
        dcnt = carry.dcnt
        if poisson:
            by_d = _ogb_bucket(y - carry.p, wv, v).to(torch.int32)
            dcnt = tree_build(request_counts(by_d, v), radix)
        return carry._replace(y=y, rho=torch.zeros_like(rho_new), ycnt=ycnt, ysum=ysum,
                              dcnt=dcnt)

    def chunk(carry: OGBTreeCarry, ids: torch.Tensor):
        b = ids.shape[0]
        host = carry.host if carry.host is not None else _read_host(carry)
        y, rho, eta, cap = carry.y, carry.rho, carry.eta, carry.cap
        p, wv, scratch = carry.p, carry.w, carry.scratch
        ycnt, ysum, dcnt = carry.ycnt, carry.ysum, carry.dcnt
        ids64 = ids.to(torch.int64)
        lanes = torch.arange(b, dtype=torch.int32, device=y.device)

        # --- metrics at the pre-update state (OCO order), O(B) gathers ---
        yold = y.index_select(0, ids64)
        fi = torch.clamp(yold - rho, 0.0, 1.0)
        reward = fi.sum()
        if poisson:
            pi = p.index_select(0, ids64)
            hits = (fi >= pi).sum(dtype=torch.int32)
            # occupancy #{y - p >= rho} from the d-tree: suffix count above
            # rho's bucket (quantized at the boundary bucket)
            occ = tree_total(dcnt, v, radix) - tree_prefix(
                dcnt, v, radix, _ogb_bucket(rho, wv, v).reshape(1)
            )[0]
        else:
            hits = torch.zeros((), dtype=torch.int32, device=y.device)
            occ = cap

        # --- first occurrence of each id (dedup without sorting) ---
        scratch.scatter_reduce_(0, ids64, lanes, "amin")
        lead = scratch.index_select(0, ids64)  # each request's first lane of its id
        first = lead == lanes
        scratch.index_fill_(0, ids64, _I32_MAX)  # restore

        # --- gradient step: upper-clip touched items, add eta per request ---
        # An id requested k times gets min(y, 1 + rho) + k * eta, formed in
        # float64 and rounded once (the reference adds eta k times in
        # float32, in an order the card's scatter would not keep); every
        # lane of the id writes the same value.  k counts the requests by
        # lead lane: integers <= b, exact in the histogram's float32.
        k = request_counts(lead, b).to(torch.float64)
        ylead = torch.minimum(yold, 1.0 + rho).to(torch.float64) + k * eta.to(torch.float64)
        ynew = ylead.to(torch.float32).index_select(0, lead)
        y.index_put_((ids64,), ynew)

        # --- move touched items between buckets (one per distinct item) ---
        none = torch.full_like(ids64, -1)
        bo = torch.where(first, _ogb_bucket(yold, wv, v), none)
        bn = torch.where(first, _ogb_bucket(ynew, wv, v), none)
        didx = torch.cat([bo, bn])
        ones = torch.ones(b, dtype=torch.float32, device=y.device)
        zero = torch.zeros_like(ones)
        tree_update_(ycnt, v, radix, didx, torch.cat([-ones, ones]))
        tree_update_(ysum, v, radix, didx,
                     torch.cat([torch.where(first, -yold, zero), torch.where(first, ynew, zero)]))
        if poisson:
            do = torch.where(first, _ogb_bucket(yold - pi, wv, v), none)
            dn = torch.where(first, _ogb_bucket(ynew - pi, wv, v), none)
            tree_update_(dcnt, v, radix, torch.cat([do, dn]), torch.cat([-ones, ones]))

        # --- scalar threshold solve over the leaf level ---
        # rho* - rho <= eta*B (chained-projection bound); the 4w floor keeps
        # the bracket wider than the mass quantization when eta*B < w
        hi0 = rho + torch.maximum(eta * float(b), 4.0 * wv)
        rho_new = solve_buckets(ycnt[:v], ysum[:v], cap, rho, hi0, iters)
        out = (reward, hits, rho_new - rho, occ)

        # --- re-anchor when the next chunk could outgrow the value grid ---
        bound = (host.rho_hi + max(host.eta * b, 4.0 * host.w)) * (1.0 + _SLACK) + _SLACK
        limit = host.w * v - 1.0 - host.w
        if (1.0 + bound + host.eta * b) * (1.0 + _SLACK) < limit * (1.0 - _SLACK):
            return carry._replace(rho=rho_new, host=host._replace(rho_hi=bound)), out
        trigger = (1.0 + rho_new + eta * float(b)) >= (wv * float(v) - 1.0) - wv
        fire, rho_now = torch.stack([trigger.to(torch.float32), rho_new]).tolist()
        host = host._replace(syncs=host.syncs + 1)
        if fire:
            carry = reanchor(carry, rho_new)
            return carry._replace(host=host._replace(rho_hi=0.0, reanchors=host.reanchors + 1)), out
        return carry._replace(rho=rho_new, host=host._replace(rho_hi=rho_now)), out

    return chunk


# ---------------------------------------------------------------------------
# the tree automata: LRU by reuse distance, LFU and FTPL on min-pair trees
# ---------------------------------------------------------------------------
#: kinds with a tree-backed implementation (their default, impl="tree")
TREE_ENGINE_KINDS = ("lru", "lfu", "ftpl")
#: radix of the LRU ring's count tree
RING_RADIX = 16
#: radix of the LFU/FTPL slot min-trees
SLOT_RADIX = 64
#: the reference's cap on its sub-chunk width (its (W, W) dominance term);
#: the port's kernel blocks a chunk its own way (256 requests a sub-chunk)
MAX_SUBCHUNK = 128


class LRUHost(NamedTuple):
    """What the host knows of a :class:`TreeLRUCarry` without reading it:
    bounds on ``pos``, the capacity, and the steps that read the device for
    them (0 once a run has started).  ``pos`` is known exactly until the
    first compaction; after one it lies within [0, cap rounded up to 16]
    plus the requests since, and a compaction is launched where the upper
    bound leaves no room for the chunk (certain where the lower bound
    leaves none either)."""

    pos_lo: int
    pos_hi: int
    cap: int
    syncs: int = 0


class TreeLRUCarry(NamedTuple):
    """Reuse-distance LRU state.  The five tensor leaves are the
    reference's; ``host`` is the bound the card's step launches a possible
    compaction by (None until :func:`start_tree_run` or a step sets it)."""

    tree: torch.Tensor  # (TOT,) int32 radix-16 count tree of the marks
    last: torch.Tensor  # (N+1,) int32 item -> ring position of its last request
    pos: torch.Tensor  # () int32 next free ring position
    nseen: torch.Tensor  # () int32 requests that found no mark (occupancy min(, cap))
    cap: torch.Tensor  # () int32 capacity
    host: Optional[LRUHost] = None

    @property
    def device(self) -> torch.device:
        return self.tree.device

    @property
    def catalog_size(self) -> int:
        return self.last.shape[0] - 1

    def tensors(self) -> tuple:
        return tuple(self)[:-1]


class TreeLFUCarry(NamedTuple):
    imap: torch.Tensor  # (N+1,) int32 item -> slot (-1 out; N is scratch)
    counts: torch.Tensor  # (N,) int32 perfect-LFU counters
    slots: torch.Tensor  # (K,) int32 slot -> item (-1 empty, -2 inactive)
    tree_hi: torch.Tensor  # (TOT,) int32 min-tree over slot frequencies
    tree_lo: torch.Tensor  # (TOT,) int32 min-tree over slot ticks
    t: torch.Tensor  # () int32 request clock

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> int:
        return self.counts.shape[0]


class TreeFTPLCarry(NamedTuple):
    imap: torch.Tensor  # (N+1,) int32 item -> slot (-1 out; N is scratch)
    counts: torch.Tensor  # (N,) int32 request counters
    noise: torch.Tensor  # (N,) float32 one-shot perturbation (constant)
    slots: torch.Tensor  # (K,) int32 slot -> item (-2 inactive)
    tree_hi: torch.Tensor  # (TOT,) int32 min-tree over sortable scores
    tree_lo: torch.Tensor  # (TOT,) int32 min-tree over slot item ids

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> int:
        return self.counts.shape[0]


def ring_size(n_slots: int) -> int:
    """Ring length: a power of two with >= 4x slack over the kept marks
    (a compaction keeps at most ``capacity`` of them), at least 65 536."""
    m = 65536
    while m < 4 * int(n_slots):
        m *= 2
    return m


def ring_for_window(n_slots: int, window: int) -> int:
    """The default ring, doubled until a chunk of ``window`` requests fits
    behind a compaction (``window <= 3*ring/4 - 16``)."""
    m = ring_size(n_slots)
    while window > max_window(m):
        m *= 2
    return m


def _pick_subchunk(window: int) -> int:
    """The reference's sub-chunk width: the largest divisor of ``window``
    up to MAX_SUBCHUNK, 16-aligned where one is.  It does not change the
    carry after a chunk; the port's kernel does not use it."""
    best, best_aligned = 1, 1
    for d in range(1, min(window, MAX_SUBCHUNK) + 1):
        if window % d == 0:
            best = d
            if d % RING_RADIX == 0:
                best_aligned = d
    return best_aligned if best_aligned > 1 else best


def init_tree_lru_carry(catalog_size: int, capacity: int, n_slots: Optional[int] = None,
                        ring: Optional[int] = None, device: DeviceLike = None) -> TreeLRUCarry:
    dev = resolve_device(device)
    k = int(n_slots) if n_slots else int(capacity)
    m = int(ring) if ring else ring_size(k)
    if m & (m - 1) or m < 4 * k:
        raise ValueError(f"ring must be a power of two >= 4 * n_slots, got {m} for {k}")

    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    return TreeLRUCarry(
        tree=torch.zeros(tree_storage(m, RING_RADIX), dtype=torch.int32, device=dev),
        last=torch.full((catalog_size + 1,), -1, dtype=torch.int32, device=dev),
        pos=scalar(0),
        nseen=scalar(0),
        cap=scalar(int(capacity)),
        host=LRUHost(pos_lo=0, pos_hi=0, cap=int(capacity)),
    )


def _slot_trees(hi: np.ndarray, lo: np.ndarray, dev: torch.device):
    th, tl = minpair_build(torch.from_numpy(hi), torch.from_numpy(lo), SLOT_RADIX)
    return th.to(dev), tl.to(dev)


def init_tree_lfu_carry(catalog_size: int, capacity: int, n_slots: Optional[int] = None,
                        device: DeviceLike = None) -> TreeLFUCarry:
    dev = resolve_device(device)
    k, c = int(n_slots) if n_slots else int(capacity), int(capacity)
    hi = np.full(k, I32_MAX, np.int32)
    lo = np.full(k, I32_MAX, np.int32)
    hi[:c] = -1  # empty slots: frequency -1 sorts below any real frequency
    lo[:c] = -1
    slots = np.full(k, -2, np.int32)
    slots[:c] = -1
    th, tl = _slot_trees(hi, lo, dev)
    return TreeLFUCarry(
        imap=torch.full((catalog_size + 1,), -1, dtype=torch.int32, device=dev),
        counts=torch.zeros(catalog_size, dtype=torch.int32, device=dev),
        slots=torch.from_numpy(slots).to(dev),
        tree_hi=th,
        tree_lo=tl,
        t=torch.zeros((), dtype=torch.int32, device=dev),
    )


def init_tree_ftpl_carry(catalog_size: int, capacity: int, n_slots: Optional[int] = None, *,
                         seed: int = 0, zeta: Optional[float] = None,
                         horizon: Optional[int] = None,
                         device: DeviceLike = None) -> TreeFTPLCarry:
    dev = resolve_device(device)
    k, c = int(n_slots) if n_slots else int(capacity), int(capacity)
    if zeta is None:
        if horizon is None:
            raise ValueError("ftpl needs zeta or horizon")
        zeta = theoretical_zeta(c, catalog_size, horizon)
    noise = ftpl_noise(catalog_size, zeta, seed=seed)
    top = ftpl_initial_top_c(noise, c).astype(np.int32)
    slots = np.full(k, -2, np.int32)
    slots[:c] = top
    imap = np.full(catalog_size + 1, -1, np.int32)
    imap[top] = np.arange(c, dtype=np.int32)
    hi = np.full(k, I32_MAX, np.int32)
    lo = np.full(k, I32_MAX, np.int32)
    hi[:c] = sortable_f32(torch.from_numpy(noise[top])).numpy()
    lo[:c] = top
    th, tl = _slot_trees(hi, lo, dev)
    return TreeFTPLCarry(
        imap=torch.from_numpy(imap).to(dev),
        counts=torch.zeros(catalog_size, dtype=torch.int32, device=dev),
        noise=torch.from_numpy(noise).to(dev),
        slots=torch.from_numpy(slots).to(dev),
        tree_hi=th,
        tree_lo=tl,
    )


def init_tree_engine_carry(kind: str, catalog_size: int, capacity: int, *,
                           n_slots: Optional[int] = None, seed: int = 0,
                           zeta: Optional[float] = None, horizon: Optional[int] = None,
                           ring: Optional[int] = None, device: DeviceLike = None):
    """The initial carry of tree automaton ``kind`` on ``device`` (the card
    unless "cpu" is asked for); ``n_slots`` > capacity pads with inactive
    slots (LRU: sizes the ring), ``ring`` the LRU ring's positions."""
    if kind == "lru":
        return init_tree_lru_carry(catalog_size, capacity, n_slots, ring, device)
    if kind == "lfu":
        return init_tree_lfu_carry(catalog_size, capacity, n_slots, device)
    if kind == "ftpl":
        return init_tree_ftpl_carry(catalog_size, capacity, n_slots, seed=seed, zeta=zeta,
                                    horizon=horizon, device=device)
    raise ValueError(f"unknown tree engine kind {kind!r} (have {TREE_ENGINE_KINDS})")


def _read_lru_host(carry: TreeLRUCarry, syncs: int = 0) -> LRUHost:
    """The host's view of an LRU carry, from one read of the device."""
    pos, cap = torch.stack([carry.pos, carry.cap]).tolist()
    return LRUHost(pos_lo=int(pos), pos_hi=int(pos), cap=int(cap), syncs=syncs)


def start_tree_run(carry):
    """A private copy of a tree automaton's carry for a run to update in
    place; an LRU carry on the card also gets its host bound read afresh
    (one read of the device, before the first chunk)."""
    if isinstance(carry, TreeLRUCarry):
        fresh = TreeLRUCarry(*(t.clone() for t in carry.tensors()))
        host = _read_lru_host(fresh) if fresh.device.type == "cuda" else None
        return fresh._replace(host=host)
    return type(carry)(*(t.clone() for t in carry))


def _lru_chunk(carry: TreeLRUCarry, ids: torch.Tensor, flags: Optional[torch.Tensor]):
    m = leaves_for_storage(carry.tree.shape[0], RING_RADIX)
    window = ids.numel()
    check_window(window, m)
    args = (carry.tree, carry.last, carry.pos, carry.nseen, carry.cap, ids, m)
    if carry.device.type == "cpu":  # the plain version decides from pos itself
        return carry, tree_lru(*args, flags=flags)
    host = carry.host if carry.host is not None else _read_lru_host(carry, syncs=1)
    lo, hi = lru_bounds(host, window, m)
    out = tree_lru(*args, compact=host.pos_hi + window > m, flags=flags)
    return carry._replace(host=host._replace(pos_lo=lo, pos_hi=hi)), out


def lru_bounds(host: LRUHost, window: int, m: int) -> Tuple[int, int]:
    """The bounds on ``pos`` after a chunk of ``window`` requests.  A
    compaction restarts pos within [0, cap rounded up to 16]; where one
    may or may not be due, pos is either that or unchanged (then at most
    m - window)."""
    kept_hi = (host.cap + RING_RADIX - 1) & ~(RING_RADIX - 1)
    if host.pos_hi + window <= m:  # none due
        lo, hi = host.pos_lo, host.pos_hi
    elif host.pos_lo + window > m:  # one due
        lo, hi = 0, kept_hi
    else:
        lo, hi = 0, max(kept_hi, min(host.pos_hi, m - window))
    return lo + window, hi + window


def tree_chunk(kind: str, carry, ids: torch.Tensor, flags: Optional[torch.Tensor] = None):
    """One chunk of tree automaton ``kind``, the carry updated in place: one
    ``tree_lru`` or ``minpair_automaton`` launch on the card (the LRU's
    possible compaction adds two), the plain version on the CPU.  Returns
    ``(carry, (hits, stats))``, stats the (3,) float32 (reward, aux,
    occupancy); ``flags``, a (window,) bool tensor where given, gets each
    request's hit."""
    if kind == "lru":
        return _lru_chunk(carry, ids, flags)
    if kind == "lfu":
        return carry, minpair_automaton("lfu", carry.imap, carry.counts, None, carry.slots,
                                        carry.tree_hi, carry.tree_lo, carry.t, ids, flags)
    if kind == "ftpl":
        return carry, minpair_automaton("ftpl", carry.imap, carry.counts, carry.noise,
                                        carry.slots, carry.tree_hi, carry.tree_lo, None, ids,
                                        flags)
    raise ValueError(f"unknown tree engine kind {kind!r} (have {TREE_ENGINE_KINDS})")


def make_tree_chunk(kind: str, carry, return_flags: bool = False):
    """Chunk step ``(carry, ids) -> (carry, (hits, occupancy))`` for the
    given carry, the reference's: ``hits`` the () int32 count, or with
    ``return_flags`` the (window,) bool per-request flags; occupancy a ()
    float32 tensor."""
    if kind not in TREE_ENGINE_KINDS:
        raise ValueError(f"unknown tree engine kind {kind!r} (have {TREE_ENGINE_KINDS})")
    del carry  # the geometry comes from the carry each chunk is given

    def chunk(c, ids):
        flags = torch.empty(ids.shape, dtype=torch.bool, device=ids.device) if return_flags \
            else None
        c, (hits, stats) = tree_chunk(kind, c, ids, flags)
        return c, (flags if return_flags else hits, stats[2])

    return chunk
