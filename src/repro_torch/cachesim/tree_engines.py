"""Lazy bucketized OGB: per-chunk work that does not grow with the catalog.

Counterpart of the ``ogb_tree`` part of ``repro.cachesim.tree_engines``
(``OGB_TREE_*``, ``OGBTreeCarry``, ``_ogb_bucket``, ``init_ogb_tree_carry``
and ``make_ogb_tree_chunk``).  The state is the unprojected accumulation
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
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim.replay import sampling_keys
from repro_torch.jaxcache.fractional import request_counts
from repro_torch.kernels.prefix_tree.kernel import solve_buckets
from repro_torch.kernels.prefix_tree.ops import tree_build, tree_prefix, tree_total, tree_update_

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
