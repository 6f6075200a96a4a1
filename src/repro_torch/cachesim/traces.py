"""Synthetic request traces, copied from ``repro.cachesim.traces``.

Every generator of the reference, calibrated to the statistics the paper
reports for its traces:

* ``adversarial``  — round-robin over the catalog with a fresh random
  permutation each round (paper Fig. 2);
* ``zipf``         — stationary Zipf(alpha), the ``cdn`` regime (Fig. 8 left);
* ``shifting_zipf``— Zipf re-permuted every ``phase`` requests, the ``ms-ex``
  regime (Fig. 7 left);
* ``bursty``       — Zipf base traffic and short-lived bursts, the ``twitter``
  regime (Fig. 8 right);
* ``scan_mix``     — looping scans over disjoint ranges and a hot set, the
  ``systor`` regime (Fig. 7 right);
* ``real_like``    — a stats-matched synthesis fitted to a sampled source
  trace (:mod:`repro_torch.cachesim.tracelab.synth`).

All return ``np.ndarray[int64]`` of item ids in ``[0, N)``, the same ids as
the reference for the same seed (numpy only).  ``trace_stats`` and
``reuse_distances`` recompute the paper's §B.2 lifetime and reuse-distance
statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _zipf_weights(n: int, alpha: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return w / w.sum()


def adversarial(N: int, T: int, seed: int = 0) -> np.ndarray:
    """Round-robin with per-round random permutation (paper Fig 2)."""
    rng = np.random.default_rng(seed)
    rounds = T // N + 1
    out = np.empty(rounds * N, dtype=np.int64)
    for r in range(rounds):
        out[r * N : (r + 1) * N] = rng.permutation(N)
    return out[:T]


def zipf(N: int, T: int, alpha: float = 0.8, seed: int = 0) -> np.ndarray:
    """Stationary Zipf(alpha) — cdn-like."""
    rng = np.random.default_rng(seed)
    w = _zipf_weights(N, alpha)
    return rng.choice(N, size=T, p=w).astype(np.int64)


def shifting_zipf(
    N: int, T: int, alpha: float = 0.9, phase: int = 100_000, seed: int = 0
) -> np.ndarray:
    """Zipf with popularity ranks re-permuted every ``phase`` requests — ms-ex-like."""
    rng = np.random.default_rng(seed)
    w = _zipf_weights(N, alpha)
    out = np.empty(T, dtype=np.int64)
    t = 0
    while t < T:
        n = min(phase, T - t)
        perm = rng.permutation(N)
        draws = rng.choice(N, size=n, p=w)
        out[t : t + n] = perm[draws]
        t += n
    return out


def bursty(
    N: int,
    T: int,
    alpha: float = 0.7,
    burst_fraction: float = 0.35,
    burst_len_mean: float = 6.0,
    burst_span: int = 80,
    seed: int = 0,
) -> np.ndarray:
    """Zipf base + short-lived bursty items — twitter-like (paper §B.2).

    ``burst_fraction`` of requests go to one-shot items whose entire lifetime
    (first to last request) spans < ``burst_span`` requests; each such item is
    requested Geom(1/burst_len_mean)+1 times in a tight window.  These items
    produce hits for recency policies but not for any static allocation, and
    they lose their hits when the batch size B exceeds their lifetime.
    """
    rng = np.random.default_rng(seed)
    n_base = int(N * 0.5)
    w = _zipf_weights(n_base, alpha)
    base = rng.choice(n_base, size=T, p=w).astype(np.int64)
    out = base.copy()
    # overlay bursts on a burst_fraction of slots, ids from the upper half
    n_burst_requests = int(T * burst_fraction)
    next_burst_id = n_base
    t = 0
    placed = 0
    while placed < n_burst_requests and t < T - burst_span:
        k = 1 + rng.geometric(1.0 / burst_len_mean)
        k = int(min(k, burst_span // 2, n_burst_requests - placed))
        if k <= 0:
            break
        pos = t + np.sort(rng.choice(burst_span, size=max(k, 1), replace=False))
        item = next_burst_id
        next_burst_id += 1
        if next_burst_id >= N:
            next_burst_id = n_base
        out[pos] = item
        placed += k
        # advance so bursts tile the trace roughly uniformly
        t += max(1, int(burst_span * k / max(n_burst_requests / (T / burst_span), 1e-9) / burst_span))
        t += rng.integers(1, 4)
    return out


def scan_mix(
    N: int,
    T: int,
    hot_fraction: float = 0.55,
    hot_items: Optional[int] = None,
    scan_len: int = 2000,
    seed: int = 0,
) -> np.ndarray:
    """Hot working set + looping sequential scans — systor/VDI-like."""
    rng = np.random.default_rng(seed)
    hot_n = hot_items if hot_items is not None else max(N // 20, 1)
    w = _zipf_weights(hot_n, 1.0)
    out = np.empty(T, dtype=np.int64)
    t = 0
    scan_base = hot_n
    while t < T:
        if rng.random() < hot_fraction:
            n = min(rng.integers(50, 400), T - t)
            out[t : t + n] = rng.choice(hot_n, size=n, p=w)
        else:
            n = min(scan_len, T - t)
            start = scan_base + int(rng.integers(0, max(N - scan_base - scan_len, 1)))
            out[t : t + n] = (start + np.arange(n)) % N
        t += n
    return out


def real_like(
    N: int,
    T: int,
    source: str = "zipf",
    sample_T: Optional[int] = None,
    seed: int = 0,
    **source_kw,
) -> np.ndarray:
    """Stats-matched "real-trace-shaped" workload (tracelab synthesizer).

    Stands in for the paper's real traces without shipping datasets: a
    ``source`` trace is sampled (``sample_T`` requests, a few percent of a
    paper-scale T), its §B.2 statistics are fitted
    (:func:`repro_torch.cachesim.tracelab.synth.fit_profile`), and a trace of
    the requested length is synthesized with matching popularity skew,
    reuse-distance profile and drift.  For out-of-core lengths use
    :func:`repro_torch.cachesim.tracelab.synth.synthesize_chunks` directly —
    this registry entry materializes.
    """
    from repro_torch.cachesim.tracelab.synth import fit_profile, synthesize

    if sample_T is None:
        sample_T = int(np.clip(T // 10, 2_000, 200_000))
    # the sample catalog scales with the sample so fitted per-item stats
    # (one-shot share, burst composition) survive the T extrapolation
    sample_N = max(min(N, max(sample_T // 10, 8)), 1)
    sample = TRACE_REGISTRY[source](sample_N, sample_T, seed=seed, **source_kw)
    profile = fit_profile(sample)
    return synthesize(profile, T, catalog=N, seed=seed + 1)


TRACE_REGISTRY = {
    "adversarial": adversarial,
    "zipf": zipf,
    "cdn_like": zipf,
    "shifting_zipf": shifting_zipf,
    "ms_ex_like": shifting_zipf,
    "bursty": bursty,
    "twitter_like": bursty,
    "scan_mix": scan_mix,
    "systor_like": scan_mix,
    "real_like": real_like,
}


def make_trace(kind: str, N: int, T: int, seed: int = 0, **kw) -> np.ndarray:
    return TRACE_REGISTRY[kind](N, T, seed=seed, **kw)


# ---------------------------------------------------------------------------
# paper §B.2 statistics: item lifetime and reuse distance
# ---------------------------------------------------------------------------
@dataclass
class TraceStats:
    """Per-item lifetime / attainable-hit statistics, fully vectorized.

    The array form (``items`` / ``lifetimes`` / ``max_hits``, aligned) is the
    fast path used at paper scale (T = 2e7); the dict views are materialized
    lazily for the exploratory / test surface.
    """

    catalog: int
    length: int
    unique: int
    items: np.ndarray  # (U,) item ids actually requested
    lifetimes: np.ndarray  # (U,) last - first request position
    max_hits: np.ndarray  # (U,) requests - 1 (infinite-cache hits)
    _lifetime_dict: Optional[Dict[int, int]] = None
    _max_hits_dict: Optional[Dict[int, int]] = None

    @property
    def lifetime_by_item(self) -> Dict[int, int]:
        if self._lifetime_dict is None:
            self._lifetime_dict = dict(
                zip(self.items.tolist(), self.lifetimes.tolist())
            )
        return self._lifetime_dict

    @property
    def max_hits_by_item(self) -> Dict[int, int]:
        if self._max_hits_dict is None:
            self._max_hits_dict = dict(
                zip(self.items.tolist(), self.max_hits.tolist())
            )
        return self._max_hits_dict

    def hit_share_lifetime_below(self, L: int) -> float:
        """Fraction of infinite-cache hits from items with lifetime < L
        (paper Fig 11 left)."""
        tot = int(self.max_hits.sum())
        if tot == 0:
            return 0.0
        return float(self.max_hits[self.lifetimes < L].sum()) / tot


def trace_stats(trace: np.ndarray) -> TraceStats:
    """Vectorized lifetime statistics, correct on sparse/gappy id sets.

    Ids need not be dense ``0..N-1``: raw logs (block addresses, hashed
    keys) carry sparse 64-bit ids, and allocating ``max(id)+1`` arrays for
    them would OOM long before the trace does.  Two equivalent paths:

    * **dense** (``max(id)`` comparable to the trace length) — O(T + N):
      first/last positions fall out of two fancy-index writes (assigning
      ``np.arange(T)`` at ``trace`` keeps the *last* write per item; the
      same on the reversed trace keeps the *first*);
    * **sparse** — O(T log T): ``np.unique`` compresses the id set first
      and the identical fancy-index writes run on the inverse codes.

    Both return identical results (``items`` ascending); only the memory
    scaling differs.  ``catalog`` is always ``max(id) + 1`` — a label for
    the id *space*, not an allocation size.
    """
    trace = np.asarray(trace, dtype=np.int64)
    t_len = len(trace)
    if t_len == 0:
        e = np.empty(0, np.int64)
        return TraceStats(0, 0, 0, e, e, e)
    if trace.min() < 0:
        raise ValueError("trace_stats: negative item ids")
    n = int(trace.max()) + 1
    pos = np.arange(t_len, dtype=np.int64)
    if n <= max(4 * t_len, 1 << 22):  # dense ids: O(T + N) histogram path
        counts = np.bincount(trace, minlength=n)
        last = np.full(n, -1, np.int64)
        last[trace] = pos
        first = np.full(n, -1, np.int64)
        first[trace[::-1]] = t_len - 1 - pos
        items = np.nonzero(counts)[0]
        lifetimes = last[items] - first[items]
        max_hits = counts[items] - 1
    else:  # sparse/gappy ids: compress through np.unique first
        items, inverse, counts = np.unique(
            trace, return_inverse=True, return_counts=True
        )
        u = len(items)
        last = np.full(u, -1, np.int64)
        last[inverse] = pos
        first = np.full(u, -1, np.int64)
        first[inverse[::-1]] = t_len - 1 - pos
        lifetimes = last - first
        max_hits = counts - 1
    return TraceStats(
        catalog=n,
        length=t_len,
        unique=len(items),
        items=items,
        lifetimes=lifetimes,
        max_hits=max_hits,
    )


def reuse_distances(trace: np.ndarray) -> np.ndarray:
    """Timestamp gaps between consecutive requests of the same item (Fig 11
    right), ordered by the position of the later request.

    Vectorized: a stable argsort groups each item's request positions in time
    order, so within-group diffs are exactly the reuse gaps.
    """
    trace = np.asarray(trace, dtype=np.int64)
    if len(trace) < 2:
        return np.empty(0, dtype=np.int64)
    order = np.argsort(trace, kind="stable")  # by item, time-ordered within
    same = trace[order][1:] == trace[order][:-1]
    gaps = (order[1:] - order[:-1])[same]
    at = order[1:][same]  # position of the later request
    return gaps[np.argsort(at, kind="stable")]
