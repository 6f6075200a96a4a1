"""Stats-matched workload synthesizer, copied from ``repro.cachesim.tracelab.synth``.

:func:`fit_profile` measures the §B.2 statistics of a (sampled) trace —
popularity skew, one-shot and burst composition, reuse-distance profile,
popularity drift — and :func:`synthesize_chunks` emits arbitrarily long
traces matching them:

* **popularity skew** — base requests draw ranks from the fitted
  rank-quantile CDF, mapped through a per-phase rank permutation;
* **drift** — the permutation is re-drawn every ``drift_phase`` requests;
* **reuse-distance / lifetime profile** — one-shot items and short-lived
  bursts are overlaid at the fitted rates.

Generation is blockwise-deterministic: block ``b`` of the stream is a pure
function of ``(profile, catalog, seed, b)``, so any chunk size gives the
same trace, and every id is the reference's for the same inputs (numpy
only).  ``real_like`` (:mod:`repro_torch.cachesim.traces`) is its caller;
``synthesize_sizes`` pairs a sized fit with item sizes; the per-tenant
streams of the fleet wait for the fleet's slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from repro_torch.cachesim.traces import reuse_distances, trace_stats

#: fixed internal generation block — chunk-size invariance comes from here
BLOCK = 8192

_POP_BINS = 64
_REUSE_SAMPLE = 200_000
_DRIFT_SIM_THRESHOLD = 0.5
#: popularity-rank bins of the fitted size--popularity joint
_SIZE_BINS = 8


@dataclass(frozen=True)
class TraceProfile:
    """The fitted statistics :func:`synthesize_chunks` reproduces.

    Rank bins are stored as *fractions* of the base catalog so a profile
    fitted on a sampled trace scales to any synthesis catalog size.
    """

    catalog: int  # suggested synthesis catalog (source distinct items)
    pop_cdf: np.ndarray  # (K,) cumulative base-request mass per rank bin
    pop_bins: np.ndarray  # (K+1,) rank-bin edges as fractions in [0, 1]
    base_item_frac: float  # share of distinct items that are base items
    oneshot_frac: float  # share of requests to items requested exactly once
    burst_frac: float  # share of requests to short-lived multi-use items
    burst_len_mean: float  # mean requests per burst item
    burst_span: int  # lifetime bound defining "short-lived"
    drift_phase: int  # requests per popularity phase (0 = stationary)
    source_T: int
    reuse_q: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float64)
    )  # source reuse-distance quantiles (calibration reference)
    #: size--popularity joint: per popularity-rank bin, the lognormal
    #: (log-mean, log-std) of item sizes in that bin.  Empty = unsized fit.
    size_logmu: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float64)
    )  # (J,) log-mean item size per rank bin
    size_logsd: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float64)
    )  # (J,) log-std item size per rank bin
    size_rank_bins: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float64)
    )  # (J+1,) rank-bin edges as fractions in [0, 1]


def _segment_drift_phase(trace: np.ndarray) -> int:
    """Decorrelation scale of segment popularity vectors (0 = stationary).

    The finest even split whose consecutive-segment popularity cosine
    similarity drops below ``_DRIFT_SIM_THRESHOLD`` names the phase
    length; a stationary trace stays similar at every scale.
    """
    t = len(trace)
    if t < 4096:
        return 0
    _, inv = np.unique(trace, return_inverse=True)
    u = int(inv.max()) + 1
    for n_seg in (16, 8, 4, 2):
        seg = t // n_seg
        counts = np.stack(
            [
                np.bincount(inv[i * seg : (i + 1) * seg], minlength=u)
                for i in range(n_seg)
            ]
        ).astype(np.float64)
        norms = np.linalg.norm(counts, axis=1)
        sims = (counts[1:] * counts[:-1]).sum(axis=1) / np.maximum(
            norms[1:] * norms[:-1], 1e-12
        )
        if float(np.mean(sims)) < _DRIFT_SIM_THRESHOLD:
            return seg
    return 0


def _fit_size_joint(trace: np.ndarray, sizes: np.ndarray):
    """Lognormal item-size fit per popularity-rank bin.

    An item's size is its first-seen request size; items are ranked by
    request count (descending, stable) and grouped into ``_SIZE_BINS``
    log-spaced rank bins — dense at the head, where size--popularity
    correlation (small-hot vs large-cold CDN objects) matters most."""
    sizes = np.asarray(sizes, np.float64)
    if sizes.shape != trace.shape:
        raise ValueError(
            f"sizes shape {sizes.shape} != trace shape {trace.shape}"
        )
    if not (np.all(np.isfinite(sizes)) and float(sizes.min()) > 0.0):
        raise ValueError("sizes must be finite and > 0")
    _, first_idx, cnt = np.unique(
        trace, return_index=True, return_counts=True
    )
    item_logsz = np.log(sizes[first_idx])
    order = np.argsort(-cnt, kind="stable")
    ranked = item_logsz[order]
    u = len(ranked)
    j = min(_SIZE_BINS, u)
    edges = np.unique(
        np.round(np.geomspace(1, u, j + 1) - 1).astype(np.int64)
    )
    if len(edges) < 2:
        edges = np.asarray([0, u], dtype=np.int64)
    edges[0], edges[-1] = 0, u
    mu = np.empty(len(edges) - 1)
    sd = np.empty(len(edges) - 1)
    for q in range(len(edges) - 1):
        seg = ranked[edges[q] : max(edges[q + 1], edges[q] + 1)]
        if seg.size == 0:  # guard: geomspace edge collisions are deduped
            seg = ranked[-1:]
        mu[q] = float(seg.mean())
        sd[q] = float(seg.std())
    return mu, sd, edges.astype(np.float64) / u


def fit_profile(
    trace: np.ndarray,
    *,
    sizes: Optional[np.ndarray] = None,
    burst_span: int = 100,
    bins: int = _POP_BINS,
) -> TraceProfile:
    """Measure the synthesis statistics of a trace (sparse raw ids are fine
    — everything routes through the sparse-safe :func:`trace_stats`).

    ``sizes`` (per-request bytes, e.g. from a sized trace log) additionally fits the size--popularity joint, which
    :func:`synthesize_sizes` reproduces for the synthesized catalog."""
    trace = np.asarray(trace, dtype=np.int64)
    t_len = len(trace)
    if t_len == 0:
        raise ValueError("cannot fit a profile on an empty trace")
    stats = trace_stats(trace)
    counts = stats.max_hits + 1  # requests per distinct item
    oneshot = counts == 1
    bursty = (~oneshot) & (stats.lifetimes < burst_span)
    base = ~(oneshot | bursty)

    oneshot_frac = float(counts[oneshot].sum()) / t_len
    burst_requests = int(counts[bursty].sum())
    burst_frac = burst_requests / t_len
    burst_len_mean = (
        float(counts[bursty].mean()) if burst_requests else 2.0
    )

    base_counts = np.sort(counts[base])[::-1].astype(np.float64)
    if base_counts.size == 0:
        # degenerate (everything one-shot): a flat one-bin base
        base_counts = np.asarray([1.0])
    u_base = len(base_counts)
    probs = base_counts / base_counts.sum()
    # log-spaced rank-bin edges: dense near the head where the mass lives
    k = min(bins, u_base)
    edges = np.unique(
        np.round(
            np.geomspace(1, u_base, k + 1) - 1
        ).astype(np.int64)
    )
    if len(edges) < 2:
        edges = np.asarray([0, u_base], dtype=np.int64)
    edges[0], edges[-1] = 0, u_base
    cum = np.concatenate([[0.0], np.cumsum(probs)])
    pop_cdf = cum[edges[1:]] - cum[edges[:-1]]
    pop_cdf = np.cumsum(pop_cdf)
    pop_cdf /= pop_cdf[-1]

    sample = trace[:_REUSE_SAMPLE]
    rd = reuse_distances(sample)
    reuse_q = (
        np.quantile(rd, [0.25, 0.5, 0.75, 0.9]).astype(np.float64)
        if rd.size
        else np.empty(0, np.float64)
    )

    if sizes is not None:
        s_mu, s_sd, s_bins = _fit_size_joint(trace, sizes)
    else:
        s_mu = s_sd = s_bins = np.empty(0, np.float64)

    return TraceProfile(
        catalog=int(stats.unique),
        pop_cdf=pop_cdf,
        pop_bins=edges.astype(np.float64) / u_base,
        base_item_frac=float(base.sum()) / max(stats.unique, 1),
        oneshot_frac=oneshot_frac,
        burst_frac=burst_frac,
        burst_len_mean=burst_len_mean,
        burst_span=burst_span,
        drift_phase=_segment_drift_phase(trace),
        source_T=t_len,
        reuse_q=reuse_q,
        size_logmu=s_mu,
        size_logsd=s_sd,
        size_rank_bins=s_bins,
    )


def _base_split(profile: TraceProfile, catalog: int) -> int:
    """Base/overlay catalog split: overlay needs a pool of short-lived ids;
    tiny catalogs (< 8) give everything to the base popularity model."""
    n_base = catalog
    if catalog >= 8 and profile.base_item_frac < 1.0:
        n_base = int(np.clip(
            round(catalog * max(profile.base_item_frac, 0.05)),
            1,
            catalog - 1,
        ))
    return n_base


def _phase_perm(n_base: int, seed: int, phase: int) -> np.ndarray:
    """The rank->item permutation for one popularity phase (pure function
    of (seed, phase) so any block can regenerate it)."""
    rng = np.random.default_rng([seed, 0x5A5A, phase])
    return rng.permutation(n_base)


def _gen_block(
    profile: TraceProfile,
    catalog: int,
    n_base: int,
    seed: int,
    b: int,
    length: int,
    perm_cache: dict,
) -> np.ndarray:
    """Block ``b`` of the stream: deterministic in (profile, catalog, seed, b).

    The full ``BLOCK`` draws are always generated and then truncated to
    ``length``, so a shorter synthesis is an exact *prefix* of a longer
    one — T only ever truncates the stream, never reshuffles it."""
    rng = np.random.default_rng([seed, 0xB10C, b])
    pos0 = b * BLOCK

    # --- base traffic: rank-CDF draws through the per-phase permutation
    u = rng.random(BLOCK)
    j = np.searchsorted(profile.pop_cdf, u, side="right")
    j = np.minimum(j, len(profile.pop_cdf) - 1)
    lo = profile.pop_bins[j] * n_base
    hi = profile.pop_bins[j + 1] * n_base
    ranks = np.minimum(
        (lo + rng.random(BLOCK) * np.maximum(hi - lo, 1.0)).astype(np.int64),
        n_base - 1,
    )
    if profile.drift_phase > 0:
        out = np.empty(BLOCK, dtype=np.int64)
        pos = pos0
        done = 0
        while done < BLOCK:
            phase = pos // profile.drift_phase
            take = min(
                BLOCK - done, (phase + 1) * profile.drift_phase - pos
            )
            if phase not in perm_cache:
                if len(perm_cache) > 2:
                    perm_cache.clear()
                perm_cache[phase] = _phase_perm(n_base, seed, phase)
            perm = perm_cache[phase]
            out[done : done + take] = perm[ranks[done : done + take]]
            done += take
            pos += take
        ids = out
    else:
        if 0 not in perm_cache:
            perm_cache[0] = _phase_perm(n_base, seed, 0)
        ids = perm_cache[0][ranks]

    # --- overlay: one-shot items and short-lived bursts from the tail pool
    pool = catalog - n_base
    if pool > 0:
        pool_off = (b * (BLOCK // 2 + 1)) % pool
        fresh = 0

        def _fresh_ids(k: int) -> np.ndarray:
            nonlocal fresh
            out = n_base + (pool_off + fresh + np.arange(k)) % pool
            fresh += k
            return out

        n_one = rng.binomial(BLOCK, min(profile.oneshot_frac, 1.0))
        if n_one:
            at = rng.choice(BLOCK, size=n_one, replace=False)
            ids[at] = _fresh_ids(n_one)
        if profile.burst_frac > 0:
            span = min(profile.burst_span, BLOCK)
            n_bursts = rng.poisson(
                BLOCK * profile.burst_frac / max(profile.burst_len_mean, 1.0)
            )
            for _ in range(int(n_bursts)):
                k = 1 + rng.geometric(
                    1.0 / max(profile.burst_len_mean - 1.0, 1.0)
                )
                k = int(min(k, span))
                start = int(rng.integers(0, max(BLOCK - span, 1)))
                at = start + rng.choice(span, size=k, replace=False)
                ids[at] = _fresh_ids(1)[0]
    return ids[:length]


def synthesize_chunks(
    profile: TraceProfile,
    T: int,
    *,
    catalog: Optional[int] = None,
    seed: int = 0,
    chunk_size: int = 65536,
) -> Iterator[np.ndarray]:
    """Stream ``T`` synthesized requests in ``chunk_size`` pieces.

    Fixed memory: O(``chunk_size`` + ``catalog``), independent of ``T``.
    The stream content depends only on ``(profile, catalog, seed)`` — any
    ``chunk_size`` concatenates to the same trace.
    """
    if T < 0:
        raise ValueError(f"T must be >= 0, got {T}")
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    catalog = int(catalog if catalog is not None else profile.catalog)
    if catalog < 1:
        raise ValueError(f"catalog must be >= 1, got {catalog}")
    n_base = _base_split(profile, catalog)

    perm_cache: dict = {}
    buf: list = []
    buffered = 0
    for b in range(-(-T // BLOCK)):  # ceil(T / BLOCK) blocks
        length = min(BLOCK, T - b * BLOCK)
        buf.append(
            _gen_block(profile, catalog, n_base, seed, b, length, perm_cache)
        )
        buffered += length
        while buffered >= chunk_size:
            merged = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield merged[:chunk_size]
            rest = merged[chunk_size:]
            buf = [rest] if rest.size else []
            buffered = rest.size
    if buffered:
        yield np.concatenate(buf) if len(buf) > 1 else buf[0]


def synthesize_sizes(
    profile: TraceProfile,
    *,
    catalog: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Per-item sizes (bytes) reproducing the fitted size--popularity joint.

    Returns a ``(catalog,)`` array aligned with the item ids that
    :func:`synthesize_chunks` emits for the same ``(profile, catalog,
    seed)``: each popularity rank draws from its rank bin's fitted
    lognormal, and ranks map to item ids through the phase-0 base
    permutation (under drift, later phases re-rank items while their sizes
    stay fixed — sizes are a per-object property).  Overlay-pool items
    (one-shots/bursts) draw from the tail bin.  An unsized profile yields
    unit sizes, so the pairing is always safe to use."""
    catalog = int(catalog if catalog is not None else profile.catalog)
    if catalog < 1:
        raise ValueError(f"catalog must be >= 1, got {catalog}")
    if profile.size_logmu.size == 0:
        return np.ones(catalog, np.float64)
    rng = np.random.default_rng([seed, 0x512E])
    frac = (np.arange(catalog, dtype=np.float64) + 0.5) / catalog
    q = np.clip(
        np.searchsorted(profile.size_rank_bins, frac, side="right") - 1,
        0,
        len(profile.size_logmu) - 1,
    )
    by_rank = np.exp(
        profile.size_logmu[q] + profile.size_logsd[q] * rng.standard_normal(
            catalog
        )
    )
    n_base = _base_split(profile, catalog)
    out = np.empty(catalog, np.float64)
    out[_phase_perm(n_base, seed, 0)] = by_rank[:n_base]
    out[n_base:] = by_rank[n_base:]
    return out


def synthesize(
    profile: TraceProfile,
    T: int,
    *,
    catalog: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Materialized convenience wrapper over :func:`synthesize_chunks`."""
    chunks = list(
        synthesize_chunks(profile, T, catalog=catalog, seed=seed)
    )
    if not chunks:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(chunks)


def tenant_streams(
    profile: TraceProfile,
    n_tenants: int,
    T: int,
    *,
    catalog: Optional[int] = None,
    base_seed: int = 0,
    chunk_size: int = 65536,
) -> list:
    """E stats-matched per-tenant chunk streams for ``cachesim.fleet``.

    Tenant ``e`` synthesizes an independent ``T``-request stream from the
    same fitted profile with seed ``base_seed + e``: statistically matched
    tenants with decorrelated request sequences.  Each entry is a fresh
    :func:`synthesize_chunks` iterator, so the list plugs straight into
    ``run_fleet_stream(sources=...)`` in fixed memory.
    """
    if n_tenants <= 0:
        raise ValueError(f"n_tenants must be positive (got {n_tenants})")
    return [
        synthesize_chunks(profile, T, catalog=catalog, seed=base_seed + e, chunk_size=chunk_size)
        for e in range(n_tenants)
    ]
