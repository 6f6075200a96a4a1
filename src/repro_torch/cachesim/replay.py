"""The per-chunk OGB_cl step: hit accounting, gradient histogram, projection.

Counterpart of ``repro.cachesim.replay`` (``sampling_keys``,
``sample_chunk_metrics``, ``_make_ogb_step`` and ``opt_hits_by_combo``).  The reference scans this
step inside one ``lax.scan``; here :func:`repro_torch.cachesim.api.run`
calls it once per chunk from a Python loop.  Every catalog-sized pass of
the step is a hand-written kernel on the card: the histogram, and the warm
projection's Newton sweeps with the final clip in one launch (bisection:
one mass pass a step, then the clip); ``madow_tree`` adds one tree build
(one launch) for its sample.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.jaxcache.fractional import (
    capped_simplex_project,
    capped_simplex_project_warm,
    madow_sample,
    permanent_random_numbers,
    request_counts,
    warm_bracket_hi,
)
from repro_torch.kernels.prefix_tree.ops import madow_sample_tree

#: sampling modes that draw a per-chunk Madow offset u from the carried key
MADOW_SAMPLES = ("madow", "madow_tree")
SAMPLES = ("poisson", "none") + MADOW_SAMPLES


def _check_sample(sample: str) -> None:
    if sample not in SAMPLES:
        raise ValueError(f"unknown sample mode {sample!r}")


def sampling_keys(seed: int, catalog_size: int, sample: str, device: torch.device):
    """Seed-derived ``(p, u_key)``: the permanent random numbers for
    Poisson sampling (size 0 when unused) and the () int64 key that drives
    the per-chunk Madow offsets (:func:`repro_torch.cachesim.api._chunk_u`).

    Same roles as the reference's, other bits: JAX's threefry cannot be
    reproduced.  p comes from a CPU ``torch.Generator`` and the key is the
    seed itself, so both are the same on every device.
    """
    _check_sample(sample)
    if sample == "poisson":
        p = permanent_random_numbers(seed, catalog_size, device)
    else:
        p = torch.zeros((0,), dtype=torch.float32, device=device)
    return p, torch.tensor(int(seed), dtype=torch.int64, device=device)


def sample_chunk_metrics(sample: str, capacity, f: torch.Tensor, ids: torch.Tensor,
                         p: torch.Tensor, u: torch.Tensor):
    """(reward, hits, occupancy) for one request chunk at the pre-update
    state ``f`` (OCO order), as 0-d tensors on f's device.

    ``capacity`` is the static C the Madow modes sample (None otherwise).
    ``madow_tree`` draws the same systematic sample as ``madow`` by
    prefix-tree descent, up to float32 tree sums at the boundaries.

    A grid's (R, N) ``f`` and ``p`` (``"poisson"`` and ``"none"``) give
    (R,) tensors, each row's hits and occupancy its own run's; ``ids`` is
    then one (B,) chunk for every row (a sweep) or (R, B), a row of ids each
    (a fleet's tenants)."""
    _check_sample(sample)
    if f.dim() == 2:
        if sample not in ("poisson", "none"):
            raise ValueError(f"a grid of combos samples 'poisson' or 'none', not {sample!r}")
        if ids.dim() == 2:  # a row of ids a row of f
            rows = ids.to(torch.int64)
            fi = f.gather(1, rows)
            pi = p.gather(1, rows) if sample == "poisson" else None
        else:
            fi = f.index_select(1, ids)
            pi = p.index_select(1, ids) if sample == "poisson" else None
        reward = _row_sum(fi)
        if sample == "poisson":
            hits = (fi >= pi).sum(dim=1, dtype=torch.int32)
            occ = (f >= p).sum(dim=1, dtype=torch.float32)
        else:
            hits = torch.zeros(f.shape[0], dtype=torch.int32, device=f.device)
            occ = _row_sum(f)
        return reward, hits, occ
    fi = f.index_select(0, ids)
    reward = _row_sum(fi)
    if sample == "poisson":
        # hits only need the requested coordinates; occupancy is the one
        # remaining catalog pass
        hits = (fi >= p.index_select(0, ids)).sum(dtype=torch.int32)
        occ = (f >= p).sum(dtype=torch.float32)
    elif sample == "madow":
        cached = madow_sample(f, u, capacity)
        hits = cached.index_select(0, ids).sum(dtype=torch.int32)
        occ = cached.sum(dtype=torch.float32)
    elif sample == "madow_tree":
        sel = madow_sample_tree(f, u, capacity)  # (C,) ascending leaf ids
        ids64 = ids.to(torch.int64)
        pos = torch.clamp(torch.searchsorted(sel, ids64), max=capacity - 1)
        hits = (sel.index_select(0, pos) == ids64).sum(dtype=torch.int32)
        occ = torch.full((), float(capacity), dtype=torch.float32, device=f.device)
    else:
        hits = torch.zeros((), dtype=torch.int32, device=f.device)
        occ = _row_sum(f)
    return reward, hits, occ


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum of ``x`` over its last axis, accumulated in float64 and
    rounded once.  A row of a grid and the same values alone are reduced
    in different orders (the card's reduction splits a row by the number
    of rows); in float64 the orders agree to ~1e-16, so each row rounds to
    its own run's float32 bits unless its sum lies that close to a float32
    rounding tie."""
    return x.sum(dim=-1, dtype=torch.float64).to(torch.float32)


def _make_ogb_step(sample: str, projection: str, sweeps: int, iters: int,
                   madow_capacity: Optional[int] = None):
    """The per-chunk OGB_cl update with eta and capacity as 0-d tensors.

    Returns ``step(eta, p, cap, f, tau_prev, ids, u) -> (f', tau, (reward,
    hits, tau, occupancy))``; the chunk size B is read off ``ids`` and ``u``
    is the chunk's Madow offset (unused by the other modes).
    ``madow_capacity`` must be the static C for the Madow modes.

    The same step takes a sweep's grid: (R, N) ``f`` and ``p``, (R,)
    ``eta``, ``cap`` and ``tau_prev``, one chunk of ids for all; or a
    fleet's, whose (R, B) ids are a row of ids a tenant.  Then the
    histogram is one launch for the grid ((B,) ids give one histogram,
    (R, B) a row each) and the warm projection one launch, whose rows are
    bit for bit each combo's own run.
    """
    _check_sample(sample)
    if projection not in ("warm", "bisect"):
        raise ValueError(f"unknown projection mode {projection!r}")
    if sample in MADOW_SAMPLES and madow_capacity is None:
        raise ValueError("madow sampling needs a static capacity")

    def step(eta, p, cap, f, tau_prev, ids, u):
        reward, hits, occ = sample_chunk_metrics(sample, madow_capacity, f, ids, p, u)
        # The gradient step is y = f + eta * counts, formed inside the
        # kernels.  The reference adds eta once per duplicate id
        # (f.at[ids].add(eta)), so with duplicates y can differ by 1 ulp.
        counts = request_counts(ids, f.shape[-1])
        if projection == "warm":
            hi = warm_bracket_hi(eta * float(ids.shape[-1]))  # B, a row's chunk
            f_new, tau = capped_simplex_project_warm(
                f, counts, eta, cap, torch.zeros_like(tau_prev), hi, tau_prev, sweeps
            )
        else:
            f_new, tau = capped_simplex_project(f, counts, eta, cap, iters)
        return f_new, tau, (reward, hits, tau, occ)

    return step


def opt_hits_by_combo(trace_prefix: np.ndarray, combos: List[Dict[str, float]]) -> np.ndarray:
    """Hindsight static-OPT per combo, computed on the host once per
    capacity (OPT depends only on the trace histogram and C)."""
    from repro_torch.core.regret import best_static_hits

    opt_by_c = {c: float(best_static_hits(trace_prefix, c))
                for c in set(int(combo["capacity"]) for combo in combos)}
    return np.asarray([opt_by_c[int(c["capacity"])] for c in combos])
