"""The per-chunk OGB_cl step: hit accounting, gradient histogram, projection.

Counterpart of ``repro.cachesim.replay`` (``sampling_keys``,
``sample_chunk_metrics`` and ``_make_ogb_step``).  The reference scans this
step inside one ``lax.scan``; here :func:`repro_torch.cachesim.api.run`
calls it once per chunk from a Python loop.  Every catalog-sized pass of
the step is a hand-written kernel on the card: the histogram, one mass pass
per Newton sweep, and the final clip.
"""

from __future__ import annotations

import torch

from repro_torch.jaxcache.fractional import (
    capped_simplex_project,
    capped_simplex_project_warm,
    permanent_random_numbers,
    request_counts,
    warm_bracket_hi,
)

#: sampling modes of the reference that a later slice of the port brings
#: over, with the Madow offsets they draw per chunk
LATER_SAMPLES = ("madow", "madow_tree")


def _check_sample(sample: str) -> None:
    if sample in LATER_SAMPLES:
        raise NotImplementedError(
            f"sample={sample!r} is not ported yet: Madow sampling comes with "
            f"the next slice of the port (see ROADMAP.md); use 'poisson' or "
            f"'none'"
        )
    if sample not in ("poisson", "none"):
        raise ValueError(f"unknown sample mode {sample!r}")


def sampling_keys(
    seed: int, catalog_size: int, sample: str, device: torch.device
) -> torch.Tensor:
    """The seed-derived permanent random numbers p for Poisson sampling
    (size 0 when unused).  The Madow key arrives with Madow sampling."""
    _check_sample(sample)
    if sample == "poisson":
        return permanent_random_numbers(seed, catalog_size, device)
    return torch.zeros((0,), dtype=torch.float32, device=device)


def sample_chunk_metrics(sample: str, f: torch.Tensor, ids: torch.Tensor, p: torch.Tensor):
    """(reward, hits, occupancy) for one request chunk at the pre-update
    state ``f`` (OCO order), as 0-d tensors on f's device."""
    _check_sample(sample)
    fi = f.index_select(0, ids)
    reward = fi.sum()
    if sample == "poisson":
        # hits only need the requested coordinates; occupancy is the one
        # remaining catalog pass
        hits = (fi >= p.index_select(0, ids)).sum(dtype=torch.int32)
        occ = (f >= p).sum(dtype=torch.float32)
    else:
        hits = torch.zeros((), dtype=torch.int32, device=f.device)
        occ = f.sum()
    return reward, hits, occ


def _make_ogb_step(sample: str, projection: str, sweeps: int, iters: int):
    """The per-chunk OGB_cl update with eta and capacity as 0-d tensors.

    Returns ``step(eta, p, cap, f, tau_prev, ids) -> (f', tau, (reward,
    hits, tau, occupancy))``; the chunk size B is read off ``ids``.
    """
    _check_sample(sample)
    if projection not in ("warm", "bisect"):
        raise ValueError(f"unknown projection mode {projection!r}")

    def step(eta, p, cap, f, tau_prev, ids):
        reward, hits, occ = sample_chunk_metrics(sample, f, ids, p)
        # The gradient step is y = f + eta * counts, formed inside the
        # kernels.  The reference adds eta once per duplicate id
        # (f.at[ids].add(eta)), so with duplicates y can differ by 1 ulp.
        counts = request_counts(ids, f.shape[0])
        if projection == "warm":
            hi = warm_bracket_hi(eta * float(ids.shape[0]))
            f_new, tau = capped_simplex_project_warm(
                f, counts, eta, cap, torch.zeros_like(tau_prev), hi, tau_prev, sweeps
            )
        else:
            f_new, tau = capped_simplex_project(f, counts, eta, cap, iters)
        return f_new, tau, (reward, hits, tau, occ)

    return step
