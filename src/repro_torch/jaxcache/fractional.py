"""Batched fractional OGB_cl on PyTorch tensors: the data-plane form.

Counterpart of ``repro.jaxcache.fractional``.  Per batch of B requests over
a catalog of N items (paper Eq. 2 / §5.3):

    counts = histogram(request_ids)           # the summed gradient
    y      = f + eta * counts                 # ascent step
    tau    = root of sum(clip(y - tau, 0, 1)) = C     (capped-simplex proj.)
    f'     = clip(y - tau, 0, 1)

Unlike the reference, the projections here take ``(f, counts, eta)`` as the
kernels do and never store y: each bisection step is one launch of
:func:`repro_torch.kernels.capped_simplex.ops.masses` and its final clip one
:func:`~repro_torch.kernels.capped_simplex.ops.apply`; the warm projection's
whole solve and its final clip are one launch of
:func:`~repro_torch.kernels.capped_simplex.ops.project_warm`, f' written
from the y the solve keeps in registers.
Scalars stay 0-d tensors on the device, so a projection never waits on the
host.  :class:`FractionalState`, :func:`ogb_batch_update` (bisection),
:func:`ogb_batch_update_warm` and :func:`fractional_hit_ratio` are the
reference's data-plane step around those projections.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device

from repro_torch.kernels.capped_simplex.ops import (
    Scalar,
    apply,
    as_scalar,
    masses,
    project_warm,
)
from repro_torch.kernels.scatter_counts.ops import histogram

DEFAULT_BISECT_ITERS = 50
DEFAULT_WARM_SWEEPS = 5


def request_counts(ids: torch.Tensor, catalog_size: int) -> torch.Tensor:
    """Histogram of request ids: the batch gradient (one-hot sum)."""
    return histogram(ids, catalog_size)


def warm_bracket_hi(step_mass: torch.Tensor) -> torch.Tensor:
    """Upper bracket for the warm projection of y = f + (gradient step).

    ``step_mass`` is the total gradient mass added this step (eta * B for a
    B-request batch).  For a feasible pre-step f the threshold satisfies
    0 <= tau <= step_mass; the slack absorbs float32 rounding of the sums.
    """
    return step_mass.to(torch.float32) * (1.0 + 1e-5) + 1e-7


def capped_simplex_project(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: Scalar,
    capacity: Scalar,
    iters: int = DEFAULT_BISECT_ITERS,
    lo: Optional[Scalar] = None,
    hi: Optional[Scalar] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bisection projection of f + eta * counts onto the capped simplex.

    Returns (f', tau).  ``lo``/``hi`` override the cold bracket
    [min(y) - 1, max(y)].  Each of the ``iters`` steps is one mass pass.
    """
    dev = f.device
    eta = as_scalar(eta, dev)
    cap = as_scalar(capacity, dev)
    if lo is None or hi is None:
        y_min, y_max = torch.aminmax(f + eta * counts)
    lo = y_min - 1.0 if lo is None else as_scalar(lo, dev)
    hi = y_max if hi is None else as_scalar(hi, dev)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass, _cnt = masses(f, counts, eta, mid.reshape(1))
        too_much = mass[0] >= cap
        lo, hi = torch.where(too_much, mid, lo), torch.where(too_much, hi, mid)
    tau = 0.5 * (lo + hi)
    return apply(f, counts, eta, tau), tau


def capped_simplex_project_warm(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: Scalar,
    capacity: Scalar,
    lo: Scalar,
    hi: Scalar,
    tau0: Scalar,
    sweeps: int = DEFAULT_WARM_SWEEPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-started projection: bracketed Newton on the piecewise-linear g.

    g(tau) = sum(clip(y - tau, 0, 1)) is non-increasing with slope
    -#{i : 0 < y_i - tau < 1}.  Each sweep is one mass pass, then the
    bracket shrinks and the Newton point ``tau + (g - C) / count`` is taken
    if it has a count and lies in the bracket, else the midpoint; on the
    card all ``sweeps`` and the final clip are one :func:`project_warm`
    launch, f' written in its epilogue.  Requires g(lo) >= C >= g(hi); for
    an OGB step lo = 0, hi = warm_bracket_hi(eta * B) always holds, and
    ``tau0`` = the previous step's tau is a good seed.

    The safeguard is the reference's: it accepts a Newton point equal to an
    end of the bracket, so, as in ``repro``, the iterate can alternate
    between the two ends on some instances and stop at an infeasible tau.
    """
    return project_warm(f, counts, eta, capacity, lo, hi, tau0, sweeps)


class FractionalState(NamedTuple):
    """Catalog-wide fractional cache state (the data-plane state)."""

    f: torch.Tensor  # (N,) float32, in the capped simplex
    step: torch.Tensor  # () int32

    @staticmethod
    def create(catalog_size: int, capacity: int, device: DeviceLike = None) -> "FractionalState":
        """f = C / N everywhere, on ``device`` (the card unless "cpu")."""
        dev = resolve_device(device)
        return FractionalState(
            f=torch.full((catalog_size,), capacity / catalog_size, dtype=torch.float32,
                         device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )


def ogb_batch_update(
    state: FractionalState,
    request_ids: torch.Tensor,
    eta: Scalar,
    capacity: int,
    iters: int = DEFAULT_BISECT_ITERS,
) -> Tuple[FractionalState, torch.Tensor]:
    """One batched OGB_cl step by bisection: (new_state, fractional_reward).

    The reward is sum_t f[r_t] at the pre-update state (OCO order); the
    counts are one histogram launch and each bisection step one mass pass
    (:func:`capped_simplex_project`).  ``request_ids`` are int32 on f's
    device."""
    f = state.f
    reward = f.index_select(0, request_ids).sum()
    counts = request_counts(request_ids, f.shape[0])
    f_new, _tau = capped_simplex_project(f, counts, eta, float(capacity), iters)
    return FractionalState(f=f_new, step=state.step + 1), reward


def ogb_batch_update_warm(
    state: FractionalState,
    request_ids: torch.Tensor,
    eta: Scalar,
    capacity: int,
    tau_prev: Scalar,
    sweeps: int = DEFAULT_WARM_SWEEPS,
) -> Tuple[FractionalState, torch.Tensor, torch.Tensor]:
    """:func:`ogb_batch_update` with the warm projection (one
    :func:`project_warm` launch on the card): (new_state, reward, tau).

    ``state.f`` is feasible, so the new threshold lies in [0, eta * B], the
    warm bracket; thread the returned tau into the next step."""
    f = state.f
    eta_t = as_scalar(eta, f.device)
    reward = f.index_select(0, request_ids).sum()
    counts = request_counts(request_ids, f.shape[0])
    hi = warm_bracket_hi(eta_t * float(request_ids.shape[0]))
    f_new, tau = capped_simplex_project_warm(
        f, counts, eta_t, float(capacity), torch.zeros_like(eta_t), hi,
        as_scalar(tau_prev, f.device), sweeps,
    )
    return FractionalState(f=f_new, step=state.step + 1), reward, tau


def fractional_hit_ratio(state: FractionalState, request_ids: torch.Tensor) -> torch.Tensor:
    """Mean fractional value of the requested items: a 0-d tensor."""
    return state.f.index_select(0, request_ids).mean()


def poisson_sample(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Coordinated Poisson sample: x_i = (f_i >= p_i); E[sum x] = C."""
    return f >= p


def madow_sample(f: torch.Tensor, u: torch.Tensor, capacity: int) -> torch.Tensor:
    """Madow systematic sampling: a bool mask of exactly C items, P(i) = f_i.

    Item i is selected iff one of the C thresholds u, u + 1, ..., u + C - 1
    falls in (cum[i-1], cum[i]].  Where sum(f) is exactly C this is the
    reference's sample (``repro.jaxcache.fractional.madow_sample_jax``).
    A projection leaves sum(f) within float32 rounding of C, and three
    things keep the count at C all the same:

    * the prefix sums and thresholds are float64, so an item with f_i = 1
      spans one threshold, never two, and the card selects what the CPU
      selects (its scan adds in another order);
    * only the C thresholds count (the reference takes a (C+1)-th where
      sum(f) exceeds C + u), and the last prefix sum is raised to C where
      sum(f) falls short of it, so the last threshold lands in the last
      item's interval;
    * u = 0 counts as u = 1 (threshold 0 lies in no interval (a, b]).
    """
    cap = float(capacity)
    cum = torch.cumsum(f, dim=0, dtype=torch.float64)
    cum[-1:] = torch.clamp(cum[-1:], min=cap)
    lower = torch.cat([torch.zeros(1, dtype=torch.float64, device=f.device), cum[:-1]])
    u = torch.where(u > 0, u, torch.ones_like(u)).to(torch.float64)

    def taken(x):
        # how many of the thresholds u + k, 0 <= k < C, are <= x
        return torch.clamp(torch.floor(x - u) + 1.0, 0.0, cap)

    return (taken(cum) - taken(lower)) >= 1.0


def permanent_random_numbers(
    seed: int, catalog_size: int, device: torch.device
) -> torch.Tensor:
    """The p_i of §5.1: uniform [0, 1) float32, drawn once from ``seed``.

    Same distribution as the reference's, different bits (a
    ``torch.Generator``, not JAX's threefry).  They are drawn on the CPU and
    moved, so one seed gives the same p on every device.
    """
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand(catalog_size, generator=gen, dtype=torch.float32).to(device)
