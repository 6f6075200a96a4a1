"""Euclidean projection onto the capped simplex F = {f in [0,1]^N : sum f = C}.

Copied from ``repro.core.projection``: the float64 numpy oracle that the
port's projections (``jaxcache.fractional``, ``kernels.capped_simplex``) and
the classic OGB_cl (:mod:`.ogb_classic`) are held against.

The projection of y solves (paper Eq. 3):

    min_f 1/2 ||f - y||^2   s.t.  0 <= f_i <= 1,  sum_i f_i = C

KKT: the unique solution is  f_i = clip(y_i - tau, 0, 1)  where tau solves
``g(tau) = sum_i clip(y_i - tau, 0, 1) = C``.  ``g`` is non-increasing and
piecewise linear with breakpoints at {y_i} and {y_i - 1}; the segment
containing C is located exactly in O(N log N) and interpolated, with no
iterative tolerance.
"""

from __future__ import annotations

import numpy as np


def capped_simplex_tau(y: np.ndarray, C: float) -> float:
    """Exact threshold tau with sum(clip(y - tau, 0, 1)) == C.

    Requires 0 < C <= N.  Exact up to float64 rounding (sort + prefix sums).
    """
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    if not (0 < C <= n):
        raise ValueError(f"need 0 < C <= N, got C={C}, N={n}")

    # breakpoints where a coordinate enters/leaves the interior regime
    bp = np.concatenate([y, y - 1.0])
    bp.sort(kind="stable")

    ys = np.sort(y, kind="stable")
    prefix = np.concatenate([[0.0], np.cumsum(ys)])  # prefix[k] = sum of k smallest

    def g(tau: float) -> float:
        # #{y_i >= tau + 1} (saturated at 1) + sum over interior of (y_i - tau)
        hi = np.searchsorted(ys, tau + 1.0, side="left")  # first idx with y >= tau+1
        lo = np.searchsorted(ys, tau, side="right")  # first idx with y > tau
        n_sat = n - hi
        interior_sum = prefix[hi] - prefix[lo]
        n_int = hi - lo
        return n_sat + interior_sum - n_int * tau

    # g is non-increasing in tau. Find the breakpoint segment where g crosses C.
    # Evaluate g at all breakpoints via vectorized searchsorted.
    taus = bp
    hi = np.searchsorted(ys, taus + 1.0, side="left")
    lo = np.searchsorted(ys, taus, side="right")
    g_vals = (n - hi) + (prefix[hi] - prefix[lo]) - (hi - lo) * taus

    # locate the last breakpoint with g(tau) >= C (g_vals non-increasing)
    idx = int(np.searchsorted(-g_vals, -float(C), side="right")) - 1
    if idx < 0:
        # C >= g(smallest breakpoint) = n: every coordinate saturates
        return float(bp[0])

    tau_a = float(taus[idx])
    g_a = float(g_vals[idx])
    if g_a == C:
        return tau_a
    # slope on the *open segment to the right* of tau_a is -#interior there:
    # interior = {i : tau_a < y_i <= tau_a + 1} (membership constant on the
    # segment because breakpoints are exactly the transition points)
    lo_a = int(np.searchsorted(ys, tau_a, side="right"))
    hi_a = int(np.searchsorted(ys, tau_a + 1.0, side="right"))
    n_int = hi_a - lo_a
    if n_int > 0:
        tau = tau_a + (g_a - C) / n_int
        if abs(g(tau) - C) < 1e-9 * max(1.0, C):
            return tau
    # fp-robust fallback: bisect within [tau_a, next breakpoint]
    lo_t = tau_a
    hi_t = float(taus[idx + 1]) if idx + 1 < len(taus) else tau_a + 1.0
    for _ in range(100):
        mid = 0.5 * (lo_t + hi_t)
        if g(mid) >= C:
            lo_t = mid
        else:
            hi_t = mid
    return 0.5 * (lo_t + hi_t)


def project_capped_simplex(y: np.ndarray, C: float) -> np.ndarray:
    """Exact Euclidean projection of y onto {f in [0,1]^N : sum f = C}."""
    tau = capped_simplex_tau(y, C)
    return np.clip(np.asarray(y, dtype=np.float64) - tau, 0.0, 1.0)


def capped_simplex_tau_bisect(
    y: np.ndarray, C: float, iters: int = 100
) -> float:
    """Bisection solver for tau — the form that vectorizes on a device.

    Mirrors the bisection of the port's projections:
    tau in [min(y) - 1, max(y)] and ``g`` is monotone, so ``iters`` bisection
    steps give ~2^-iters * range accuracy.
    """
    y = np.asarray(y, dtype=np.float64)
    lo = float(np.min(y)) - 1.0
    hi = float(np.max(y))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if np.clip(y - mid, 0.0, 1.0).sum() >= C:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
