"""OMD — no-regret caching via Online Mirror Descent (Si Salem et al. 2021).

Negative-entropy mirror map over the capped simplex F = {f in [0,1]^N :
sum f = C}.  Every B requests the log-weights take a gradient step and the
weights are Bregman(KL)-projected back onto F:

    w_t = w_{t-B} + eta * sum_tau grad phi_tau          (log-weight ascent)
    f_t = min(1, theta * exp(w_t)),  theta s.t. sum_i f_t,i = C   (KL proj.)

Copied from ``repro.core.omd``: the learning rate, the exact float64 KL
projection :func:`project_capped_simplex_kl` (water-filling: saturate the k
largest weights at 1 and scale the tail so the mass is C) and the host
policy :class:`OMDClassic`, the slow exact oracle.  The device step is
:func:`repro_torch.cachesim.engines._make_omd_step`.
"""

from __future__ import annotations

import math
from typing import Optional, Set

import numpy as np


def theoretical_eta_omd(C: int, N: int, T: int, B: int = 1) -> float:
    """Learning rate balancing the neg-entropy Bregman diameter C log(N/C)
    against the summed local-norm gradient bound (M chunks of B unit
    rewards, sum_i c_i^2 f_i <= B^2):

        regret <= C log(N/C)/eta + eta M B^2 / 2
        eta*   =  sqrt(2 C log(N/C) / (T B))

    which recovers Si Salem et al.'s O(sqrt(T C log(N/C))) regret rate.
    """
    log_ratio = max(math.log(N / max(C, 1)), 1e-12)
    return math.sqrt(2.0 * C * log_ratio / (T * B))


def project_capped_simplex_kl(
    w: np.ndarray, C: float, return_lam: bool = False
):
    """Exact KL (I-projection) of weights exp(w) onto {f in [0,1]^N: sum f = C}.

    Returns f with f_i = min(1, exp(w_i - lam)) where lam solves
    sum_i min(1, exp(w_i - lam)) = C.  Water-filling: with weights sorted in
    descending order and k coordinates saturated at 1,

        exp(-lam) = (C - k) / sum_{i > k} exp(w_i)

    and k is the unique count with exp(w_(k) - lam) >= 1 > exp(w_(k+1) - lam).
    Computed in float64 with a max-shift so exp never overflows.
    """
    w = np.asarray(w, dtype=np.float64)
    n = w.shape[0]
    if not (0 < C <= n):
        raise ValueError(f"need 0 < C <= N, got C={C}, N={n}")
    shift = float(np.max(w))
    y = np.exp(w - shift)  # descending relevance, max == 1
    order = np.argsort(-y, kind="stable")
    ys = y[order]
    # tail[k] = sum_{i > k} ys_i  (k coords saturated)
    tail = np.concatenate([[y.sum()], y.sum() - np.cumsum(ys)])
    ks = np.arange(0, int(min(C, n)))  # k < C (need C - k > 0)
    with np.errstate(divide="ignore"):
        theta = (C - ks) / tail[ks]  # candidate exp(shift - lam)
    # validity: theta * ys[k] < 1 (first unsaturated stays interior)
    #           and (k == 0 or theta * ys[k-1] >= 1)
    ok_hi = theta * ys[ks] < 1.0
    ok_lo = np.concatenate([[True], theta[1:] * ys[ks[1:] - 1] >= 1.0])
    valid = np.nonzero(ok_hi & ok_lo)[0]
    if len(valid) == 0:
        # C == n or total mass pushes everything to saturation
        k = int(min(C, n)) - 1
        th = (C - k) / max(tail[k], 1e-300)
    else:
        k = int(valid[0])
        th = theta[k]
    f = np.minimum(1.0, th * y)
    if return_lam:
        return f, shift - math.log(th)
    return f


class OMDClassic:
    """Host-side (float64 numpy) OMD policy — the slow exact oracle.

    Mirrors :class:`repro.core.ogb_classic.OGBClassic`'s interface: per-request
    ``request(i) -> hit`` with a batched update every ``batch_size`` requests,
    Madow systematic sampling in the integral setting.
    """

    name = "OMD"
    __slots__ = ("N", "C", "B", "eta", "integral", "rng", "w", "f",
                 "_counts", "_pending", "cached", "hits", "requests",
                 "fractional_reward")

    def __init__(
        self,
        catalog_size: int,
        capacity: int,
        eta: Optional[float] = None,
        horizon: Optional[int] = None,
        batch_size: int = 1,
        integral: bool = True,
        seed: int = 0,
    ):
        self.N = int(catalog_size)
        self.C = int(capacity)
        self.B = int(batch_size)
        if eta is None:
            if horizon is None:
                raise ValueError("pass eta or horizon")
            eta = theoretical_eta_omd(self.C, self.N, horizon, self.B)
        self.eta = float(eta)
        self.integral = integral
        self.rng = np.random.default_rng(seed)

        # normalized log-weights: f = min(1, exp(w)) is feasible at all times
        self.w = np.full(self.N, math.log(self.C / self.N), dtype=np.float64)
        self.f = np.full(self.N, self.C / self.N, dtype=np.float64)
        self._counts = np.zeros(self.N, dtype=np.float64)
        self._pending = 0
        self.cached: Set[int] = set()
        self.hits = 0
        self.requests = 0
        self.fractional_reward = 0.0
        if integral:
            self._resample()

    def _resample(self) -> None:
        cum = np.cumsum(self.f)
        u = self.rng.random()
        idx = np.searchsorted(cum, u + np.arange(self.C), side="left")
        self.cached = set(int(i) for i in np.clip(idx, 0, self.N - 1))

    def contains(self, i: int) -> bool:
        return i in self.cached

    def value(self, i: int) -> float:
        return float(self.f[i])

    def request(self, i: int) -> bool:
        hit = self.contains(i) if self.integral else False
        self.requests += 1
        self.hits += int(hit)
        self.fractional_reward += float(self.f[i])
        self._counts[i] += 1.0
        self._pending += 1
        if self._pending >= self.B:
            self.batch_end()
        return hit

    def batch_end(self) -> None:
        if self._pending == 0:
            return
        self.w = self.w + self.eta * self._counts
        self.f, lam = project_capped_simplex_kl(self.w, self.C, return_lam=True)
        self.w -= lam  # renormalize so f = min(1, exp(w)) without a threshold
        self._counts[:] = 0.0
        self._pending = 0
        if self.integral:
            self._resample()

    def occupancy(self) -> int:
        return len(self.cached)
