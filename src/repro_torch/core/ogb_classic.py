"""OGB_cl — the classic online gradient-based caching policy (paper Eq. 2).

The Paschos et al. / Si Salem et al. policy: every B requests,

    f_t = Proj_F( f_{t-B} + eta * sum_{tau} grad phi_tau(f_{t-B}) )

with an *eager* O(N log N) capped-simplex projection, plus (integral setting)
Madow systematic sampling to select exactly C items.  This is the baseline the
paper improves on: per-request amortized cost Theta(N log N / B), versus OGB's
O(log N).  For B = 1 the two policies produce identical fractional states
(paper footnote 3) — that equality is tested against the port's
:class:`repro_torch.core.ogb.OGB`.

Copied from ``repro.core.ogb_classic``; the learning rate is the port's own
:func:`repro_torch.core.ogb.theoretical_eta`.
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from .ogb import theoretical_eta
from .projection import project_capped_simplex


class OGBClassic:
    """Eager-projection gradient policy, fractional or integral (Madow)."""

    name = "OGB_cl"
    __slots__ = ("N", "C", "B", "eta", "integral", "rng", "f", "_counts",
                 "_pending", "cached", "hits", "requests",
                 "fractional_reward", "replacements")

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
            eta = theoretical_eta(self.C, self.N, horizon, self.B)
        self.eta = float(eta)
        self.integral = integral
        self.rng = np.random.default_rng(seed)

        self.f = np.full(self.N, self.C / self.N, dtype=np.float64)
        self._counts = np.zeros(self.N, dtype=np.float64)
        self._pending = 0
        self.cached: Set[int] = set()
        self.hits = 0
        self.requests = 0
        self.fractional_reward = 0.0
        self.replacements = 0
        if integral:
            self._resample()

    # -- Madow systematic sampling: exactly C items with P(i in S) = f_i ----
    def _resample(self) -> None:
        cum = np.cumsum(self.f)
        u = self.rng.random()
        thresholds = u + np.arange(self.C)
        idx = np.searchsorted(cum, thresholds, side="left")
        idx = np.clip(idx, 0, self.N - 1)
        new_cache = set(int(i) for i in idx)
        self.replacements += len(new_cache - self.cached)
        self.cached = new_cache

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
        y = self.f + self.eta * self._counts
        self.f = project_capped_simplex(y, self.C)
        self._counts[:] = 0.0
        self._pending = 0
        if self.integral:
            self._resample()

    def occupancy(self) -> int:
        return len(self.cached)


def madow_sample(f: np.ndarray, C: int, rng: np.random.Generator) -> List[int]:
    """Standalone Madow systematic sampler (P(i in S) = f_i, |S| = C)."""
    cum = np.cumsum(np.asarray(f, dtype=np.float64))
    u = rng.random()
    idx = np.searchsorted(cum, u + np.arange(C), side="left")
    return [int(i) for i in np.clip(idx, 0, len(f) - 1)]
