"""FTPL — Follow The Perturbed Leader with one-shot initial noise.

Copied from ``repro.core.ftpl`` (numpy, host).  LFU counters n_i plus a
*single* initial Gaussian perturbation zeta*gamma_i; the cache holds the
top-C scores s_i = n_i + zeta*gamma_i (paper §2.2).  The initial cache is
the top-C of the noise over the whole catalog; ``np.argpartition`` fixes
its slot order, which is part of the automaton's carry, so the noise and
the initial slots are the reference's exactly.  The host class :class:`FTPL`
is the oracle the tests hold the automaton against.

zeta tuning for sublinear regret (Bhattacharjee et al., quoted in paper §2.2):
    zeta = (4*pi*log N)^(-1/4) * sqrt(T / C)
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .treap import make_store


def theoretical_zeta(C: int, N: int, T: int) -> float:
    return (4.0 * math.pi * math.log(max(N, 2))) ** -0.25 * math.sqrt(T / C)


def ftpl_noise(catalog_size: int, zeta: float, seed: int = 0) -> np.ndarray:
    """The one-shot Gaussian perturbation zeta * gamma, as float32.

    float32 on purpose: the device-resident scan engine
    (:mod:`repro_torch.cachesim.engines` and its
    slot-automaton kernel) computes scores ``count + noise`` in
    float32, and keeping the host policy on the identical grid makes the two
    implementations bit-exactly comparable (same IEEE single-precision adds).
    """
    rng = np.random.default_rng(seed)
    return (float(zeta) * rng.standard_normal(catalog_size)).astype(np.float32)


def ftpl_initial_top_c(noise: np.ndarray, capacity: int) -> np.ndarray:
    """Initial cache: top-C items of the noise alone (counts are all zero)."""
    n = noise.shape[0]
    return np.argpartition(noise, n - capacity)[n - capacity :].astype(np.int64)


class FTPL:
    name = "FTPL"
    __slots__ = ("N", "C", "zeta", "_noise", "_counts", "cached",
                 "_order", "hits", "requests")

    def __init__(
        self,
        catalog_size: int,
        capacity: int,
        zeta: Optional[float] = None,
        horizon: Optional[int] = None,
        seed: int = 0,
    ):
        self.N = int(catalog_size)
        self.C = int(capacity)
        if zeta is None:
            if horizon is None:
                raise ValueError("pass zeta or horizon")
            zeta = theoretical_zeta(self.C, self.N, horizon)
        self.zeta = float(zeta)
        # float32 noise + float32 score adds: bit-identical to the automaton
        self._noise = ftpl_noise(self.N, self.zeta, seed=seed)
        self._counts: Dict[int, int] = {}
        self.cached: Dict[int, float] = {}
        self._order = make_store("sorted", seed=seed)  # (score, item), cached only
        for i in ftpl_initial_top_c(self._noise, self.C):
            s = self._noise[i]
            self.cached[int(i)] = s
            self._order.insert(s, int(i))
        self.hits = 0
        self.requests = 0

    def _score(self, i: int) -> np.float32:
        # python int + np.float32 stays float32 (value-based casting): the
        # exact same IEEE add the automaton performs
        return self._counts.get(i, 0) + self._noise[i]

    def contains(self, i: int) -> bool:
        return i in self.cached

    def request(self, i: int) -> bool:
        hit = i in self.cached
        self.requests += 1
        self.hits += int(hit)
        self._counts[i] = self._counts.get(i, 0) + 1
        s = self._score(i)
        if hit:
            old = self.cached[i]
            self._order.remove(old, i)
            self._order.insert(s, i)
            self.cached[i] = s
        else:
            min_score, min_item = self._order.min()
            if s > min_score:
                self._order.pop_min()
                del self.cached[min_item]
                self.cached[i] = s
                self._order.insert(s, i)
        return hit

    def batch_end(self) -> None:  # interface parity
        pass

    def occupancy(self) -> int:
        return len(self.cached)
