"""OGB — the paper's online gradient-based caching policy (Algorithms 1-3).

A copy of ``repro.core.ogb`` (host policy, no JAX): the serving path's
page pool decides residency with it.

Faithful implementation of:

  * **UpdateProbabilities** (Algorithm 2): online gradient ascent step + lazy
    Euclidean projection onto F = {f in [0,1]^N : sum f = C}.  Instead of
    materializing f, we keep the *unadjusted* vector ``f̃`` (dict, active items
    only) and a global adjustment scalar ``rho`` with the invariant::

        f_i = f̃_i - rho     for i in the active set (f_i > 0)
        f_i = 0              otherwise

    plus an ordered structure ``z`` over the active ``f̃`` values so that the
    projection corner cases (coordinates hitting 0, the requested coordinate
    clipping at 1) cost O(log N) each and O(1) amortized per request.

  * **UpdateSample** (Algorithm 3): coordinated Poisson sampling with permanent
    random numbers p_i — item i is cached iff f_i >= p_i.  Because
    ``d_i = f̃_i - p_i`` is constant for cached-and-unrequested items, an
    ordered structure over d evicts exactly the items whose d_i fell below the
    advancing threshold rho.  E[x_t] = f_t (soft capacity constraint).

Complexity: O(log N) amortized per request for any batch size B >= 1.

Beyond-paper engineering (equivalence property-tested): ``lazy_init`` keeps the
untouched part of the catalog *implicit* (all untouched items share the same
unadjusted value f0 = C/N and a PRF-derived permanent random number), so memory
is O(C + #touched) instead of O(N) and startup is O(1).  The virgin group pops
out of the active set en masse when the shared value crosses zero.

The implementation is exact in float64: property tests check that the lazily
maintained f equals the eager projection oracle (:mod:`repro.core.projection`)
along arbitrary request sequences.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .treap import make_store


def theoretical_eta(C: int, N: int, T: int, B: int = 1) -> float:
    """Theorem 3.1 learning rate: eta = sqrt(C (1 - C/N) / (T B))."""
    return math.sqrt(C * (1.0 - C / N) / (T * B))


def theoretical_regret_bound(C: int, N: int, T: int, B: int = 1) -> float:
    """Theorem 3.1 regret bound: sqrt(C (1 - C/N) T B)."""
    return math.sqrt(C * (1.0 - C / N) * T * B)


@dataclass(slots=True)
class OGBStats:
    requests: int = 0
    hits: int = 0
    fractional_reward: float = 0.0
    zero_pops: int = 0  # coordinates driven to 0 by projections (paper Fig 9 right)
    pop_loop_rounds: int = 0
    one_clip_events: int = 0
    evictions: int = 0
    insertions: int = 0
    sample_updates: int = 0


class OGB:
    """The paper's O(log N) integral no-regret caching policy."""

    name = "OGB"

    __slots__ = (
        "N", "C", "B", "eta", "seed", "_rng", "redraw_period", "stats",
        "rho", "f_tilde", "z", "_f0", "lazy_init", "store_kind",
        "_touched", "_n_virgin",
        "p", "cached", "d", "_d_key", "_touched_sample", "rho_sample",
        "_batch",
    )

    def __init__(
        self,
        catalog_size: int,
        capacity: int,
        eta: Optional[float] = None,
        horizon: Optional[int] = None,
        batch_size: int = 1,
        store_kind: str = "sorted",
        lazy_init: bool = True,
        seed: int = 0,
        redraw_period: Optional[int] = None,
    ):
        if capacity <= 0 or capacity > catalog_size:
            raise ValueError("need 0 < C <= N")
        if redraw_period is not None and lazy_init:
            raise ValueError("redraw_period requires lazy_init=False")
        self.N = int(catalog_size)
        self.C = int(capacity)
        self.B = int(batch_size)
        if eta is None:
            if horizon is None:
                raise ValueError("pass eta or horizon (Theorem 3.1 tuning)")
            eta = theoretical_eta(self.C, self.N, horizon, self.B)
        self.eta = float(eta)
        self.seed = seed
        self._rng = random.Random(seed)
        self.redraw_period = redraw_period
        self.stats = OGBStats()

        # --- probability state (Algorithm 2) ---
        self.rho = 0.0
        self.f_tilde: Dict[int, float] = {}
        self.store_kind = store_kind
        self.z = make_store(store_kind, seed=seed + 1)
        self._f0 = self.C / self.N
        self.lazy_init = lazy_init
        self._touched: Set[int] = set()  # materialized-in-probability items
        self._n_virgin = self.N if lazy_init else 0

        # --- sample state (Algorithm 3) ---
        self.p: Dict[int, float] = {}
        self.cached: Set[int] = set()
        self.d = make_store(store_kind, seed=seed + 2)
        self._d_key: Dict[int, float] = {}
        self._touched_sample: Set[int] = set()  # items with explicit sample state
        self.rho_sample = 0.0  # rho snapshot at the last sample update
        self._batch: List[int] = []

        if not lazy_init:
            for i in range(self.N):
                self.f_tilde[i] = self._f0
                self.z.insert(self._f0, i)
            for i in range(self.N):  # initial Poisson sample over the catalog
                if self._perm_rand(i) <= self._f0:
                    self._admit(i, self.f_tilde[i])
                self._touched_sample.add(i)

    # ------------------------------------------------------------------
    # permanent random numbers (PRF-derived so lazy/eager modes agree)
    # ------------------------------------------------------------------
    def _perm_rand(self, i: int) -> float:
        pi = self.p.get(i)
        if pi is None:
            pi = random.Random((self.seed << 1) ^ (i * 0x9E3779B97F4A7C15)).random()
            self.p[i] = pi
        return pi

    # ------------------------------------------------------------------
    # fractional state accessors
    # ------------------------------------------------------------------
    def _is_virgin(self, i: int) -> bool:
        return self._n_virgin > 0 and i not in self._touched

    def _virgin_value(self) -> float:
        return self._f0 - self.rho

    def value(self, i: int) -> float:
        """Current fractional value f_i."""
        v = self.f_tilde.get(i)
        if v is not None:
            return min(v - self.rho, 1.0)
        if self._is_virgin(i):
            return self._virgin_value()
        return 0.0

    def fractional_vector(self) -> np.ndarray:
        """Materialize f (O(N)); for tests/small catalogs only."""
        f = np.zeros(self.N)
        if self._n_virgin > 0:
            vv = max(self._virgin_value(), 0.0)
            for i in range(self.N):
                if self._is_virgin(i):
                    f[i] = vv
        for i, v in self.f_tilde.items():
            f[i] = min(max(v - self.rho, 0.0), 1.0)
        return f

    # ------------------------------------------------------------------
    # Algorithm 2: UpdateProbabilities
    # ------------------------------------------------------------------
    def update_probabilities(self, j: int, weight: float = 1.0) -> None:
        """Process one request for item j (gradient step + lazy projection).

        ``weight`` implements the paper's general reward w_{t,j} (e.g. the
        retrieval cost of item j): the ascent step becomes eta * w_{t,j}.
        """
        f_tilde = self.f_tilde
        z = self.z
        rho = self.rho
        if self._n_virgin > 0:
            if self._f0 - rho <= 1e-15:
                self._n_virgin = 0  # the untouched group decayed to zero
            elif j not in self._touched:
                # materialize j out of the virgin group
                self._n_virgin -= 1
                f_tilde[j] = self._f0
                z.insert(self._f0, j)
        self._touched.add(j)

        ftj = f_tilde.get(j)
        fj_old = min(ftj - rho, 1.0) if ftj is not None else 0.0
        if fj_old >= 1.0 - 1e-12:
            return  # paper lines 1-2: saturated component, projection is identity

        step = self.eta * weight
        # gradient step on coordinate j
        if ftj is not None:
            z.remove(ftj, j)
            new_key = ftj + step
        else:
            new_key = rho + step  # f_j: 0 -> eta*w (unadjusted key)
        f_tilde[j] = new_key
        z.insert(new_key, j)

        # ---- zero-pop loop (paper lines 11-18) ----
        popped, tau, virgin_popped = self._zero_pop_loop(step)

        # ---- one-clip corner case (paper lines 19-24): can fire at most once ----
        if new_key - rho - tau > 1.0 + 1e-12:
            self.stats.one_clip_events += 1
            for key, i in popped:  # RestoreRemoved()
                z.insert(key, i)
            z.remove(new_key, j)
            popped, tau, virgin_popped = self._zero_pop_loop(1.0 - fj_old)
            rho += tau
            self.rho = rho
            f_tilde[j] = 1.0 + rho  # clipped at exactly 1
            z.insert(1.0 + rho, j)
        else:
            self.rho = rho + tau

        # commit: popped coordinates are now exactly 0
        for _key, i in popped:
            f_tilde.pop(i, None)
        self.stats.zero_pops += len(popped)
        if virgin_popped:
            self.stats.zero_pops += self._n_virgin
            self._n_virgin = 0

    def _zero_pop_loop(
        self, excess: float
    ) -> Tuple[List[Tuple[float, int]], float, bool]:
        """Uniform-redistribution fixed point with zero-clipping.

        Pops entries out of ``z`` (restorable via the returned list) but does
        NOT commit side effects: ``f_tilde`` deletion and virgin-group
        retirement happen in the caller so the one-clip path can roll back.

        Returns (popped entries, final per-coordinate subtraction tau,
        whether the implicit virgin group was popped).
        """
        popped: List[Tuple[float, int]] = []
        virgin_alive = self._n_virgin > 0
        n_virgin = self._n_virgin if virgin_alive else 0
        m = len(self.z) + n_virgin
        if m <= 0 or excess <= 0:
            return popped, 0.0, False
        tau = excess / m
        self.stats.pop_loop_rounds += 1
        while m > 1:
            zmin = self.z.min() if len(self.z) > 0 else None
            vvirgin = self._virgin_value() if n_virgin > 0 else math.inf
            use_virgin = n_virgin > 0 and (zmin is None or vvirgin <= zmin[0] - self.rho)
            min_val = vvirgin if use_virgin else (zmin[0] - self.rho)
            if min_val >= tau - 1e-18:
                break
            if use_virgin:
                if m - n_virgin <= 0:
                    break
                excess -= n_virgin * min_val
                m -= n_virgin
                n_virgin = 0
            else:
                key, i = self.z.pop_min()
                popped.append((key, i))
                excess -= key - self.rho
                m -= 1
            tau = excess / m
        virgin_popped = virgin_alive and n_virgin == 0
        return popped, tau, virgin_popped

    # ------------------------------------------------------------------
    # Algorithm 3: UpdateSample
    # ------------------------------------------------------------------
    def _admit(self, i: int, f_tilde_i: float) -> None:
        di = f_tilde_i - self._perm_rand(i)
        self.cached.add(i)
        self.d.insert(di, i)
        self._d_key[i] = di
        self.stats.insertions += 1

    def _update_sample_item(self, j: int) -> None:
        was_implicit = self._implicitly_cached(j)
        self._touched_sample.add(j)
        ftj = self.f_tilde.get(j)
        keep = ftj is not None and ftj - self.rho >= self._perm_rand(j)
        old = self._d_key.pop(j, None)  # cached <=> has a d entry
        if old is not None:
            self.d.remove(old, j)
            if keep:
                dj = ftj - self.p[j]
                self.d.insert(dj, j)
                self._d_key[j] = dj
            else:  # f_j dropped below p_j (or hit zero) during the batch
                self.cached.remove(j)
                self.stats.evictions += 1
        else:
            if keep:
                self._admit(j, ftj)
                if was_implicit:
                    self.stats.insertions -= 1  # it was already resident
            elif was_implicit:
                self.stats.evictions += 1

    def update_sample(self, requested: List[int]) -> None:
        """Resample the cache content (runs once every B requests)."""
        self.stats.sample_updates += 1
        for j in (requested if len(requested) <= 1 else set(requested)):
            self._update_sample_item(j)
        # evict every cached item whose difference fell below rho
        rho = self.rho
        d = self.d
        while len(d) > 0:
            dmin, i = d.min()
            if dmin >= rho:
                break
            d.pop_min()
            self._d_key.pop(i, None)
            self.cached.discard(i)
            self.stats.evictions += 1
        self.rho_sample = rho
        if (
            self.redraw_period is not None
            and self.stats.sample_updates % self.redraw_period == 0
        ):
            self._redraw_permanent_numbers()

    def _redraw_permanent_numbers(self) -> None:
        """Optional periodic redraw of p (paper §5.1). Requires eager init."""
        self.seed = self._rng.randrange(1 << 62)
        self.p.clear()
        self.d = make_store(self.store_kind, seed=self.seed + 2)
        self._d_key.clear()
        survivors: Set[int] = set()
        for i in list(self.cached):
            if i in self.f_tilde and self.f_tilde[i] - self.rho >= self._perm_rand(i):
                di = self.f_tilde[i] - self.p[i]
                self.d.insert(di, i)
                self._d_key[i] = di
                survivors.add(i)
        self.stats.evictions += len(self.cached) - len(survivors)
        self.cached = survivors

    # ------------------------------------------------------------------
    # cache-policy interface (used by the simulator / serving engine)
    # ------------------------------------------------------------------
    def _implicitly_cached(self, i: int) -> bool:
        """Virgin-at-last-sample items: cached iff p_i <= f0 - rho_sample."""
        if not self.lazy_init or i in self._touched_sample:
            return False
        thr = self._f0 - self.rho_sample
        return thr > 0 and self._perm_rand(i) <= thr

    def contains(self, i: int) -> bool:
        return i in self.cached or self._implicitly_cached(i)

    def request(self, i: int, weight: float = 1.0) -> bool:
        """Serve one request; returns integral hit/miss. Updates everything."""
        stats = self.stats
        hit = i in self.cached or self._implicitly_cached(i)
        stats.requests += 1
        if hit:
            stats.hits += 1
        v = self.value(i)
        if v > 0.0:
            stats.fractional_reward += weight * (v if v <= 1.0 else 1.0)
        self.update_probabilities(i, weight=weight)
        if self.B == 1:
            self.update_sample((i,))  # inlined single-item batch: no list churn
        else:
            self._batch.append(i)
            if len(self._batch) >= self.B:
                self.batch_end()
        return hit

    def batch_end(self) -> None:
        if self._batch:
            self.update_sample(self._batch)
            self._batch.clear()

    def occupancy(self, exact: bool = False) -> float:
        """Instantaneous cache occupancy.

        With ``lazy_init`` the implicit virgin population is counted by its
        Binomial mean unless ``exact=True`` (which is O(N - #touched))."""
        base = len(self.cached)
        if not self.lazy_init:
            return base
        thr = max(self._f0 - self.rho_sample, 0.0)
        if exact:
            extra = sum(
                1
                for i in range(self.N)
                if i not in self._touched_sample and self._perm_rand(i) <= thr
            )
            return base + extra
        n_virgin_sample = max(self.N - len(self._touched_sample), 0)
        return base + n_virgin_sample * thr

    # invariant checker used by tests -----------------------------------
    def check_invariants(self, atol: float = 1e-8) -> None:
        f = self.fractional_vector()
        assert abs(f.sum() - self.C) < atol * max(self.C, 1), (
            f"sum f = {f.sum()} != C = {self.C}"
        )
        assert (f >= -1e-12).all() and (f <= 1 + 1e-12).all()
        assert len(self.z) == len(self.f_tilde)
