"""Size-aware OGB over the knapsack-relaxed feasible set (paper §8).

A copy of ``repro.core.ogb_sized`` (host side, float64 numpy, no JAX): the
float64 oracle of the sized OGB engines in
:mod:`repro_torch.cachesim.tree_engines` and :mod:`repro_torch.cachesim.api`.

Items have sizes s_i (bytes); the knapsack-relaxed feasible set is
F_s = {f in [0,1]^N : sum_i s_i f_i = C}.  The Euclidean projection becomes

    f_i = clip(y_i - s_i * tau, 0, 1)          (KKT of the weighted program)

so the uniform-subtraction trick generalizes *per size class*: group items
into K size classes (slab allocators quantize object sizes anyway); within
class k every interior coordinate is lowered by s_k * tau, so a per-class
accumulator rho_k = s_k * rho_base and a per-class ordered structure keep
the lazy O(log N) update: O(K log N) amortized per request.

The reward of a hit is proportional to the item's size (bytes served from
cache), the cost-aware setting w_{t,i} = s_i.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .treap import make_store


def weighted_capped_simplex_tau(
    y: np.ndarray, sizes: np.ndarray, C: float, iters: int = 100
) -> float:
    """Solve sum_i s_i * clip(y_i - s_i*tau, 0, 1) = C by bisection.

    Monotone in tau (each term non-increasing), so bisection is exact to
    2^-iters of the bracket."""
    y = np.asarray(y, np.float64)
    s = np.asarray(sizes, np.float64)
    if s.shape != y.shape:
        raise ValueError(f"sizes shape {s.shape} != y shape {y.shape}")
    if s.size == 0:
        raise ValueError("empty y/sizes")
    if not np.all(np.isfinite(s)) or float(np.min(s)) <= 0.0:
        raise ValueError(
            "sizes must be finite and > 0 (zero/negative sizes make the "
            f"max(y/s) bracket inf/NaN); got min={np.min(s)!r}"
        )
    if not np.isfinite(C) or C <= 0.0:
        raise ValueError(f"capacity C must be finite and > 0; got {C!r}")
    if not np.all(np.isfinite(y)):
        raise ValueError("y must be finite")
    lo = 0.0
    hi = float(np.max(y / s)) + 1.0

    def g(tau):
        return float(np.sum(s * np.clip(y - s * tau, 0.0, 1.0)))

    if g(0.0) <= C:
        return 0.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if g(mid) >= C:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def project_weighted(y: np.ndarray, sizes: np.ndarray, C: float) -> np.ndarray:
    tau = weighted_capped_simplex_tau(y, sizes, C)
    return np.clip(y - np.asarray(sizes, np.float64) * tau, 0.0, 1.0)


def size_classes(
    sizes: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize per-item sizes into at most ``k`` slab classes.

    Returns ``(class_sizes (K,), item_class (N,) int32)``.  Exact (every
    class size is an observed size) when there are <= k distinct sizes —
    realistic caches slab-quantize anyway; otherwise geometric bins over
    [min, max] with each class sized at the geometric mean of its members.
    Validates sizes finite and > 0 (the weighted projection divides by
    them)."""
    s = np.asarray(sizes, np.float64)
    if s.ndim != 1 or s.size == 0:
        raise ValueError(f"sizes must be a non-empty 1-d array: {s.shape}")
    if not np.all(np.isfinite(s)) or float(np.min(s)) <= 0.0:
        raise ValueError(
            f"sizes must be finite and > 0; got min={np.min(s)!r}"
        )
    if k < 1:
        raise ValueError(f"need k >= 1 size classes, got {k}")
    uniq = np.unique(s)
    if len(uniq) <= k:
        cls = np.searchsorted(uniq, s)
        return uniq, cls.astype(np.int32)
    edges = np.geomspace(uniq[0], uniq[-1], k + 1)
    cls = np.clip(np.searchsorted(edges, s, side="right") - 1, 0, k - 1)
    out = np.sqrt(edges[:-1] * edges[1:])  # empty classes keep bin centers
    for j in np.unique(cls):
        out[j] = float(np.exp(np.mean(np.log(s[cls == j]))))
    return out, cls.astype(np.int32)


class SizedOGB:
    """Lazy size-aware OGB over K size classes.

    State per class k: ordered structure z_k of unadjusted values, and the
    invariant f_i = f̃_i - s_k * R for active i in class k, where R is the
    global accumulated multiplier (sum of per-request tau's).
    """

    name = "SizedOGB"
    __slots__ = ("s", "K", "item_class", "C", "eta", "R", "f_tilde",
                 "z", "mass")

    def __init__(
        self,
        sizes_by_class: Sequence[float],  # size of each class (K,)
        item_class: Dict[int, int],  # item -> class index
        capacity: float,  # total bytes
        eta: float,
        seed: int = 0,
    ):
        self.s = [float(x) for x in sizes_by_class]
        if not self.s:
            raise ValueError("need at least one size class")
        if any(not math.isfinite(x) or x <= 0.0 for x in self.s):
            raise ValueError(f"class sizes must be finite and > 0: {self.s}")
        if not math.isfinite(capacity) or capacity <= 0.0:
            raise ValueError(f"capacity must be finite and > 0: {capacity!r}")
        self.K = len(self.s)
        self.item_class = dict(item_class)
        self.C = float(capacity)
        self.eta = float(eta)
        self.R = 0.0  # accumulated multiplier: f_i = f̃_i - s_k * R
        self.f_tilde: Dict[int, float] = {}
        self.z = [make_store("sorted", seed=seed + k) for k in range(self.K)]
        self.mass = 0.0  # current sum_i s_i f_i (maintained incrementally)

    def value(self, i: int) -> float:
        v = self.f_tilde.get(i)
        if v is None:
            return 0.0
        k = self.item_class[i]
        return min(max(v - self.s[k] * self.R, 0.0), 1.0)

    def fractional_vector(self, n: int) -> np.ndarray:
        f = np.zeros(n)
        for i in self.f_tilde:
            f[i] = self.value(i)
        return f

    # -- the lazy weighted projection -----------------------------------
    def update(self, j: int, weight: Optional[float] = None) -> None:
        """One request for item j; ascent step eta * w_j (default w = s_j)."""
        kj = self.item_class[j]
        sj = self.s[kj]
        w = sj if weight is None else weight
        step = self.eta * w

        fj_old = self.value(j)
        if fj_old >= 1.0 - 1e-12:
            return
        # raise coordinate j (clip the step so f_j <= 1: the one-clip case)
        step = min(step, 1.0 - fj_old)
        if j in self.f_tilde:
            self.z[kj].remove(self.f_tilde[j], j)
            self.f_tilde[j] += step
        else:
            self.f_tilde[j] = sj * self.R + step
        self.z[kj].insert(self.f_tilde[j], j)
        self.mass += sj * step
        if self.mass <= self.C + 1e-12:
            return

        # remove the excess: find dR with sum_k s_k^2 * m_k * dR = excess,
        # popping coordinates that hit zero (amortized O(1) pops/request)
        excess = self.mass - self.C
        while excess > 1e-15:
            denom = sum(
                (self.s[k] ** 2) * len(self.z[k]) for k in range(self.K)
            )
            if denom <= 0:
                # every coordinate was popped: the true mass is exactly 0
                # (clear the float drift the incremental counter carries so
                # ``mass <= C + tol`` holds on this exit path too)
                self.mass = 0.0
                excess = 0.0
                break
            dR = excess / denom
            # find the earliest-clipping coordinate across classes
            popped_any = False
            for k in range(self.K):
                while len(self.z[k]) > 0:
                    key, i = self.z[k].min()
                    val = key - self.s[k] * self.R
                    if val <= self.s[k] * dR + 1e-18:
                        # coordinate i hits zero before absorbing s_k*dR
                        self.z[k].pop_min()
                        del self.f_tilde[i]
                        excess -= self.s[k] * val
                        self.mass -= self.s[k] * val
                        popped_any = True
                    else:
                        break
            if popped_any:
                continue  # recompute denom with the survivors
            # no coordinate clips: apply the uniform multiplier and finish
            self.R += dR
            self.mass -= denom * dR
            excess = 0.0

    # convenience: byte hit ratio bookkeeping ---------------------------
    def fractional_byte_reward(self, i: int) -> float:
        k = self.item_class[i]
        return self.s[k] * self.value(i)
