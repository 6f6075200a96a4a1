"""Synthetic request traces, copied from ``repro.cachesim.traces``.

Only the generator the port drives so far: the stationary Zipf trace, the
paper's ``cdn`` regime.  It returns ``np.ndarray[int64]`` of item ids in
``[0, N)``, the same ids as the reference for the same seed.
"""

from __future__ import annotations

import numpy as np


def _zipf_weights(n: int, alpha: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return w / w.sum()


def zipf(N: int, T: int, alpha: float = 0.8, seed: int = 0) -> np.ndarray:
    """Stationary Zipf(alpha) — cdn-like."""
    rng = np.random.default_rng(seed)
    w = _zipf_weights(N, alpha)
    return rng.choice(N, size=T, p=w).astype(np.int64)


TRACE_REGISTRY = {
    "zipf": zipf,
    "cdn_like": zipf,
}


def make_trace(kind: str, N: int, T: int, seed: int = 0, **kw) -> np.ndarray:
    return TRACE_REGISTRY[kind](N, T, seed=seed, **kw)
