"""Hindsight static OPT, copied from ``repro.core.regret`` (host numpy)."""

from __future__ import annotations

import numpy as np


def best_static_hits(trace: np.ndarray, C: int) -> int:
    """Total hits of OPT (top-C items of the whole trace)."""
    counts = np.bincount(trace)
    if len(counts) <= C:
        return int(counts.sum())
    top = np.partition(counts, len(counts) - C)[len(counts) - C :]
    return int(top.sum())
