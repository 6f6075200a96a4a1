"""The paper's learning rate, copied from ``repro.core.ogb``."""

from __future__ import annotations

import math


def theoretical_eta(C: int, N: int, T: int, B: int = 1) -> float:
    """Theorem 3.1 learning rate: eta = sqrt(C (1 - C/N) / (T B))."""
    return math.sqrt(C * (1.0 - C / N) / (T * B))
