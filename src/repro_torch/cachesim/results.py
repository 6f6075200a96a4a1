"""Host-side result of one replay, copied from ``repro.cachesim.results``.

What a replay fills in: ``RunResult`` and the ``HitStatsMixin`` ratios,
byte hits for sized runs among them.  The per-chunk arrays are numpy on the host; the
carry stays on the device it ran on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


class HitStatsMixin:
    """The one implementation of the scalar throughput/quality ratios."""

    @property
    def hit_ratio(self) -> float:
        return float(np.sum(self.hits)) / max(self.T, 1)

    @property
    def byte_hit_ratio(self) -> float:
        """Bytes served from cache over bytes requested (sized runs); the
        object hit ratio for an unsized run (every object one byte)."""
        bh = getattr(self, "byte_hits", None)
        bt = float(getattr(self, "bytes_total", 0.0) or 0.0)
        if bh is None or bt <= 0.0:
            return self.hit_ratio
        return float(np.sum(bh)) / bt

    @property
    def us_per_request(self) -> float:
        return 1e6 * self.wall_seconds / max(self.T, 1)


@dataclass
class RunResult(HitStatsMixin):
    """Host-side view of one policy replay (single final fetch).

    ``carry`` is the final carry, on the device the replay ran on: pass it
    back to :func:`repro_torch.cachesim.api.run` to resume on the next
    trace chunk.
    """

    name: str
    kind: str
    T: int  # requests actually replayed (num_chunks * window)
    window: int  # requests per chunk (the OGB update batch B)
    capacity: int
    reward: np.ndarray  # (M,) per-chunk fractional reward
    hits: np.ndarray  # (M,) per-chunk integral hits
    aux: np.ndarray  # (M,) per-chunk projection threshold tau
    occupancy: np.ndarray  # (M,) per-chunk cached mass / item count
    opt_hits: float = 0.0  # hindsight static-OPT reward over the replayed prefix
    carry: Any = None  # final carry (resumable)
    wall_seconds: float = 0.0
    extras: Dict[str, float] = field(default_factory=dict)
    byte_hits: Optional[np.ndarray] = None  # (M,) per-chunk byte hits, float64 (sized)
    bytes_total: float = 0.0  # bytes requested (sized runs, else 0)

    @property
    def final_f(self) -> Optional[np.ndarray]:
        f = getattr(self.carry, "f", None)
        return None if f is None else f.detach().cpu().numpy()

    @property
    def frac_hit_ratio(self) -> float:
        return float(self.reward.sum()) / max(self.T, 1)

    @property
    def regret(self) -> float:
        """Hindsight regret of the fractional (OCO) reward."""
        return self.opt_hits - float(self.reward.sum())
