"""Host-side results of a replay and of a sweep, copied from
``repro.cachesim.results``.

What a replay fills in: ``RunResult`` and the ``HitStatsMixin`` ratios,
byte hits for sized runs among them; what a sweep fills in:
``SweepResult``, one row a combo, looked up by :func:`find_combo`.  The
per-chunk arrays are numpy on the host; the carries stay on the device they
ran on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def find_combo(combos: "List[Dict[str, float]]", **match) -> int:
    """Row index of the sweep combo matching all given key/values."""
    for r, combo in enumerate(combos):
        if all(combo.get(k) == v for k, v in match.items()):
            return r
    raise KeyError(f"no combo matching {match}")


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


@dataclass
class SweepResult:
    """Replays over a parameter grid, one row a combo.

    ``combos[r]`` names row ``r``: always ``capacity`` and ``seed``, plus
    ``eta`` for the fractional policies; :meth:`row` looks rows up by any
    subset of those keys.  ``carries[r]`` is row r's final carry, of the
    policy's own type, as :func:`repro_torch.cachesim.api.run` would have
    returned it.
    """

    kind: str
    combos: List[Dict[str, float]]
    T: int
    window: int
    reward: np.ndarray  # (R, M)
    hits: np.ndarray  # (R, M)
    aux: np.ndarray  # (R, M)
    occupancy: np.ndarray  # (R, M)
    opt_hits: np.ndarray  # (R,) hindsight static-OPT per combo (host-side)
    wall_seconds: float = 0.0
    byte_hits: Optional[np.ndarray] = None  # (R, M) per-chunk byte hits
    bytes_total: float = 0.0  # total bytes requested (sized runs, else 0)
    carries: Optional[List[Any]] = None  # (R,) final carries

    @property
    def batch(self) -> int:
        return self.window

    @property
    def byte_hit_ratios(self) -> np.ndarray:
        """Per-combo byte hit ratio (falls back to object ratio unsized)."""
        if self.byte_hits is None or self.bytes_total <= 0.0:
            return self.hit_ratios
        return self.byte_hits.sum(axis=1) / self.bytes_total

    @property
    def frac_reward(self) -> np.ndarray:
        return self.reward

    @property
    def taus(self) -> np.ndarray:
        return self.aux

    @property
    def hit_ratios(self) -> np.ndarray:
        return self.hits.sum(axis=1) / max(self.T, 1)

    @property
    def frac_hit_ratios(self) -> np.ndarray:
        return self.reward.sum(axis=1) / max(self.T, 1)

    @property
    def regrets(self) -> np.ndarray:
        return self.opt_hits - self.reward.sum(axis=1)

    def row(self, **match) -> int:
        return find_combo(self.combos, **match)
