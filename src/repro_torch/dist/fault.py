"""Fault handling for long-running launches: straggler + heartbeat tracking.

Counterpart of ``repro.dist.fault``, plain Python as the reference is.
The training loop is synchronous (one step is one barrier), so a single
slow host stretches every step.  :class:`StragglerMonitor` keeps an
exponential moving average of step wall-time and flags steps that exceed
``straggler_factor`` x the baseline; the accounting (count, excess seconds)
is what a fleet controller uses to decide when re-scheduling a host is
cheaper than riding out the slowdown.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FaultConfig:
    """Knobs for straggler detection and liveness timeouts."""

    straggler_factor: float = 2.5  # step is a straggler above factor * EWMA
    warmup_steps: int = 5  # compile/first-touch steps never flagged
    ewma_alpha: float = 0.1  # baseline smoothing (per observed step)
    heartbeat_timeout_s: float = 300.0  # liveness: max silence between beats
    max_consecutive_stragglers: int = 10  # sustained slowdown => reschedule

    def __post_init__(self):
        if self.straggler_factor <= 1.0:
            raise ValueError("straggler_factor must exceed 1.0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")


class StragglerMonitor:
    """EWMA-based step-time watchdog with excess-time accounting."""

    def __init__(self, config: Optional[FaultConfig] = None):
        self.config = config or FaultConfig()
        self.baseline_s: Optional[float] = None  # EWMA of non-straggler steps
        self.n_observed = 0
        self.n_stragglers = 0
        self.consecutive_stragglers = 0
        self.excess_s = 0.0  # total time above the straggler threshold
        self.last_flagged_step: Optional[int] = None
        self._last_heartbeat: Optional[float] = None

    def observe(self, step: int, duration_s: float) -> bool:
        """Record one step's wall time; returns True if it straggled.

        Straggler steps do NOT update the baseline — a run of slow steps
        must not normalize the slowdown away.
        """
        self.n_observed += 1
        self._last_heartbeat = time.monotonic()
        cfg = self.config
        in_warmup = self.n_observed <= cfg.warmup_steps
        threshold = (
            None if self.baseline_s is None else cfg.straggler_factor * self.baseline_s
        )
        straggled = (
            not in_warmup and threshold is not None and duration_s > threshold
        )
        if straggled:
            self.n_stragglers += 1
            self.consecutive_stragglers += 1
            self.excess_s += duration_s - threshold
            self.last_flagged_step = step
        else:
            self.consecutive_stragglers = 0
            # warmup steps (compile, first touch — routinely 100x steady
            # state) must not seed the baseline, or the inflated threshold
            # masks real stragglers for ~1/ewma_alpha steps afterwards
            if in_warmup:
                return False
            if self.baseline_s is None:
                self.baseline_s = float(duration_s)
            else:
                a = cfg.ewma_alpha
                self.baseline_s = (1 - a) * self.baseline_s + a * float(duration_s)
        return straggled

    def heartbeat(self) -> None:
        """Record liveness outside the step loop (data stalls, checkpoints)."""
        self._last_heartbeat = time.monotonic()

    def seconds_since_heartbeat(self) -> Optional[float]:
        if self._last_heartbeat is None:
            return None
        return time.monotonic() - self._last_heartbeat

    def heartbeat_expired(self) -> bool:
        since = self.seconds_since_heartbeat()
        return since is not None and since > self.config.heartbeat_timeout_s

    def should_reschedule(self) -> bool:
        """Sustained slowdown: the host is sick, not momentarily noisy."""
        return self.consecutive_stragglers >= self.config.max_consecutive_stragglers

    @property
    def straggler_ratio(self) -> float:
        return self.n_stragglers / max(self.n_observed, 1)
