"""Trace-driven host simulation, copied from ``repro.cachesim.simulator``.

Drives any policy implementing ``request(i) -> hit`` over a numpy trace and
records cumulative and windowed hit ratios and wall-clock throughput.  The
scenario harness runs its host oracle (ARC) through it, on the host as the
reference does; :func:`compare` runs several host policies over one trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cachesim.results import HitStatsMixin


@dataclass
class SimResult(HitStatsMixin):
    """Host-simulator result — shares the scalar-ratio implementations with
    the device-engine results (:mod:`repro_torch.cachesim.results`)."""

    name: str
    T: int
    hits: int
    cum_hits: np.ndarray  # cumulative hits at every request (int64)
    windowed: np.ndarray  # hit ratio per non-overlapping window
    window: int
    occupancy: List[float] = field(default_factory=list)
    wall_seconds: float = 0.0
    extras: Dict[str, float] = field(default_factory=dict)


def simulate(
    policy,
    trace: np.ndarray,
    window: int = 100_000,
    occupancy_every: Optional[int] = None,
    record_cum: bool = True,
) -> SimResult:
    T = len(trace)
    # the hot loop avoids all per-request numpy traffic: the trace becomes a
    # plain python list once (no per-step scalar boxing), per-request hit
    # flags land in a bytearray (C-speed stores), and cumulative sums are one
    # vectorized pass at the end
    ids = trace.tolist() if isinstance(trace, np.ndarray) else list(trace)
    hitbuf = bytearray(T)
    occ: List[float] = []
    req = policy.request
    t0 = time.perf_counter()
    if occupancy_every:
        pos = 0
        while pos < T:
            end = min(pos + occupancy_every, T)
            for t in range(pos, end):
                hitbuf[t] = req(ids[t])
            if end - pos == occupancy_every:
                occ.append(float(policy.occupancy()))
            pos = end
    else:
        t = 0
        for j in ids:
            hitbuf[t] = req(j)
            t += 1
    # flush a trailing partial batch so final state is consistent
    if hasattr(policy, "batch_end"):
        policy.batch_end()
    wall = time.perf_counter() - t0

    flags = np.frombuffer(hitbuf, dtype=np.uint8)  # zero-copy view, read-only use
    hits = int(flags.sum())
    cum = (
        np.cumsum(flags, dtype=np.int64)
        if record_cum
        else np.empty(0, dtype=np.int64)
    )

    n_win = max(T // window, 1)
    w = min(window, T)
    if T:
        boundary = np.cumsum(
            flags[: n_win * w].reshape(n_win, w).sum(axis=1, dtype=np.int64)
        )
        prev = np.concatenate([[0], boundary[:-1]])
        windowed = (boundary - prev) / w
    else:
        windowed = np.array([0.0])
    return SimResult(
        name=getattr(policy, "name", type(policy).__name__),
        T=T,
        hits=hits,
        cum_hits=cum,
        windowed=windowed,
        window=w,
        occupancy=occ,
        wall_seconds=wall,
    )


def compare(
    policies,
    trace: np.ndarray,
    window: int = 100_000,
    catalog_size: Optional[int] = None,
    capacity: Optional[int] = None,
    policy_kw: Optional[Dict[str, Dict]] = None,
    **kw,
) -> Dict[str, SimResult]:
    """Simulate several policies over one trace.

    ``policies`` is either a mapping ``{name: policy-object}`` or an iterable
    of kind strings resolved through the host registry
    (:data:`repro_torch.core.policies.POLICY_REGISTRY`): pass
    ``catalog_size`` and ``capacity`` then, and per-kind constructor
    keywords as ``policy_kw={"ogb": {"horizon": T}, ...}``.  Results are
    keyed by each policy's ``name``.
    """
    if not isinstance(policies, dict):
        from repro_torch.core.policies import make_policy

        if catalog_size is None or capacity is None:
            raise ValueError("kind-string comparison needs catalog_size and capacity")
        policy_kw = policy_kw or {}
        built = {}
        for kind in policies:
            p = make_policy(kind, catalog_size, capacity, **policy_kw.get(kind, {}))
            built[getattr(p, "name", kind)] = p
        policies = built
    return {name: simulate(p, trace, window=window, **kw) for name, p in policies.items()}
