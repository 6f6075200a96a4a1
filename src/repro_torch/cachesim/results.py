"""Host-side results of a replay, a sweep, a stream and a fleet, copied
from ``repro.cachesim.results``.

What a replay fills in: ``RunResult`` and the ``HitStatsMixin`` ratios,
byte hits for sized runs among them; what a sweep fills in:
``SweepResult``, one row a combo, looked up by :func:`find_combo`; what an
out-of-core stream fills in: ``StreamResult`` (a ``RunResult`` with the
dynamic-OPT windows and the ingest/device/host timing split); what a fleet
fills in: ``FleetResult``, a row a tenant, and ``EdgeFleetResult``, the
edges' fleet and the origin's stream.  The per-chunk arrays are numpy on
the host; the carries stay on the device they ran on.  A replay dispatched
with ``run(..., block=False)`` keeps its per-chunk outputs on the device
until :meth:`RunResult.consume`.
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
    # a run(..., block=False): the event recorded after its last chunk and
    # the host buffers its upload reads, kept alive until consume()
    pending: Any = field(default=None, repr=False, compare=False)

    def consume(self) -> "RunResult":
        """Wait for a ``run(..., block=False)`` and turn its per-chunk
        outputs into host arrays (the only place such a run blocks); a
        finished result is returned as it is."""
        if self.pending is None:
            return self
        event = self.pending[0]
        if event is not None:
            event.synchronize()
        self.reward = self.reward.cpu().numpy().astype(np.float64)
        self.hits = self.hits.cpu().numpy().astype(np.int64)
        self.aux = self.aux.cpu().numpy().astype(np.float64)
        self.occupancy = self.occupancy.cpu().numpy().astype(np.float64)
        if self.byte_hits is not None:
            self.byte_hits = self.byte_hits.cpu().numpy()
        self.pending = None
        return self

    @property
    def batch(self) -> int:
        return self.window

    @property
    def frac_reward(self) -> np.ndarray:
        return self.reward

    @property
    def taus(self) -> np.ndarray:
        return self.aux

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

    @property
    def integral_regret(self) -> float:
        return self.opt_hits - float(self.hits.sum())

    def windowed_hit_ratio(self, window: int) -> np.ndarray:
        """Hit ratio per non-overlapping window (rounded to whole chunks)."""
        per = max(window // self.window, 1)
        m = (len(self.hits) // per) * per
        if m == 0:
            return np.array([self.hit_ratio])
        return self.hits[:m].reshape(-1, per).sum(axis=1) / (per * self.window)

    def windowed_frac_ratio(self, window: int) -> np.ndarray:
        per = max(window // self.window, 1)
        m = (len(self.reward) // per) * per
        if m == 0:
            return np.array([self.frac_hit_ratio])
        return self.reward[:m].reshape(-1, per).sum(axis=1) / (per * self.window)


@dataclass
class StreamResult(RunResult):
    """A :class:`RunResult` accumulated out-of-core by
    :func:`repro_torch.cachesim.tracelab.stream.run_stream`.

    Per-chunk arrays are concatenated across stream segments (so every
    inherited windowed and ratio view works unchanged); on top of them the
    stream tracks the **time-varying OPT proxy**: ``dyn_opt_hits[k]`` is
    the hindsight-optimal static allocation recomputed for the ``k``-th
    ``dyn_opt_window``-request window alone (the final window may be a
    shorter remainder, :attr:`dyn_opt_lens`, so together the windows cover
    every replayed request).  Summed, that is the comparator of the
    *dynamic* regret (an adversary allowed to re-pick its cache every
    window), a harder bar than the static OPT in ``opt_hits``.

    **Timing split:** ``wall_seconds`` is the stream's total wall clock.
    ``ingest_seconds`` is time spent waiting on the chunk source,
    ``device_seconds`` dispatch plus time blocked on device results, and
    ``host_seconds`` the segment re-batching and dynamic-OPT accounting.
    On the synchronous path (``prefetch=0``) they sum to roughly
    ``wall_seconds``; on the pipeline they overlap, so their sum can exceed
    the wall clock.
    """

    dyn_opt_hits: Optional[np.ndarray] = None  # (K,) per-window OPT hits
    dyn_opt_window: int = 0  # requests per dynamic-OPT window (0 = off)
    n_segments: int = 0  # device dispatches the stream took
    t_dropped: int = 0  # trailing requests short of one window, not replayed
    ingest_seconds: float = 0.0  # time waiting on the chunk source
    device_seconds: float = 0.0  # dispatch + time blocked on device results
    host_seconds: float = 0.0  # re-batching + dynamic-OPT host accounting
    prefetch: int = 0  # pipeline depth the stream ran with (0 = synchronous)

    @property
    def dyn_opt_lens(self) -> np.ndarray:
        """Requests covered by each dynamic-OPT window: ``dyn_opt_window``
        each but the last, which covers the replayed remainder (so
        ``sum(dyn_opt_lens) == T``)."""
        if self.dyn_opt_hits is None:
            raise ValueError("run_stream(..., opt_window=...) was not set")
        k = len(self.dyn_opt_hits)
        lens = np.full(k, self.dyn_opt_window, np.int64)
        if k:
            lens[-1] = self.T - (k - 1) * self.dyn_opt_window
        return lens

    @property
    def dynamic_opt_total(self) -> float:
        """Total hits of the per-window re-optimized comparator."""
        if self.dyn_opt_hits is None:
            raise ValueError("run_stream(..., opt_window=...) was not set")
        return float(np.sum(self.dyn_opt_hits))

    @property
    def dynamic_regret(self) -> float:
        """Fractional-reward regret against the time-varying OPT proxy, over
        the prefix the dynamic windows cover (every replayed request)."""
        total = self.dynamic_opt_total  # raises cleanly when not tracked
        covered = int(self.dyn_opt_lens.sum())
        chunks = covered // max(self.window, 1)
        return total - float(self.reward[:chunks].sum())

    def dyn_opt_ratio(self) -> np.ndarray:
        """Per-window hit ratio of the time-varying OPT proxy."""
        lens = self.dyn_opt_lens  # raises cleanly when not tracked
        return self.dyn_opt_hits / np.maximum(lens, 1)


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


@dataclass
class FleetResult:
    """Host-side view of one multi-tenant fleet replay.

    E independent caches stepped in lockstep, a row a tenant: every
    per-chunk observable gains a leading tenant axis, so ``reward``,
    ``hits``, ``aux`` and ``occupancy`` are (E, M) and the scalar ratios
    aggregate over the whole fleet.  ``T`` is the number of requests
    replayed *per tenant*; ``carry`` is the list of the tenants' final
    carries, each of the kind's own type as its own run would have returned
    it: pass it back to ``run_fleet(carry=...)`` to resume every tenant in
    one call.
    """

    name: str
    kind: str
    n_tenants: int
    T: int  # requests replayed PER TENANT (num_chunks * window)
    window: int
    capacities: np.ndarray  # (E,)
    seeds: np.ndarray  # (E,) (-1 on resumed runs: seeds live in the carry)
    etas: Optional[np.ndarray]  # (E,) resolved per-tenant eta, fractional only
    reward: np.ndarray  # (E, M)
    hits: np.ndarray  # (E, M)
    aux: np.ndarray  # (E, M)
    occupancy: np.ndarray  # (E, M)
    opt_hits: np.ndarray  # (E,) per-tenant hindsight static OPT (0 if untracked)
    carry: Any = None  # (E,) list of the tenants' final carries (resumable)
    wall_seconds: float = 0.0
    byte_hits: Optional[np.ndarray] = None  # (E, M) sized runs only
    bytes_total: Optional[np.ndarray] = None  # (E,) bytes requested per tenant
    n_segments: int = 1  # dispatches (1 for in-memory run_fleet)
    t_dropped: int = 0  # unreplayed tail requests across the fleet (stream)
    prefetch: int = 0

    @property
    def total_requests(self) -> int:
        """Requests replayed across the whole fleet (E * T)."""
        return self.n_tenants * self.T

    @property
    def tenant_hit_ratios(self) -> np.ndarray:
        """(E,) integral hit ratio of each tenant."""
        return self.hits.sum(axis=1) / max(self.T, 1)

    @property
    def tenant_frac_ratios(self) -> np.ndarray:
        """(E,) fractional (OCO) reward ratio of each tenant."""
        return self.reward.sum(axis=1) / max(self.T, 1)

    @property
    def regrets(self) -> np.ndarray:
        """(E,) per-tenant hindsight regret of the fractional reward."""
        return self.opt_hits - self.reward.sum(axis=1)

    @property
    def hit_ratio(self) -> float:
        """Aggregate hit ratio over every request the fleet served."""
        return float(self.hits.sum()) / max(self.total_requests, 1)

    @property
    def hit_ratio_mean(self) -> float:
        return float(self.tenant_hit_ratios.mean())

    @property
    def hit_ratio_p5(self) -> float:
        """5th-percentile tenant hit ratio: the tail tenants SLOs live on."""
        return float(np.percentile(self.tenant_hit_ratios, 5.0))

    @property
    def hit_ratio_p95(self) -> float:
        return float(np.percentile(self.tenant_hit_ratios, 95.0))

    @property
    def byte_hit_ratio(self) -> float:
        """Fleet-aggregate byte hit ratio (object ratio when unsized)."""
        if self.byte_hits is None or self.bytes_total is None:
            return self.hit_ratio
        bt = float(np.sum(self.bytes_total))
        if bt <= 0.0:
            return self.hit_ratio
        return float(np.sum(self.byte_hits)) / bt

    @property
    def us_per_request(self) -> float:
        """Aggregate wall time a request across the fleet."""
        return 1e6 * self.wall_seconds / max(self.total_requests, 1)

    @property
    def requests_per_second(self) -> float:
        return self.total_requests / max(self.wall_seconds, 1e-12)


@dataclass
class EdgeFleetResult:
    """Two-level edge -> origin replay: E edge caches, one shared origin.

    ``edges`` is the fleet replay of the per-edge request streams;
    ``origin`` the streamed replay of the deterministic interleave of every
    edge miss (arrival position major, edge index minor).
    ``origin_requests`` counts every edge miss handed to the origin tier;
    the origin replays its window-aligned prefix of them (its ``T``).
    """

    edges: "FleetResult"
    origin: Any  # StreamResult of the origin cache over the miss stream
    origin_requests: int

    @property
    def edge_hit_ratio(self) -> float:
        return self.edges.hit_ratio

    @property
    def origin_hit_ratio(self) -> float:
        return self.origin.hit_ratio

    @property
    def end_to_end_hit_ratio(self) -> float:
        """Requests served by either tier over all edge-arriving requests."""
        total = self.edges.total_requests
        return float(self.edges.hits.sum() + self.origin.hits.sum()) / max(total, 1)
