"""Named experiment scenarios: trace family x (N, T, C) x policy set.

Copied from ``repro.cachesim.scenarios``: the one registry that maps the
synthetic trace families of :mod:`repro_torch.cachesim.traces` to the paper
figures they reproduce (Figs. 2, 7, 8 and 11), each with a ``mini`` shape
(the golden fixtures), a ``quick`` shape and a ``full`` shape (the paper's
trace sizes).

:func:`run_scenario` drives a scenario's policy set through the one
execution layer (:func:`repro_torch.cachesim.api.run`) on the device:
``ogb``/``omd`` (fractional, replayed at the scenario batch size) and the
automata (replayed at the metric window): ``lru``/``lfu``/``ftpl`` on their
default tree engines, as in the reference, and ``fifo`` on the slot
automaton.  The tree LRU's ring is the reference's default unless a chunk
of ``window`` requests does not fit it: at ``full`` (a window of T/20 =
1e6 requests) the reference's default ring (262 144 positions at C =
50 000) raises, so the ring is doubled until the window fits; a ring's
size does not change the hits.  ``arc`` has no device engine, in the reference as here: it is the
host oracle, :func:`repro_torch.core.policies.make_policy` driven by
:func:`repro_torch.cachesim.simulator.simulate` on the host, included only
when the trace is short enough (``HOST_POLICY_MAX_T``).

The sized scenario (``sized_cdn``: per-item sizes from ``SIZE_SLABS`` by
popularity quartile) runs ``ogb_sized`` at the byte budget
(:meth:`Scenario.byte_capacity`), ``gds`` and the automata at C slots with
byte accounting, and adds each row's ``byte_hit_ratio`` (``byte_regret``
for ``ogb_sized``, against the fractional byte-optimal static allocation,
:func:`best_static_byte_hits`).

The edge-fleet scenarios (:class:`EdgeFleetScenario`: ``edge_fleet_cdn``)
hold the shape of a two-level CDN;
:func:`repro_torch.cachesim.fleet.run_edge_fleet_scenario` runs them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import api
from repro_torch.cachesim.tree_engines import ring_for_window
from repro_torch.cachesim.simulator import simulate
from repro_torch.cachesim.traces import make_trace
from repro_torch.core.policies import make_policy
from repro_torch.core.regret import best_static_hits

#: host (pure-Python) policies are only simulated up to this trace length
HOST_POLICY_MAX_T = 1_000_000

#: the standard comparison set (paper Figs. 2, 7, 8)
COMPARISON_POLICIES = ("ogb", "omd", "ftpl", "lru", "lfu", "fifo", "arc")

#: the sized scenarios' object sizes (bytes): dyadic slab classes, so every
#: byte sum is exact
SIZE_SLABS = (1.0, 4.0, 16.0, 64.0)

@dataclass(frozen=True)
class Scenario:
    """One named experiment configuration.

    ``trace_kw`` values may be callables ``(N, T) -> value`` for shape-derived
    parameters (e.g. the shifting-zipf phase length).
    """

    name: str
    figure: str  # paper figure this reproduces
    claim: str  # the headline the figure substantiates
    trace: str  # TRACE_REGISTRY key
    quick: Tuple[int, int]  # (N, T) at CI scale
    full: Tuple[int, int]  # (N, T) at paper scale
    cap_div: int  # C = max(N // cap_div, 1)
    policies: Tuple[str, ...] = COMPARISON_POLICIES
    trace_kw: Tuple[Tuple[str, Any], ...] = ()
    trace_seed: int = 0
    batch: int = 1000  # OGB / OMD update batch
    sized: bool = False  # heterogeneous object sizes (see make_sizes)

    def dims(self, scale: str = "quick") -> Tuple[int, int, int]:
        """(N, T, C) at the given scale ("mini", "quick" or "full").

        "mini" is the golden-fixture scale: tiny enough for tier-1 tests,
        derived from quick so it stays in the same regime.
        """
        if scale == "mini":
            n = max(self.quick[0] // 10, 4 * self.cap_div)
            return n, max(self.quick[1] // 10, 1000), max(n // self.cap_div, 1)
        if scale not in ("quick", "full"):
            raise ValueError(f"unknown scale {scale!r}")
        n, t = self.quick if scale == "quick" else self.full
        return n, t, max(n // self.cap_div, 1)

    def make_trace(self, scale: str = "quick") -> np.ndarray:
        n, t, _ = self.dims(scale)
        kw = {
            k: (v(n, t) if callable(v) else v) for k, v in self.trace_kw
        }
        return make_trace(self.trace, n, t, seed=self.trace_seed, **kw)

    def make_sizes(self, scale: str = "quick") -> Optional[np.ndarray]:
        """Per-item sizes for a sized scenario (None otherwise): the
        ``SIZE_SLABS`` by popularity-rank quartile, anti-correlated with
        popularity.  The zipf families emit ids in popularity order (id 0
        hottest), so the hot head gets the small slab and the long tail the
        large one: the CDN-like regime where object hits (cache the small
        hot head) and byte hits (spend bytes on the heavy tail) disagree."""
        if not self.sized:
            return None
        n, _, _ = self.dims(scale)
        k = len(SIZE_SLABS)
        slab = np.minimum((np.arange(n) * k) // n, k - 1)
        return np.asarray(SIZE_SLABS, np.float64)[slab]

    def byte_capacity(self, scale: str = "quick") -> Optional[int]:
        """Byte budget of the byte-capacity policies (``ogb_sized``): the slot
        policies hold C objects, so C * mean(sizes) is the bytes of the same
        slot count under a uniform object mix."""
        sizes = self.make_sizes(scale)
        if sizes is None:
            return None
        _, _, c = self.dims(scale)
        return max(int(round(c * float(sizes.mean()))), 1)


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario(
            name="fig2_adversarial",
            figure="Fig. 2",
            claim="recency/frequency policies collapse on the round-robin "
            "adversary while gradient policies track OPT = C/N",
            trace="adversarial",
            quick=(1_000, 60_000),
            full=(1_000, 1_000_000),
            cap_div=4,
            trace_seed=0,
            batch=500,
        ),
        Scenario(
            name="fig7_ms_ex",
            figure="Fig. 7 (left)",
            claim="shifting popularity (ms-ex): online policies must track "
            "the phase changes; OPT's windowed ratio is highly variable",
            trace="shifting_zipf",
            quick=(20_000, 200_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            trace_kw=(("alpha", 0.9), ("phase", lambda n, t: max(t // 8, 1))),
            trace_seed=3,
        ),
        Scenario(
            name="fig7_systor",
            figure="Fig. 7 (right)",
            claim="hot set + looping scans (systor/VDI): frequency beats "
            "recency; gradient policies are robust to the scans",
            trace="scan_mix",
            quick=(20_000, 200_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            trace_seed=4,
        ),
        Scenario(
            name="fig8_cdn",
            figure="Fig. 8 (left)",
            claim="near-stationary zipf (cdn): OPT >> LRU and the no-regret "
            "policies approach OPT",
            trace="zipf",
            quick=(20_000, 200_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            trace_kw=(("alpha", 0.9),),
            trace_seed=5,
        ),
        Scenario(
            name="fig8_twitter",
            figure="Fig. 8 (right)",
            claim="bursty short-lived items (twitter): LRU beats the static "
            "OPT; OGB stays robust; FTPL degenerates to noisy LFU",
            trace="bursty",
            quick=(20_000, 200_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            trace_kw=(
                ("burst_fraction", 0.5),
                ("burst_len_mean", 8.0),
                ("burst_span", 60),
            ),
            trace_seed=6,
        ),
        Scenario(
            name="sized_cdn",
            figure="§2.2 (heterogeneous sizes) / Fig. 8 (left)",
            claim="CDN objects are not unit-size: with slab sizes "
            "anti-correlated with popularity, byte hit ratio ranks the "
            "policies differently than object hit ratio — size-blind "
            "frequency policies cache the small hot head while the "
            "size-aware gradient policy spends its byte budget where the "
            "traffic volume is",
            trace="zipf",
            quick=(20_000, 200_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            policies=("ogb_sized", "gds", "lru", "lfu", "ftpl"),
            trace_kw=(("alpha", 0.9),),
            trace_seed=13,
            sized=True,
        ),
        Scenario(
            name="real_like_cdn",
            figure="Fig. 8 (left) / §5",
            claim="synthetic zipf-calibrated stand-in for a cdn-like "
            "workload: the tracelab synthesizer is fit to a generated "
            "source (not the paper's proprietary trace), preserving its "
            "popularity skew / reuse profile so the paper-scale comparison "
            "runs without shipping any dataset",
            trace="real_like",
            quick=(20_000, 200_000),
            full=(1_000_000, 10_000_000),
            cap_div=20,
            trace_kw=(("source", "zipf"), ("alpha", 0.9)),
            trace_seed=21,
        ),
        Scenario(
            name="real_like_twitter",
            figure="Fig. 8 (right) / §5",
            claim="stats-matched stand-in for the twitter trace: short-lived "
            "bursts survive the fit, so LRU still beats the static OPT and "
            "OGB stays robust at synthesized scale",
            trace="real_like",
            quick=(20_000, 200_000),
            full=(1_000_000, 10_000_000),
            cap_div=20,
            trace_kw=(
                ("source", "bursty"),
                ("burst_fraction", 0.5),
                ("burst_len_mean", 8.0),
                ("burst_span", 60),
            ),
            trace_seed=22,
        ),
        Scenario(
            name="fig11_cdn",
            figure="Fig. 11 / §B.2",
            claim="cdn items are long-lived: almost no attainable hits come "
            "from items with lifetime < 100 requests",
            trace="zipf",
            quick=(20_000, 150_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            policies=(),
            trace_kw=(("alpha", 0.9),),
            trace_seed=11,
        ),
        Scenario(
            name="fig11_twitter",
            figure="Fig. 11 / §B.2",
            claim="twitter gets ~20% of attainable hits from items with "
            "lifetime < 100 requests — the regime where recency wins",
            trace="bursty",
            quick=(20_000, 150_000),
            full=(1_000_000, 20_000_000),
            cap_div=20,
            policies=(),
            trace_seed=12,
        ),
    ]
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        )
    return SCENARIOS[name]


@dataclass(frozen=True)
class EdgeFleetScenario:
    """Two-level CDN scenario: E edge caches in front of one shared origin.

    Each edge serves its own stream (the same trace family, per-edge seed
    ``trace_seed + e``); the edge misses interleave (arrival position major,
    edge index minor) into the origin's request stream: the bipartite
    caching network of "Learning to Cache With No Regrets" collapsed to one
    shared parent, with the paper's no-regret policy at the origin.  The
    scenario holds only the shape; the replay is
    :func:`repro_torch.cachesim.fleet.run_edge_fleet` (this module stays
    below ``fleet``).
    """

    name: str
    figure: str
    claim: str
    trace: str
    quick: Tuple[int, int, int]  # (E, N, T_per_edge) at CI scale
    full: Tuple[int, int, int]
    edge_cap_div: int  # C_edge = max(N // edge_cap_div, 1)
    origin_cap_div: int  # C_origin = max(N // origin_cap_div, 1)
    edge_policy: str = "lru"
    origin_policy: str = "ogb"
    window: int = 500
    trace_kw: Tuple[Tuple[str, Any], ...] = ()
    trace_seed: int = 0

    def dims(self, scale: str = "quick") -> Tuple[int, int, int, int, int]:
        """(E, N, T_per_edge, C_edge, C_origin) at the given scale."""
        if scale == "mini":
            e0, n0, t0 = self.quick
            e = max(e0 // 8, 2)
            n = max(n0 // 10, 4 * self.edge_cap_div)
            t = max(t0 // 10, 4 * self.window)
        elif scale in ("quick", "full"):
            e, n, t = self.quick if scale == "quick" else self.full
        else:
            raise ValueError(f"unknown scale {scale!r}")
        return e, n, t, max(n // self.edge_cap_div, 1), max(n // self.origin_cap_div, 1)

    def make_edge_traces(self, scale: str = "quick") -> np.ndarray:
        """(E, T_per_edge) per-edge request streams (decorrelated seeds)."""
        e, n, t, _, _ = self.dims(scale)
        kw = {k: (v(n, t) if callable(v) else v) for k, v in self.trace_kw}
        return np.stack([make_trace(self.trace, n, t, seed=self.trace_seed + i, **kw)
                         for i in range(e)])


EDGE_FLEET_SCENARIOS: Dict[str, EdgeFleetScenario] = {
    s.name: s
    for s in [
        EdgeFleetScenario(
            name="edge_fleet_cdn",
            figure="ROADMAP north-star (fleet scale); PAPERS.md bipartite setting",
            claim=(
                "E per-edge LRU caches in front of one shared no-regret origin: the edges "
                "absorb each stream's hot head, and the gradient origin recovers tail hits "
                "from the miss interleave the edges cannot hold"
            ),
            trace="zipf",
            quick=(32, 4096, 25_000),
            full=(256, 100_000, 500_000),
            edge_cap_div=64,
            origin_cap_div=8,
            trace_kw=(("alpha", 0.8),),
            trace_seed=40,
        ),
    ]
}


def get_edge_fleet_scenario(name: str) -> EdgeFleetScenario:
    if name not in EDGE_FLEET_SCENARIOS:
        raise KeyError(f"unknown edge-fleet scenario {name!r}; have "
                       f"{sorted(EDGE_FLEET_SCENARIOS)}")
    return EDGE_FLEET_SCENARIOS[name]


@dataclass
class ScenarioResult:
    scenario: str
    scale: str
    N: int
    T: int
    C: int
    window: int
    rows: Dict[str, Dict[str, float]] = field(default_factory=dict)
    skipped: Tuple[str, ...] = ()

    def hit_ratio(self, policy: str) -> float:
        return self.rows[policy]["hit_ratio"]

    def byte_hit_ratio(self, policy: str) -> float:
        return self.rows[policy]["byte_hit_ratio"]

    def to_json(self) -> Dict:
        return {
            "scenario": self.scenario,
            "scale": self.scale,
            "N": self.N,
            "T": self.T,
            "C": self.C,
            "rows": self.rows,
            "skipped": list(self.skipped),
        }


def run_scenario(
    name: str,
    scale: str = "quick",
    policies: Optional[Sequence[str]] = None,
    seed: int = 0,
    window: Optional[int] = None,
    include_host: Optional[bool] = None,
    include_opt: bool = True,
    trace: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> ScenarioResult:
    """Run one scenario's policy set, every device engine on ``device``
    (the CUDA card unless ``"cpu"`` is asked for; raises without a card).

    Host-side (per-request Python) policies are skipped when the trace
    exceeds ``HOST_POLICY_MAX_T`` unless ``include_host=True`` forces them.
    Pass ``trace`` to reuse an already-generated trace (it must come from
    ``scenario.make_trace(scale)`` for the result to be meaningful), and
    ``include_opt=False`` to skip the host-side OPT(static) row.
    """
    sc = get_scenario(name)
    dev = resolve_device(device)
    n, t, c = sc.dims(scale)
    if trace is None:
        trace = sc.make_trace(scale)
    w = window or max(t // 20, 1)
    batch = min(sc.batch, max(t // 20, 1))
    if include_host is None:
        include_host = t <= HOST_POLICY_MAX_T
    sizes = sc.make_sizes(scale)
    cap_bytes = sc.byte_capacity(scale)

    res = ScenarioResult(scenario=name, scale=scale, N=n, T=t, C=c, window=w)
    skipped = []
    # hindsight OPT over the batch-aligned prefix, shared by the fractional
    # regret rows and the OPT(static) row (one O(T) pass, not one per row)
    t_opt = (len(trace) // batch) * batch if sc.policies else len(trace)
    opt_hits: Optional[float] = None

    def _opt() -> float:
        nonlocal opt_hits
        if opt_hits is None:
            opt_hits = float(best_static_hits(np.asarray(trace[:t_opt]), c))
        return opt_hits

    def _engine_def(kind):
        if kind not in api.policy_def_kinds():
            return None
        pd = api.policy_def(kind)
        return pd if pd.trace_driven else None

    sized_kw = {} if sizes is None else {"sizes": sizes}
    for kind in policies if policies is not None else sc.policies:
        pd = _engine_def(kind)
        if pd is not None and pd.fractional:
            # the byte-capacity policy (ogb_sized) takes the byte budget, the
            # unit-size ones the slot count
            cap = cap_bytes if (sizes is not None and kind == "ogb_sized") else c
            m = api.run(pd, trace, n, cap, window=batch, seed=seed, track_opt=False,
                        keep_carry=False, device=dev,
                        **(sized_kw if kind == "ogb_sized" else {}))
            row = {
                "hit_ratio": m.hit_ratio,
                "frac_hit_ratio": m.frac_hit_ratio,
                "us_per_request": m.us_per_request,
            }
            if sizes is None:
                row["regret"] = _opt() - float(m.reward.sum())
            else:
                # the sized reward is in bytes: regret against the fractional
                # byte-optimal static allocation
                row["byte_hit_ratio"] = m.byte_hit_ratio
                row["byte_regret"] = best_static_byte_hits(
                    np.asarray(trace[:t_opt]), sizes, float(cap_bytes)) - float(m.reward.sum())
            res.rows[m.name] = row
        elif pd is not None:
            ring = {"ring": ring_for_window(c, w)} if kind == "lru" else {}
            r = api.run(pd, trace, n, c, window=w, seed=seed, horizon=t, track_opt=False,
                        keep_carry=False, device=dev, **ring, **sized_kw)
            res.rows[r.name] = {"hit_ratio": r.hit_ratio, "us_per_request": r.us_per_request}
            if sizes is not None:
                res.rows[r.name]["byte_hit_ratio"] = r.byte_hit_ratio
        else:  # host-side oracle policies (arc, ...)
            if not include_host:
                skipped.append(kind)
                continue
            sr = simulate(make_policy(kind, n, c, **sized_kw), trace, window=w,
                          record_cum=False)
            res.rows[sr.name] = {"hit_ratio": sr.hit_ratio, "us_per_request": sr.us_per_request}
    if include_opt:
        res.rows["OPT(static)"] = {"hit_ratio": _opt() / max(t_opt, 1)}
        if sizes is not None:
            tr_opt = np.asarray(trace[:t_opt])
            req_bytes = float(np.sum(sizes[tr_opt]))
            res.rows["OPT(static)"]["byte_hit_ratio"] = (
                best_static_byte_hits(tr_opt, sizes, float(cap_bytes)) / max(req_bytes, 1.0))
    res.skipped = tuple(skipped)
    return res


def best_static_byte_hits(trace: np.ndarray, sizes: np.ndarray, cap_bytes: float) -> float:
    """The fractional byte-optimal static allocation's byte hits (hindsight).

    Maximize sum_i count_i * s_i * f_i subject to sum_i s_i * f_i <=
    cap_bytes, f in [0, 1]: every objective coefficient is count_i a byte
    allocated, so the greedy fill in request-count order (the last item
    fractional) is exact; the byte-weighted
    :func:`repro_torch.core.regret.best_static_hits`."""
    sizes = np.asarray(sizes, np.float64)
    cnt = np.bincount(np.asarray(trace), minlength=len(sizes)).astype(np.float64)
    order = np.argsort(-cnt, kind="stable")
    s_o, c_o = sizes[order], cnt[order]
    cum = np.cumsum(s_o)
    k = int(np.searchsorted(cum, cap_bytes, side="right"))
    byte_hits = float(np.sum(c_o[:k] * s_o[:k]))
    if k < len(s_o):
        rem = cap_bytes - (float(cum[k - 1]) if k else 0.0)
        byte_hits += float(c_o[k]) * max(rem, 0.0)
    return byte_hits
