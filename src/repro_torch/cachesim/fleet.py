"""Multi-tenant cache fleets: many independent caches, one launch a chunk.

Counterpart of ``repro.cachesim.fleet``.  :func:`run_fleet` replays E
tenants, each its own request stream through its own cache (its own
capacity, eta and seed), in lockstep.  Where the kind has a grid form
(``PolicyDef.batched``: dense ``ogb`` with Poisson or no sampling and the
warm projection, the tree ``lru``, ``lfu`` and ``ftpl``, and ``fifo``) the
tenants' carries are stacked as :func:`repro_torch.cachesim.api.sweep`
stacks a grid's, and each chunk of the whole fleet is one launch of each
kernel it runs over (E, window) ids, a row of ids a tenant: the histogram
and the warm projection, ``tree_lru``, ``minpair_automaton``, ``fifo_queue``
a plan.  The other kinds (``omd``, ``ogb_tree``, ``ogb_sized``, ``gds``, the
Madow modes, the bisection, ``impl="dense"``) run tenant by tenant.  Either
way each row is bit for bit its tenant's own
:func:`~repro_torch.cachesim.api.run`.

:func:`run_fleet_stream` feeds the same replay from per-tenant chunk
iterators (for example ``tracelab.tenant_streams``) in fixed memory, on the
pipeline of :func:`repro_torch.cachesim.tracelab.stream.run_stream`.

:func:`run_edge_fleet` is the two-level CDN of "Learning to Cache With No
Regrets" collapsed to one shared parent: E edge caches replay their streams
with per-request hit flags, and the interleave of their misses (arrival
position major, edge index minor) is the origin cache's request stream,
replayed by ``run_stream``.

The reference shards the tenant axis over a mesh (``mesh=``, ``rules=``);
on one card the port raises on them (distribution is not ported).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import api
from repro_torch.cachesim import engines as _engines
from repro_torch.cachesim import tree_engines as _tree
from repro_torch.cachesim.results import EdgeFleetResult, FleetResult
from repro_torch.cachesim.scenarios import get_edge_fleet_scenario
from repro_torch.cachesim.tracelab import stream as _stream
from repro_torch.core.regret import best_static_hits
from repro_torch.kernels.fifo_queue.ref import MAX_REQUESTS as FIFO_MAX_REQUESTS

#: per-tenant requests a streamed dispatch (window-aligned down)
DEFAULT_FLEET_SEGMENT = 16_384

#: kinds whose per-request hit flags the edge tier can expose
FLAG_KINDS = ("ogb", "omd", "lru", "lfu", "ftpl", "fifo", "gds")


# ---------------------------------------------------------------------------
# per-tenant parameters
# ---------------------------------------------------------------------------


def _tenant_array(value, n_tenants: int, name: str, dtype=np.int64) -> np.ndarray:
    """A scalar or a length-E sequence as an (E,) host array."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        arr = np.full(n_tenants, arr.item())
    if arr.shape != (n_tenants,):
        raise ValueError(f"{name} must be a scalar or a length-{n_tenants} sequence, got shape "
                         f"{arr.shape}")
    return arr.astype(dtype)


def _tenant_etas(etas, n_tenants: int) -> list:
    if etas is None or isinstance(etas, (int, float)):
        return [etas] * n_tenants
    out = list(etas)
    if len(out) != n_tenants:
        raise ValueError(f"etas must be a scalar or length-{n_tenants} (got {len(out)})")
    return out


def _tenant_chunks(traces, window: int):
    """(E, t_used) host ids and t_used.

    ``traces`` is an (E, T) array or a list of equal-length 1-D arrays: the
    fleet steps in lockstep, so ragged tenants must be truncated by the
    caller (or streamed through :func:`run_fleet_stream`, which truncates to
    the shortest window-aligned tenant)."""
    if isinstance(traces, np.ndarray) and traces.ndim == 2:
        rows = [np.asarray(traces[e]).ravel() for e in range(traces.shape[0])]
    else:
        rows = [np.asarray(t).ravel() for t in traces]
    if not rows:
        raise ValueError("run_fleet needs at least one tenant trace")
    t_len = len(rows[0])
    if any(len(r) != t_len for r in rows):
        raise ValueError("all tenant traces must have equal length (the fleet steps in "
                         "lockstep); stream ragged tenants through run_fleet_stream")
    m = t_len // window
    if m == 0:
        raise ValueError(f"tenant traces shorter than one window ({t_len} < {window})")
    t_used = m * window
    return np.stack([r[:t_used] for r in rows]), t_used


def _build_fleet_carries(pd: "api.PolicyDef", catalog_size: int, caps: np.ndarray,
                         seeds: np.ndarray, eta_list: list, horizons: np.ndarray, window: int,
                         n_slots: int, sizes, costs, init_kw: dict, device: torch.device):
    """The tenants' initial carries and their resolved etas.

    ``eta=None`` tenants resolve ``pd.default_eta`` at **their own**
    horizon: a tenant replaying a T/E slice of a fleet's workload needs the
    Theorem 3.1 rate at T/E, not at the fleet's aggregate T."""
    resolved, carries = [], []
    sized_kw = {}
    if sizes is not None:
        sized_kw["sizes"] = np.asarray(sizes)
    if costs is not None:
        sized_kw["costs"] = np.asarray(costs)
    for t in range(len(caps)):
        e = eta_list[t]
        if e is None and pd.default_eta is not None:
            e = pd.default_eta(int(catalog_size), int(caps[t]), int(horizons[t]), window)
        resolved.append(e)
        carries.append(pd.init(int(catalog_size), int(caps[t]), seed=int(seeds[t]), eta=e,
                               horizon=int(horizons[t]), n_slots=n_slots, device=device,
                               **sized_kw, **init_kw))
    etas_out = (np.array([np.nan if r is None else float(r) for r in resolved])
                if any(r is not None for r in resolved) else None)
    return carries, etas_out


def _reject_resume_kwargs(seeds, etas, horizons, n_slots, costs, init_kw):
    if (seeds is not None or etas is not None or horizons is not None or n_slots is not None
            or costs is not None or init_kw):
        raise ValueError(
            "run_fleet(carry=...) resumes with the tenants' carries' own parameters; do not "
            "pass seeds/etas/horizons/n_slots/costs/init kwargs alongside a carry")


def _reject_mesh(mesh, rules):
    if mesh is not None or rules is not None:
        raise NotImplementedError("mesh=/rules= (the tenant axis sharded over a device mesh) "
                                  "is not ported: distribution waits for its own slice")


def _opt_from_counts(counts: np.ndarray, capacity: int) -> float:
    if len(counts) <= capacity:
        return float(counts.sum())
    top = np.partition(counts, len(counts) - capacity)[len(counts) - capacity:]
    return float(top.sum())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the replay of a fleet, a segment at a time
# ---------------------------------------------------------------------------


class _Fleet:
    """A fleet's tenants during a replay: one stacked grid where the kind
    has a grid form, else each tenant's own carry.

    ``dispatch(seg, block)`` replays an (E, L) block of ids (L a multiple of
    the window) and returns what :meth:`consume` turns into (E, L / window)
    host arrays; ``finals()`` gives each tenant's carry of the kind's own
    type, as its own run would have returned it."""

    def __init__(self, pd: "api.PolicyDef", carries: list, catalog_size: Optional[int],
                 window: int, sizes, dev: torch.device, name: Optional[str] = None):
        self.pd, self.window, self.sizes, self.dev, self.name = pd, window, sizes, dev, name
        self.n = catalog_size
        if self.n is None:  # a resumed fleet of carries that hold their catalog size
            self.n = next((c.catalog_size for c in carries
                           if getattr(c, "catalog_size", None) is not None), None)
        for c in carries:
            if c.device != dev:
                raise ValueError(f"a tenant's carry is on {c.device}, the fleet was asked "
                                 f"for {dev}")
        self.carries = list(carries)
        # a grid kind's stacked carries, started at the first dispatch, and
        # the requests since (FIFO's tickets)
        self.grid, self.since = None, 0

    def _id_bound(self, seg: np.ndarray) -> int:
        return int(self.n) if self.n is not None else int(seg.max()) + 1

    def dispatch(self, seg: np.ndarray, block: bool):
        pd, w = self.pd, self.window
        e, length = seg.shape
        if self.n is not None and (int(seg.min()) < 0 or int(seg.max()) >= self.n):
            raise ValueError(f"tenant ids must lie in [0, {self.n}), got "
                             f"[{int(seg.min())}, {int(seg.max())}]")
        if pd.batched is None:
            results = []
            for t in range(e):
                res = api.run(pd, seg[t], self.n, capacity=None, window=w,
                              carry=self.carries[t], sizes=self.sizes, track_opt=False,
                              block=block, device=self.dev, name=self.name)
                self.carries[t] = res.carry
                results.append(res)
            return results
        if pd.kind == "fifo" and self.since + length > FIFO_MAX_REQUESTS:
            self.carries, self.grid = self.finals(), None  # its queue derived afresh
        if self.grid is None:
            self.grid = pd.batched.start(self.carries, self._id_bound(seg))
            self.carries, self.since = None, 0
        self.since += length
        # (M, E, W): chunk i is the (E, W) block of every tenant's i-th chunk
        blocks = np.ascontiguousarray(
            seg.astype(np.int32).reshape(e, length // w, w).transpose(1, 0, 2))
        chunks, staged = api._upload(blocks, self.dev, block)
        self.grid, outs = api._replay(pd.batched.step or pd.step, self.grid, chunks)
        event = None
        if block:
            _sync(self.dev)
        elif self.dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.dev))
        return outs, event, staged

    @staticmethod
    def consume(item):
        """(reward, hits, aux, occupancy, byte_hits) host arrays, (E, M)
        each (byte_hits None where the step reports none)."""
        if isinstance(item, list):
            for res in item:
                res.consume()
            parts = [(r.reward, r.hits, r.aux, r.occupancy, r.byte_hits) for r in item]
            return tuple(np.stack(x) if x[0] is not None else None for x in zip(*parts))
        outs, event, _staged = item
        if event is not None:
            event.synchronize()
        reward, hits, aux, occ, byte_hits = outs
        return (reward.cpu().numpy().astype(np.float64), hits.cpu().numpy().astype(np.int64),
                aux.cpu().numpy().astype(np.float64), occ.cpu().numpy().astype(np.float64),
                byte_hits.cpu().numpy() if byte_hits is not None else None)

    def finals(self) -> list:
        if self.pd.batched is not None and self.grid is not None:
            return self.pd.batched.split(self.grid)
        return list(self.carries)


def _start_fleet(pd, n_tenants, catalog_size, capacities, carry, seeds, etas, horizons,
                 default_horizon, n_slots, sizes, costs, init_kw, window, dev):
    """(carries, caps, seeds, etas) of a fresh or a resumed fleet."""
    if carry is None:
        if catalog_size is None or capacities is None:
            raise ValueError("run_fleet() needs catalog_size and capacities (or carry=)")
        caps = _tenant_array(capacities, n_tenants, "capacities")
        seed_arr = _tenant_array(seeds if seeds is not None else np.arange(n_tenants),
                                 n_tenants, "seeds")
        hor = _tenant_array(horizons if horizons is not None else default_horizon, n_tenants,
                            "horizons")
        slots = int(n_slots) if n_slots is not None else int(caps.max())
        carries, etas_out = _build_fleet_carries(
            pd, catalog_size, caps, seed_arr, _tenant_etas(etas, n_tenants), hor, window, slots,
            sizes, costs, init_kw, dev)
        return carries, caps, seed_arr, etas_out
    _reject_resume_kwargs(seeds, etas, horizons, n_slots, costs, init_kw)
    carries = list(carry)
    if len(carries) != n_tenants:
        raise ValueError(f"carry holds {len(carries)} tenants, not the {n_tenants} tenant "
                         "traces")
    caps = (_tenant_array(capacities, n_tenants, "capacities") if capacities is not None
            else np.full(n_tenants, -1))
    return carries, caps, np.full(n_tenants, -1), None


# ---------------------------------------------------------------------------
# in-memory fleet replay
# ---------------------------------------------------------------------------


def run_fleet(
    pd: "api.PolicyDef",
    traces,
    catalog_size: Optional[int] = None,
    capacities=None,
    *,
    window: int = 1000,
    carry: Any = None,
    seeds=None,
    etas=None,
    horizons=None,
    n_slots: Optional[int] = None,
    sizes: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    track_opt: bool = True,
    keep_carry: bool = True,
    name: Optional[str] = None,
    mesh=None,
    rules=None,
    device: DeviceLike = None,
    **init_kw,
) -> FleetResult:
    """Replay E per-tenant traces through E independent caches.

    ``traces`` is an (E, T) array (or a list of equal-length 1-D arrays);
    row ``e`` is tenant ``e``'s own request stream.  ``capacities``,
    ``seeds`` (default ``0 .. E-1``), ``etas`` and ``horizons`` each take a
    scalar or a length-E sequence; the automata are padded to ``n_slots =
    max(capacities)`` slots, as ``sweep`` pads them, so that heterogeneous
    capacities stack.  ``etas=None`` resolves ``pd.default_eta`` per tenant
    at that tenant's horizon (default: its own replayed length).

    Where the kind has a grid form each chunk of the whole fleet is one
    launch of each of its kernels over (E, window) ids; the other kinds run
    tenant by tenant.  Each row is bit for bit the tenant's own ``run`` with
    the same capacity, seed, eta, horizon and ``n_slots``.  Resume by
    passing the previous result's ``carry`` (the list of the tenants'
    carries).  ``device=None`` is the CUDA card; ``device="cpu"`` runs the
    kernels' plain versions.  ``mesh=``/``rules=`` raise: sharding the
    tenant axis is not ported.
    """
    _reject_mesh(mesh, rules)
    if not pd.trace_driven:
        raise ValueError(f"policy kind {pd.kind!r} is not trace-driven; the fleet replays "
                         "per-tenant request streams")
    dev = resolve_device(device)
    used, t_used = _tenant_chunks(traces, window)
    n_tenants = used.shape[0]
    if pd.kind == "fifo" and t_used > FIFO_MAX_REQUESTS:
        raise ValueError(f"a FIFO run serves at most {FIFO_MAX_REQUESTS} requests, got {t_used}")
    carries, caps, seed_arr, etas_out = _start_fleet(
        pd, n_tenants, catalog_size, capacities, carry, seeds, etas, horizons, t_used, n_slots,
        sizes, costs, init_kw, window, dev)
    fleet = _Fleet(pd, carries, catalog_size, window, sizes, dev, name)
    del carries
    _sync(dev)
    t0 = time.perf_counter()
    reward, hits, aux, occ, byte_hits = fleet.consume(fleet.dispatch(used, True))
    wall = time.perf_counter() - t0
    opt = (np.array([float(best_static_hits(used[e], int(caps[e]))) for e in range(n_tenants)])
           if track_opt and caps.min() >= 0 else np.zeros(n_tenants))
    bytes_total = (np.asarray(sizes, np.float64)[used].sum(axis=1) if sizes is not None
                   else None)
    return FleetResult(
        name=name or pd.name, kind=pd.kind, n_tenants=n_tenants, T=t_used, window=window,
        capacities=caps, seeds=seed_arr, etas=etas_out, reward=reward, hits=hits, aux=aux,
        occupancy=occ, opt_hits=opt, carry=fleet.finals() if keep_carry else None,
        wall_seconds=wall, byte_hits=byte_hits, bytes_total=bytes_total)


# ---------------------------------------------------------------------------
# streamed fleet replay (fixed memory, the ingest thread ahead of the card)
# ---------------------------------------------------------------------------


class _FleetState:
    """Accumulators of one fleet stream.  The ingest-side counters
    (``t_ingested``, ``ingest_seconds``, ``t_dropped``) are written only by
    the thread that assembles segments, the rest only by the main thread."""

    def __init__(self):
        self.parts: list = []  # each segment's (reward, hits, aux, occupancy, byte_hits)
        self.n_segments = 0
        self.t_used = 0  # per tenant
        self.t_ingested = 0  # across the fleet
        self.t_dropped = 0
        self.ingest_seconds = 0.0
        self.device_seconds = 0.0
        self.host_seconds = 0.0
        self.counts: Optional[np.ndarray] = None  # (E, N) when track_opt
        self.bytes_total: Optional[np.ndarray] = None


def _assemble_fleet_segments(sources: list, segment_len: int, window: int,
                             catalog_size: Optional[int], st: _FleetState):
    """Lockstep (E, segment_len) blocks from E independent chunk iterators.

    Each tenant's source is buffered until every tenant covers a full
    segment; when a source runs dry the fleet is truncated to the longest
    window-aligned length every tenant still covers (the lockstep form of
    ``run_stream``'s window-aligned tail), and the remainder is counted in
    ``t_dropped``."""
    its = [_stream._as_chunks(s) for s in sources]
    n = len(its)
    bufs: list = [[] for _ in range(n)]
    buffered = [0] * n
    done = [False] * n

    def pull(e: int) -> None:
        t0 = time.perf_counter()
        try:
            chunk = next(its[e])
        except StopIteration:
            st.ingest_seconds += time.perf_counter() - t0
            done[e] = True
            return
        except Exception as err:  # the source failed, not the stream
            st.ingest_seconds += time.perf_counter() - t0
            raise _stream._SourceError(err) from err
        st.ingest_seconds += time.perf_counter() - t0
        chunk = np.asarray(chunk, dtype=np.int64).ravel()
        if chunk.size == 0:
            return
        if catalog_size is not None:
            cmin, cmax = int(chunk.min()), int(chunk.max())
            if cmin < 0 or cmax >= catalog_size:
                raise ValueError(f"tenant {e} ids out of range [0, {catalog_size}): saw "
                                 f"[{cmin}, {cmax}]")
        st.t_ingested += chunk.size
        bufs[e].append(chunk)
        buffered[e] += chunk.size

    def take(e: int, k: int) -> np.ndarray:
        merged = np.concatenate(bufs[e]) if len(bufs[e]) > 1 else bufs[e][0]
        rest = merged[k:]
        bufs[e][:] = [rest] if rest.size else []
        buffered[e] = int(rest.size)
        return merged[:k]

    while True:
        for e in range(n):
            while buffered[e] < segment_len and not done[e]:
                pull(e)
        if all(b >= segment_len for b in buffered):
            yield np.stack([take(e, segment_len) for e in range(n)])
            continue
        # tail: a tenant ran dry below one segment; pull the others up to the
        # best window-aligned length the dry tenants still allow
        target = min(buffered[e] for e in range(n) if done[e])
        target = (target // window) * window
        for e in range(n):
            while buffered[e] < target and not done[e]:
                pull(e)
        aligned = (min(buffered) // window) * window
        st.t_dropped = int(sum(buffered) - aligned * n)
        if aligned:
            yield np.stack([take(e, aligned) for e in range(n)])
        return


def run_fleet_stream(
    pd: "api.PolicyDef",
    sources: Sequence[Union[np.ndarray, Iterable[np.ndarray]]],
    catalog_size: Optional[int] = None,
    capacities=None,
    *,
    window: int = 1000,
    segment_len: Optional[int] = None,
    carry: Any = None,
    seeds=None,
    etas=None,
    horizons=None,
    n_slots: Optional[int] = None,
    sizes: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    track_opt: bool = False,
    keep_carry: bool = True,
    name: Optional[str] = None,
    prefetch: Optional[int] = None,
    device: DeviceLike = None,
) -> FleetResult:
    """Stream E per-tenant chunk iterators through the fleet in fixed memory.

    ``sources[e]`` yields tenant ``e``'s request-id chunks of any sizes,
    re-batched into lockstep (E, segment_len) blocks; ragged tenants are
    truncated to the shortest window-aligned one (``t_dropped``).  With
    ``prefetch > 0`` (default ``REPRO_STREAM_PREFETCH`` or 2) a background
    thread ingests and assembles segments while the card replays the ones
    before (``run_stream``'s pipeline); ``prefetch=0`` is synchronous.  Both
    give the bits of :func:`run_fleet` over the concatenated tenants.

    A fresh fleet needs ``horizons`` (each tenant's planned stream length),
    so that each tenant's ``eta=None`` resolves at its own horizon.
    ``track_opt`` accumulates per-tenant request histograms at ingest and
    reports hindsight static OPT (off by default: O(E N) host memory).  On a
    source failure the in-flight segments are consumed and a
    :class:`~repro_torch.cachesim.tracelab.stream.StreamFault` is raised
    whose ``partial`` holds the replayed prefix (resumable through its
    ``carry``).
    """
    if window <= 0:
        raise ValueError(f"window must be positive (got {window})")
    sources = list(sources)
    n_tenants = len(sources)
    if n_tenants == 0:
        raise ValueError("run_fleet_stream needs at least one tenant source")
    if segment_len is None:
        segment_len = max(window, (DEFAULT_FLEET_SEGMENT // window) * window)
    else:
        segment_len = max(window, (int(segment_len) // window) * window)
    if prefetch is None:
        prefetch = _stream._default_prefetch()
    prefetch = max(0, int(prefetch))
    dev = resolve_device(device)
    if carry is None:
        if catalog_size is None or capacities is None:
            raise ValueError("run_fleet_stream() needs catalog_size and capacities (or carry=)")
        if horizons is None:
            raise ValueError("run_fleet_stream() needs horizons= (each tenant's planned stream "
                             "length) for a fresh fleet: per-tenant eta resolution cannot infer "
                             "a stream's length")
    carries, caps, seed_arr, etas_out = _start_fleet(
        pd, n_tenants, catalog_size, capacities, carry, seeds, etas, horizons, None, n_slots,
        sizes, costs, {}, window, dev)
    fleet = _Fleet(pd, carries, catalog_size, window, sizes, dev, name)
    del carries

    st = _FleetState()
    if track_opt:
        if catalog_size is None or caps.min() < 0:
            raise ValueError("track_opt=True needs catalog_size and capacities")
        st.counts = np.zeros((n_tenants, int(catalog_size)), np.int64)
    sizes_np = None
    if sizes is not None:
        sizes_np = np.asarray(sizes, np.float64)
        st.bytes_total = np.zeros(n_tenants, np.float64)
    t0_wall = time.perf_counter()

    def dispatch(seg: np.ndarray, block: bool):
        t0 = time.perf_counter()
        item = fleet.dispatch(seg, block)
        st.device_seconds += time.perf_counter() - t0
        return item, seg.shape[1]

    def host_pass(seg: np.ndarray) -> None:
        """Per-tenant OPT histograms and byte totals (host work, so it
        overlaps the device's replay)."""
        if st.counts is None and sizes_np is None:
            return
        t0 = time.perf_counter()
        for e in range(n_tenants):
            if st.counts is not None:
                st.counts[e] += np.bincount(seg[e], minlength=st.counts.shape[1])
            if sizes_np is not None:
                st.bytes_total[e] += float(sizes_np[seg[e]].sum())
        st.host_seconds += time.perf_counter() - t0

    def consume(pending) -> None:
        item, t_seg = pending
        t0 = time.perf_counter()
        st.parts.append(fleet.consume(item))
        st.device_seconds += time.perf_counter() - t0
        st.n_segments += 1
        st.t_used += t_seg

    def result() -> FleetResult:
        opt = (np.array([_opt_from_counts(st.counts[e], int(caps[e]))
                         for e in range(n_tenants)])
               if st.counts is not None else np.zeros(n_tenants))
        cols = list(zip(*st.parts))
        byte_hits = (np.concatenate(cols[4], axis=1)
                     if st.n_segments and all(b is not None for b in cols[4]) else None)
        return FleetResult(
            name=name or pd.name, kind=pd.kind, n_tenants=n_tenants, T=st.t_used,
            window=window, capacities=caps, seeds=seed_arr, etas=etas_out,
            reward=np.concatenate(cols[0], axis=1), hits=np.concatenate(cols[1], axis=1),
            aux=np.concatenate(cols[2], axis=1), occupancy=np.concatenate(cols[3], axis=1),
            opt_hits=opt, carry=fleet.finals() if keep_carry else None,
            wall_seconds=time.perf_counter() - t0_wall, byte_hits=byte_hits,
            bytes_total=st.bytes_total, n_segments=st.n_segments, t_dropped=st.t_dropped,
            prefetch=prefetch)

    def fault(err, pending):
        for item in pending:
            consume(item)
        partial = result() if st.t_used else None
        return _stream.StreamFault(
            f"tenant chunk source failed after {st.t_ingested} ingested / {st.t_used} "
            f"per-tenant replayed requests ({st.n_segments} segments): {err.cause!r}",
            t_ingested=st.t_ingested, t_replayed=st.t_used * n_tenants,
            n_segments=st.n_segments, partial=partial)

    _stream.pipeline(
        lambda: _assemble_fleet_segments(sources, segment_len, window, catalog_size, st),
        dispatch, host_pass, consume, fault, prefetch, "run_fleet_stream")
    if st.t_used == 0:
        raise ValueError(f"tenant streams shorter than one window ({st.t_dropped} buffered "
                         f"across {n_tenants} tenants < {window} a tenant)")
    return result()


# ---------------------------------------------------------------------------
# two-level edge -> origin fleet
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flags_policy(kind: str):
    """``(pd, flags_step)`` for the edge tier.

    ``flags_step(carry, ids) -> (carry, (StepOut, flags))`` is the kind's
    own step, bit for bit, that also gives each request's hit: (W,) flags
    for one tenant's carry, (E, W) for a grid of tenants over (E, W) ids.
    The misses are the origin's request stream."""
    pd = api.policy_def(kind)
    if kind in ("ogb", "omd"):
        # Poisson accounting: a request hits iff f[id] >= p[id] before the
        # update, as sample_chunk_metrics counts it, so sum(flags) == hits
        def step(carry, ids):
            rows = ids.to(torch.int64)
            if ids.dim() == 2:
                flags = carry.f.gather(1, rows) >= carry.p.gather(1, rows)
            else:
                flags = carry.f.index_select(0, rows) >= carry.p.index_select(0, rows)
            carry, out = pd.step(carry, ids)
            return carry, (out, flags)

    elif kind in _tree.TREE_ENGINE_KINDS or kind == "gds":

        def step(carry, ids):
            lead = tuple(carry[0].shape[:-1])  # () for one tenant, (E,) for a grid
            flags = torch.empty(lead + tuple(ids.shape[-1:]), dtype=torch.bool, device=ids.device)
            if kind == "lru" and lead:
                carry, (hits, stats) = _tree.grid_lru_chunk(carry, ids, flags)
            else:
                carry, (hits, stats) = _tree.tree_chunk(kind, carry, ids, flags)
            byte_hits = None
            if kind == "gds":
                szs = carry.szs[ids.to(torch.int64)]
                byte_hits = torch.where(flags, szs, torch.zeros_like(szs)).sum(
                    dim=-1, dtype=torch.float64)
            return carry, (api.StepOut(stats[..., 0], hits, stats[..., 1], stats[..., 2],
                                       byte_hits), flags)

    elif kind == "fifo":

        def step(carry, ids):
            flags = torch.empty(tuple(carry.slots.shape[:-1]) + tuple(ids.shape[-1:]),
                                dtype=torch.bool, device=ids.device)
            if isinstance(carry, _engines.FIFOGridCarry):
                carry, (hits, stats) = _engines.fifo_grid_chunk(carry, ids, flags)
            else:
                carry, (hits, stats) = _engines.fifo_chunk(carry, ids, flags)
            return carry, (api.StepOut(stats[..., 0], hits, stats[..., 1], stats[..., 2]),
                           flags)

    else:
        raise ValueError(f"edge tier needs per-request hit flags; kind {kind!r} has none "
                         f"(supported: {FLAG_KINDS})")
    return pd, step


def _edge_tier(edge_kind: str, used: np.ndarray, window: int, catalog_size: int,
               caps: np.ndarray, seed_arr: np.ndarray, edge_etas, dev: torch.device):
    """The edges' replay with flags: ``(carries, (reward, hits, aux,
    occupancy) host arrays (E, M) each, flags (E, M, W) host bools,
    etas)``.  A grid kind steps every edge in one launch a chunk."""
    n_edges, t_used = used.shape
    m = t_used // window
    pd, flags_step = _flags_policy(edge_kind)
    carries, etas_out = _build_fleet_carries(
        pd, catalog_size, caps, seed_arr, _tenant_etas(edge_etas, n_edges),
        np.full(n_edges, t_used), window, int(caps.max()), None, None, {}, dev)
    chunks = torch.from_numpy(np.ascontiguousarray(
        used.astype(np.int32).reshape(n_edges, m, window).transpose(1, 0, 2))).to(dev)
    flags = torch.empty((m, n_edges, window), dtype=torch.bool, device=dev)
    outs = [torch.empty((n_edges, m), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    if pd.batched is not None:
        grid = pd.batched.start(carries, catalog_size)
        for i in range(m):
            grid, (out, fl) = flags_step(grid, chunks[i])
            flags[i] = fl
            for buf, x in zip(outs, out[:4]):
                buf[:, i] = x
        finals = pd.batched.split(grid)
    else:
        finals = []
        for e, c in enumerate(carries):
            c = pd.start(c, catalog_size) if pd.start is not None else c
            for i in range(m):
                c, (out, fl) = flags_step(c, chunks[i, e])
                flags[i, e] = fl
                for buf, x in zip(outs, out[:4]):
                    buf[e, i] = x
            finals.append(pd.finish(c) if pd.finish is not None else c)
    _sync(dev)
    reward, hits, aux, occ = (x.cpu().numpy() for x in outs)
    return (finals, (reward.astype(np.float64), hits.astype(np.int64), aux.astype(np.float64),
                     occ.astype(np.float64)),
            flags.cpu().numpy().transpose(1, 0, 2), etas_out)


def _miss_chunks(ids: np.ndarray, flags: np.ndarray):
    """The edges' misses, a chunk at a time, arrival position major and edge
    minor: each (E, W) chunk transposed to (W, E) before its misses are
    taken, so simultaneous arrivals interleave round-robin across edges.
    ``ids`` and ``flags`` are (E, M, W)."""
    for k in range(ids.shape[1]):
        miss = ~flags[:, k, :]
        yield ids[:, k, :].T[miss.T]


def run_edge_fleet(
    edge_kind: str,
    origin_kind: str,
    traces,
    catalog_size: int,
    edge_capacities,
    origin_capacity: int,
    *,
    window: int = 500,
    origin_window: Optional[int] = None,
    seeds=None,
    edge_etas=None,
    origin_eta: Optional[float] = None,
    origin_seed: int = 0,
    track_opt: bool = True,
    prefetch: Optional[int] = None,
    name: Optional[str] = None,
    device: DeviceLike = None,
) -> EdgeFleetResult:
    """Two-level replay: E edge caches in front of one shared origin cache.

    Phase 1 replays every edge's own trace through the fleet with
    per-request hit flags (a grid kind one launch a chunk for every edge;
    ``ogb``/``omd`` flags are ``f[id] >= p[id]`` before the update).  Phase
    2 interleaves the edge *misses*, arrival position major and edge index
    minor (the round-robin order a synchronous fleet presents to its
    parent), and streams them through the origin cache with ``run_stream``.
    Regret is accounted per tenant at the edge and hindsight-static at the
    origin.
    """
    dev = resolve_device(device)
    used, t_used = _tenant_chunks(traces, window)
    n_edges = used.shape[0]
    caps = _tenant_array(edge_capacities, n_edges, "edge_capacities")
    seed_arr = _tenant_array(seeds if seeds is not None else np.arange(n_edges), n_edges,
                             "seeds")
    pd_edge = api.policy_def(edge_kind)
    _sync(dev)
    t0 = time.perf_counter()
    finals, (reward, hits, aux, occ), flags, etas_out = _edge_tier(
        edge_kind, used, window, catalog_size, caps, seed_arr, edge_etas, dev)
    edge_wall = time.perf_counter() - t0
    opt = (np.array([float(best_static_hits(used[e], int(caps[e]))) for e in range(n_edges)])
           if track_opt else np.zeros(n_edges))
    edges = FleetResult(
        name=f"{name or 'edge_fleet'}/{pd_edge.name}", kind=pd_edge.kind, n_tenants=n_edges,
        T=t_used, window=window, capacities=caps, seeds=seed_arr, etas=etas_out,
        reward=reward, hits=hits, aux=aux, occupancy=occ, opt_hits=opt, carry=finals,
        wall_seconds=edge_wall)

    # phase 2: the miss interleave is the origin's stream
    ids = used.reshape(n_edges, -1, window)
    total_misses = int((~flags).sum())
    ow = int(origin_window) if origin_window is not None else window
    if total_misses < ow:
        raise ValueError(f"edge misses ({total_misses}) shorter than one origin window ({ow}); "
                         "lower origin_window or raise the edge load")
    pd_origin = api.policy_def(origin_kind)
    origin = _stream.run_stream(
        pd_origin, _miss_chunks(ids, flags), catalog_size, int(origin_capacity), window=ow,
        seed=origin_seed, eta=origin_eta, horizon=total_misses, keep_carry=False,
        prefetch=prefetch, name=f"{name or 'edge_fleet'}/origin-{pd_origin.name}", device=dev)
    if track_opt:
        miss_trace = np.concatenate(list(_miss_chunks(ids, flags)))[: origin.T]
        origin.opt_hits = float(best_static_hits(miss_trace, int(origin_capacity)))
    return EdgeFleetResult(edges=edges, origin=origin, origin_requests=total_misses)


def run_edge_fleet_scenario(
    name: str,
    scale: str = "quick",
    *,
    prefetch: Optional[int] = None,
    track_opt: bool = True,
    device: DeviceLike = None,
) -> EdgeFleetResult:
    """Run a registered ``EDGE_FLEET_SCENARIOS`` entry at ``scale``."""
    sc = get_edge_fleet_scenario(name)
    _n_edges, catalog, _t_edge, c_edge, c_origin = sc.dims(scale)
    traces = sc.make_edge_traces(scale)
    return run_edge_fleet(sc.edge_policy, sc.origin_policy, traces, catalog, c_edge, c_origin,
                          window=sc.window, prefetch=prefetch, track_opt=track_opt,
                          name=sc.name, device=device)
