"""Out-of-core streaming replay: any PolicyDef over any chunk iterator.

Counterpart of ``repro.cachesim.tracelab.stream``.  :func:`run_stream` is
not a third engine: it re-batches an arbitrary chunk iterator (a trace-file
loader, a catalog remapper, the workload synthesizer) into fixed-shape
segments and replays each through the resumable
``api.run(carry=...)`` contract.  Peak memory is O(segment + policy state),
independent of the trace length, and the replayed dynamics are bit for bit
a one-shot :func:`repro_torch.cachesim.api.run` over the concatenated
trace, whatever the incoming chunking.

**The pipeline (default).**  With ``prefetch >= 1``:

* a background ingest thread pulls chunks from the source and re-batches
  them into segments, up to ``prefetch`` segments ahead of the device.  It
  does numpy work only and never touches the device;
* the main thread dispatches segment ``k`` without blocking
  (``api.run(block=False)``: the segment goes up from pinned memory and the
  carry chains through the CUDA stream), then runs the host's dynamic-OPT
  pass over segment ``k`` while the card replays it;
* :meth:`~repro_torch.cachesim.results.RunResult.consume` waits on a
  segment's event only where its results are folded into the
  accumulators, ``prefetch`` segments later.

The pipeline is bit for bit the synchronous path (same segments, same carry
chain, same dynamic-OPT windows); only the
:class:`~repro_torch.cachesim.results.StreamResult` timing split
(``ingest_seconds`` / ``device_seconds`` / ``host_seconds``) tells them
apart.  ``prefetch=0`` is the synchronous loop.

When the chunk source raises mid-stream, the in-flight segments are
consumed, the replayed prefix is packaged (its resumable carry included),
and a :class:`StreamFault` pinning the stream position is raised from the
source's error.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import api
from repro_torch.cachesim.results import StreamResult
from repro_torch.core.regret import best_static_hits

#: default steady-state segment length (requests a device dispatch)
DEFAULT_SEGMENT = 131_072

#: default pipeline depth (segments assembled and dispatched ahead of the
#: consume point); ``prefetch=`` or ``REPRO_STREAM_PREFETCH`` override it
#: (0 = synchronous)
DEFAULT_PREFETCH = 2


class StreamFault(RuntimeError):
    """The chunk source failed mid-stream.

    Raised by :func:`run_stream` after the in-flight work has been consumed,
    so the attributes pin the stream position:

    - ``t_ingested``: requests pulled from the source,
    - ``t_replayed``: requests whose segments were dispatched and consumed,
    - ``n_segments``: device dispatches completed,
    - ``partial``: a :class:`~repro_torch.cachesim.results.StreamResult`
      over the replayed prefix (resumable through its ``carry``), or
      ``None`` when the fault hit before one window replayed.

    The source's exception is chained as ``__cause__``.
    """

    def __init__(self, message: str, *, t_ingested: int = 0, t_replayed: int = 0,
                 n_segments: int = 0, partial: Optional[StreamResult] = None):
        super().__init__(message)
        self.t_ingested = int(t_ingested)
        self.t_replayed = int(t_replayed)
        self.n_segments = int(n_segments)
        self.partial = partial


class _SourceError(Exception):
    """The source iterator raised (as opposed to the stream's own checks,
    which surface unwrapped)."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


_DONE = object()  # the ingest thread's sentinel: source exhausted


def _as_chunks(chunks: Union[np.ndarray, Iterable[np.ndarray]]) -> Iterator[np.ndarray]:
    if isinstance(chunks, np.ndarray):
        yield chunks
        return
    for c in chunks:
        yield np.asarray(c)


def _default_prefetch() -> int:
    return int(os.environ.get("REPRO_STREAM_PREFETCH", DEFAULT_PREFETCH))


def pipeline(assemble, dispatch, host_pass, consume, fault, prefetch: int, label: str):
    """Drive segments from ``assemble()`` (a generator that raises
    :class:`_SourceError` where the source fails) through ``dispatch(seg,
    block) -> pending``, ``host_pass(seg)`` and ``consume(pending)``.

    With ``prefetch == 0`` each segment is dispatched, passed on the host and
    consumed in turn.  Else a daemon thread runs ``assemble`` (numpy work
    only) up to ``prefetch`` segments ahead, each segment is dispatched
    without blocking, its host pass runs while the device replays it, and at
    most ``prefetch`` dispatched segments wait to be consumed.  A source
    error raises ``fault(err, pending)`` from its cause; any other error
    consumes what was dispatched and re-raises."""
    if prefetch == 0:
        segs = assemble()
        while True:
            try:
                seg = next(segs)
            except StopIteration:
                return
            except _SourceError as e:
                raise fault(e, ()) from e.cause
            res = dispatch(seg, True)
            host_pass(seg)
            consume(res)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has left, so the
        # ingest thread never hangs on a dead pipeline
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def ingest():
        try:
            for seg in assemble():
                if not put(seg):
                    return
            put(_DONE)
        except BaseException as e:  # forwarded: the main thread classifies it
            put(e)

    worker = threading.Thread(target=ingest, name=f"{label}-ingest", daemon=True)
    worker.start()
    pending: deque = deque()  # dispatched, not yet consumed
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, _SourceError):
                raise fault(item, pending) from item.cause
            if isinstance(item, BaseException):
                while pending:  # consume what is in flight before re-raising
                    consume(pending.popleft())
                raise item
            pending.append(dispatch(item, False))
            host_pass(item)  # overlaps the device's replay of the segment
            while len(pending) > prefetch:
                consume(pending.popleft())
        while pending:
            consume(pending.popleft())
    finally:
        stop.set()
        worker.join(timeout=5.0)


class _StreamState:
    """Accumulators of one stream.  The ingest-side counters
    (``t_ingested``, ``ingest_seconds``, ``t_dropped``) are written only by
    the thread that assembles segments, the rest only by the main thread."""

    def __init__(self):
        self.reward, self.hits, self.aux, self.occupancy = [], [], [], []
        self.byte_hits: list = []
        self.bytes_total = 0.0
        self.dyn_opt: list = []
        self.opt_buf: list = []
        self.opt_buffered = 0
        self.n_segments = 0
        self.t_used = 0
        self.t_ingested = 0
        self.t_dropped = 0
        self.extras: dict = {}
        self.ingest_seconds = 0.0
        self.device_seconds = 0.0
        self.host_seconds = 0.0


def _assemble_segments(source, segment_len: int, window: int, catalog_size: Optional[int],
                       st: _StreamState) -> Iterator[np.ndarray]:
    """Re-batch raw source chunks into window-aligned segments.

    Yields steady-state ``segment_len`` segments, then one window-aligned
    tail (``st.t_dropped`` records the sub-window remainder).  Time spent
    inside the source accrues to ``st.ingest_seconds``; the source's
    exceptions come wrapped in :class:`_SourceError`."""
    it = _as_chunks(source)
    buf: list = []
    buffered = 0
    while True:
        t0 = time.perf_counter()
        try:
            chunk = next(it)
        except StopIteration:
            st.ingest_seconds += time.perf_counter() - t0
            break
        except Exception as e:  # the source failed, not the stream
            st.ingest_seconds += time.perf_counter() - t0
            raise _SourceError(e) from e
        st.ingest_seconds += time.perf_counter() - t0
        chunk = np.asarray(chunk, dtype=np.int64).ravel()
        if chunk.size == 0:
            continue
        if catalog_size is not None and not (
                0 <= int(chunk.min()) and int(chunk.max()) < catalog_size):
            # an out-of-range dense id would index past the catalog
            raise ValueError(
                f"stream ids must be dense in [0, {catalog_size}): got "
                f"[{int(chunk.min())}, {int(chunk.max())}]; route raw traces through "
                "CatalogRemap (with max_items=catalog_size) first")
        st.t_ingested += chunk.size
        buf.append(chunk)
        buffered += chunk.size
        while buffered >= segment_len:
            merged = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield merged[:segment_len]
            rest = merged[segment_len:]
            buf = [rest] if rest.size else []
            buffered = rest.size
    # tail: its whole windows replay as one last, shorter segment
    if buffered:
        merged = np.concatenate(buf) if len(buf) > 1 else buf[0]
        aligned = (buffered // window) * window
        st.t_dropped = buffered - aligned
        if aligned:
            yield merged[:aligned]


def run_stream(
    pd: "api.PolicyDef",
    chunks: Union[np.ndarray, Iterable[np.ndarray]],
    catalog_size: Optional[int] = None,
    capacity: Optional[int] = None,
    *,
    window: int = 1000,
    segment_len: Optional[int] = None,
    carry: Any = None,
    seed: int = 0,
    eta: Optional[float] = None,
    horizon: Optional[int] = None,
    n_slots: Optional[int] = None,
    sizes: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    opt_window: Optional[int] = None,
    keep_carry: bool = True,
    name: Optional[str] = None,
    prefetch: Optional[int] = None,
    device: DeviceLike = None,
) -> StreamResult:
    """Replay a chunk iterator through one policy in fixed memory.

    ``chunks`` yields 1-D int arrays of dense ids in ``[0, catalog_size)``
    (route raw traces through
    :class:`~repro_torch.cachesim.tracelab.catalog.CatalogRemap` first).
    They are re-buffered into ``segment_len``-request segments (rounded down
    to a multiple of ``window``; the incoming chunking never changes the
    replayed dynamics), and each segment resumes the previous one's carry
    through ``api.run(carry=...)``.  A trailing remainder shorter than one
    ``window`` is dropped, as the one-shot ``api.run`` drops it, and
    reported as ``t_dropped``.

    ``horizon``, the planned total stream length, is required on a fresh
    stream: it resolves ``eta=None`` (``pd.default_eta``) and tunes FTPL's
    noise, and a stream cannot know its own length.  For bit-for-bit parity
    with a one-shot ``api.run`` over the same trace pass that run's replayed
    length as ``horizon``, and the same ``eta`` and ``seed``.

    ``opt_window`` (a multiple of ``window``; rounded up) computes on the
    host, while the stream passes, the hindsight-optimal static allocation
    of each window alone: the time-varying comparator of
    :attr:`~repro_torch.cachesim.results.StreamResult.dynamic_regret`.  The
    last window covers the replayed remainder.

    ``prefetch`` (default 2, or ``REPRO_STREAM_PREFETCH``) sets the
    pipeline's depth; ``prefetch=0`` is the synchronous loop.  Both give
    the same bits; only the timing split differs.  If the source raises
    mid-stream, a :class:`StreamFault` with the stream position and a
    resumable ``partial`` result is raised from its error.

    Pass ``carry=`` to resume a previous stream's final carry; as with
    ``api.run``, ``seed``/``eta``/``horizon``/``n_slots``/``costs`` must not
    be passed with it (``sizes`` may be: it also drives the byte
    accounting).  ``sizes``/``costs`` are per-item arrays passed through to
    ``api.run``.  ``device=None`` is the CUDA card; ``device="cpu"`` runs the
    kernels' plain versions.
    """
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if segment_len is None:
        segment_len = max(window, (DEFAULT_SEGMENT // window) * window)
    else:
        segment_len = max(window, (int(segment_len) // window) * window)
    if opt_window is not None:
        if capacity is None:
            raise ValueError("opt_window needs capacity")
        opt_window = max(1, -(-int(opt_window) // window)) * window
    if prefetch is None:
        prefetch = _default_prefetch()
    prefetch = max(0, int(prefetch))
    dev = resolve_device(device)

    if carry is None:
        if catalog_size is None or capacity is None:
            raise ValueError("run_stream() needs catalog_size and capacity (or carry=)")
        if horizon is None:
            # a one-shot api.run defaults horizon to the trace length; a
            # stream cannot, and tuning to the first segment would break the
            # parity with the one-shot replay
            raise ValueError(
                "run_stream() needs horizon= (the planned total stream length): a stream "
                "cannot infer it, and horizon-tuned policies would otherwise mis-tune to "
                "the first segment")
        if eta is None and pd.default_eta is not None:
            eta = pd.default_eta(int(catalog_size), int(capacity), int(horizon), window)
    elif (eta is not None or horizon is not None or n_slots is not None or seed != 0
          or costs is not None):
        raise ValueError(
            "run_stream(carry=...) resumes with the carry's parameters; do not pass "
            "seed/eta/horizon/n_slots/costs alongside a carry")

    st = _StreamState()
    t0_wall = time.perf_counter()

    def dispatch(seg: np.ndarray, block: bool):
        """One ``api.run`` over a segment (the first one starts the carry)."""
        nonlocal carry
        run_kw = dict(window=window, track_opt=False, name=name, sizes=sizes, block=block,
                      device=dev)
        if carry is None:
            res = api.run(pd, seg, catalog_size, capacity, seed=seed, eta=eta, horizon=horizon,
                          n_slots=n_slots, costs=costs, **run_kw)
            st.extras.update(res.extras)
        else:
            res = api.run(pd, seg, capacity=capacity, carry=carry, **run_kw)
        carry = res.carry
        st.device_seconds += res.wall_seconds
        return res

    def host_pass(seg: np.ndarray):
        """The dynamic-OPT accounting of a segment's ids: host work that
        needs the ids, not the device's results, so it overlaps the replay."""
        if opt_window is None:
            return
        t0 = time.perf_counter()
        st.opt_buf.append(seg)
        st.opt_buffered += len(seg)
        while st.opt_buffered >= opt_window:
            merged = np.concatenate(st.opt_buf) if len(st.opt_buf) > 1 else st.opt_buf[0]
            st.dyn_opt.append(float(best_static_hits(merged[:opt_window], int(capacity))))
            rest = merged[opt_window:]
            st.opt_buf[:] = [rest] if rest.size else []
            st.opt_buffered = rest.size
        st.host_seconds += time.perf_counter() - t0

    def consume(res):
        """Fold one segment's results into the accumulators: the only place
        the pipeline waits for the device."""
        t0 = time.perf_counter()
        res.consume()
        st.device_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        st.reward.append(np.asarray(res.reward, np.float64))
        st.hits.append(np.asarray(res.hits, np.int64))
        st.aux.append(np.asarray(res.aux, np.float64))
        st.occupancy.append(np.asarray(res.occupancy, np.float64))
        if res.byte_hits is not None:
            st.byte_hits.append(np.asarray(res.byte_hits, np.float64))
        st.bytes_total += res.bytes_total
        st.n_segments += 1
        st.t_used += res.T
        st.host_seconds += time.perf_counter() - t0

    def flush_dyn_opt_tail():
        """The replayed remainder shorter than one opt_window gets a last,
        shorter dynamic-OPT window, so the windows cover every request."""
        if opt_window is None or not st.opt_buffered:
            return
        t0 = time.perf_counter()
        merged = np.concatenate(st.opt_buf) if len(st.opt_buf) > 1 else st.opt_buf[0]
        st.dyn_opt.append(float(best_static_hits(merged, int(capacity))))
        st.opt_buf.clear()
        st.opt_buffered = 0
        st.host_seconds += time.perf_counter() - t0

    def result() -> StreamResult:
        return StreamResult(
            name=name or pd.name,
            kind=pd.kind,
            T=st.t_used,
            window=window,
            capacity=int(capacity) if capacity is not None else -1,
            reward=np.concatenate(st.reward),
            hits=np.concatenate(st.hits),
            aux=np.concatenate(st.aux),
            occupancy=np.concatenate(st.occupancy),
            opt_hits=0.0,
            carry=carry if keep_carry else None,
            wall_seconds=time.perf_counter() - t0_wall,
            extras=st.extras,
            byte_hits=(np.concatenate(st.byte_hits)
                       if len(st.byte_hits) == st.n_segments and st.n_segments else None),
            bytes_total=st.bytes_total,
            dyn_opt_hits=np.asarray(st.dyn_opt, np.float64) if opt_window is not None else None,
            dyn_opt_window=opt_window or 0,
            n_segments=st.n_segments,
            t_dropped=st.t_dropped,
            ingest_seconds=st.ingest_seconds,
            device_seconds=st.device_seconds,
            host_seconds=st.host_seconds,
            prefetch=prefetch,
        )

    def fault(err: _SourceError, pending) -> StreamFault:
        """Consume the in-flight segments, package the replayed prefix and
        pin the position of the source's failure."""
        for res in pending:
            consume(res)
        flush_dyn_opt_tail()
        partial = result() if st.t_used else None
        return StreamFault(
            f"chunk source failed after {st.t_ingested} ingested / {st.t_used} replayed "
            f"requests ({st.n_segments} segments): {err.cause!r}",
            t_ingested=st.t_ingested, t_replayed=st.t_used, n_segments=st.n_segments,
            partial=partial)

    pipeline(lambda: _assemble_segments(chunks, segment_len, window, catalog_size, st),
             dispatch, host_pass, consume, fault, prefetch, "run_stream")
    flush_dyn_opt_tail()
    if st.t_used == 0:
        raise ValueError(f"stream shorter than one window ({st.t_dropped} < {window})")
    return result()
