"""FIFO at any capacity: a chunk of requests a launch.

The reference runs FIFO as ``lax.scan`` over its per-request step
(``repro.cachesim.engines._fifo_step``, a compare and an argmin over every
slot); no Pallas kernel is involved.  Its victims walk the active slots in
one order fixed at the start of a run (:mod:`.ref`), so a request is O(1)
given that order and each item's admission ticket, derived once a run
(:func:`~.ref.derive_queue`).  On a CUDA tensor :func:`fifo_queue`
launches ``csrc/fifo_queue.cu`` once for the whole chunk, in one of two
plans by the active slots (:func:`design`): from TILE_MIN_SLOTS a block
resolves a tile of 32 to 1024 requests at once (:func:`tile_requests`),
below it one warp takes the requests in order.  On a CPU tensor it runs
the plain version, :func:`~.ref.fifo_queue_ref`.  Either way the carry and
the derived state are updated in place.

A sweep's grid of combos runs a block a combo over the shared ids, one
launch for each plan its combos' active slots call for (at most two), each
row bit for bit its combo's single launch; a single chunk is the grid of
one combo.  A fleet's tenants take the same launches over a row of ids
each, (R, window) ids with a row stride.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fifo_queue.ref import FIFOQueue, fifo_queue_rows_ref

#: the active slots from which a chunk runs the tile plan (kTileMinSlots):
#: below it a tile may evict what it admits
TILE_MIN_SLOTS = 32
#: the most warps of a tile (kTileWarps), and the active slots a warp of it
#: (kSlotsPerWarp): a tile is 32 requests a warp, at most A / 32
TILE_WARPS, SLOTS_PER_WARP = 32, 1024
#: the designs the wrapper counts its launches under, by plan
DESIGN = ("tile: one block a chunk, admission tickets; a tile of 32 to 1024 requests (a "
          "thread each, a warp a 1024 active slots) resolved at once: first occurrences by "
          "a shared hash of the tile's ids, ranks by __ballot_sync and a warp scan, the "
          "requests an eviction of the tile may reach settled in order by one warp; the next "
          "tile's tickets and victims loaded a tile ahead, its tickets patched from the hash")
DESIGN_CHAIN = ("chain: one warp a chunk, admission tickets; the requests in order, each "
                "ticket broadcast from its lane")


def design(active: int) -> str:
    """The plan a chunk over ``active`` active slots runs."""
    return DESIGN if active >= TILE_MIN_SLOTS else DESIGN_CHAIN


def tile_requests(active: int) -> int:
    """The requests of one tile of the tile plan over ``active`` slots."""
    return 32 * min(TILE_WARPS, max(1, active // SLOTS_PER_WARP))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("fifo_queue").repro_fifo_queue
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, p, p, ll, ll, ll, ll, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grid_plans(device: torch.device, active: Tuple[int, ...]):
    """A grid's launches: its combos' active slots on ``device``, and for
    each plan its combos call for, (design, warps a block, the combos' rows
    on the device)."""
    plans = []
    for tile in (True, False):
        rows = [r for r, a in enumerate(active) if (a >= TILE_MIN_SLOTS) == tile]
        if rows:
            warps = max(tile_requests(active[r]) // 32 for r in rows) if tile else 1
            plans.append((DESIGN if tile else DESIGN_CHAIN, warps,
                          torch.tensor(rows, dtype=torch.int32, device=device)))
    return torch.tensor(active, dtype=torch.int32, device=device), tuple(plans)


def fifo_queue(
    slots: torch.Tensor,
    stamps: torch.Tensor,
    t: torch.Tensor,
    queue: FIFOQueue,
    ids: torch.Tensor,
    flags: Optional[torch.Tensor] = None,
    active: Optional[Tuple[int, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FIFO chunk over int32 ``ids`` (each below ``queue.imap``'s
    length; at most :data:`~.ref.MAX_REQUESTS` since the queue was derived),
    in place: ``slots`` and ``stamps`` (K,) int32, the () int32 clock ``t``
    and the run's :class:`~.ref.FIFOQueue`.

    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward, aux, occupancy); ``flags``, a (window,) bool tensor where given,
    gets each request's hit.

    A grid of R combos: ``slots``, ``stamps`` (R, K), ``t`` (R,), the
    queue's fields stacked a row a combo (``order`` (R, K), combo r's first
    ``active[r]`` entries its order; ``imap`` (R, M); the scalars (R,)),
    ``active`` the combos' active slots, ``ids`` one (window,) chunk for
    every combo or (R, window), a row of ids a combo, ``flags`` (R,
    window); hits (R,) and stats (R, 3), from one launch a plan.  One combo
    is the grid of its one row."""
    if slots.dim() == 1:
        hits, stats = fifo_queue(slots[None], stamps[None], t[None],
                                 FIFOQueue(*(x[None] for x in queue)), ids,
                                 None if flags is None else flags[None],
                                 active=(queue.order.numel(),))
        return hits[0], stats[0]
    rows = slots.shape[0]
    active = tuple(int(a) for a in active)
    if len(active) != rows or not all(0 < a <= queue.order.shape[1] for a in active):
        raise ValueError(f"active must give each of the {rows} combos' 1 .. "
                         f"{queue.order.shape[1]} active slots, got {active}")
    window = ids.shape[-1] if ids.dim() else 0
    if ids.dim() not in (1, 2) or window < 1 or (ids.dim() == 2 and ids.shape[0] != rows):
        raise ValueError(f"ids must be a non-empty (window,) chunk or ({rows}, window), got "
                         f"shape {tuple(ids.shape)}")
    if slots.device.type == "cpu":
        return fifo_queue_rows_ref(slots, stamps, t, queue, ids, flags, active)
    dev = slots.device
    for name, x in (("slots", slots), ("stamps", stamps), ("t", t), ("order", queue.order),
                    ("head", queue.head), ("imap", queue.imap), ("occ", queue.occ),
                    ("misses", queue.misses), ("ids", ids)):
        _build.require(x, torch.int32, name, dev)
    if stamps.shape != slots.shape or queue.imap.dim() != 2 or any(
            x.shape != (rows,) for x in (t, queue.head, queue.occ, queue.misses)) or \
            queue.order.shape[0] != rows or queue.imap.shape[0] != rows:
        raise ValueError("the carry and the queue must hold a row a combo: t, head, occ and "
                         "misses (R,) (0-d for one combo)")
    if flags is not None:
        _build.require(flags, torch.bool, "flags", dev)
        if flags.shape != (rows, window):
            raise ValueError("flags must match ids, a row a combo")
    hits = torch.empty(rows, dtype=torch.int32, device=dev)
    stats = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    actives, plans = _grid_plans(dev, active)
    for plan, warps, plan_rows in plans:
        _build.check(
            _entry()(
                window, ids.data_ptr(), slots.data_ptr(), stamps.data_ptr(), t.data_ptr(),
                queue.order.data_ptr(), queue.head.data_ptr(), queue.misses.data_ptr(),
                queue.imap.data_ptr(), queue.occ.data_ptr(),
                flags.data_ptr() if flags is not None else None, hits.data_ptr(),
                stats.data_ptr(), plan_rows.numel(), plan_rows.data_ptr(), actives.data_ptr(),
                slots.shape[1], queue.order.shape[1], queue.imap.shape[1],
                window if ids.dim() == 2 else 0, int(plan == DESIGN),
                warps, _build.stream_of(slots),
            ),
            "fifo_queue",
        )
        _build.counted(fifo_queue, plan)
    return hits, stats


fifo_queue.launches = 0
fifo_queue.designs = {}
