"""The slot automata (LRU, FIFO, LFU, FTPL): a chunk of requests a launch.

The reference runs these automata as ``lax.scan`` over requests
(``repro.cachesim.engines``' ``_lru_step``, ``_fifo_step``, ``_lfu_step``
and ``_ftpl_step``, scanned by ``repro.cachesim.api``'s dense automaton);
no Pallas kernel is involved.  On a CUDA tensor :func:`slot_automaton`
launches ``csrc/slot_automaton.cu`` once for the whole chunk: one block,
the slots spread over its threads in shared memory, the requests in order,
one block-wide argmin a request.  On a CPU tensor it runs the plain version
in :mod:`.ref`.  Either way the carry's tensors are updated in place.

The design holds at most :data:`MAX_SLOTS` slots (the keys live in one
block's shared memory); a larger CUDA carry raises.  It is the
``impl="dense"`` engine of LRU, LFU and FTPL, which run larger caches on
their tree automata (their default engine); ``policy_def("fifo")`` runs
on the FIFO queue (:mod:`repro_torch.kernels.fifo_queue`) at any size, and
this kernel's FIFO is its oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slot_automaton.ref import KINDS, slot_automaton_ref

#: the most slots one launch holds (kMaxSlots of csrc/slot_automaton.cu)
MAX_SLOTS = 16384
#: slots a thread may own (the kernel's instantiations)
PER_THREAD = (1, 2, 4, 8, 16)
#: slots a thread owns before the block grows by a warp
SLOTS_A_THREAD = 8


def plan(n_slots: int) -> dict:
    """Threads and slots a thread for a carry of ``n_slots`` slots: a warp
    for every 256 slots (8 a thread) up to 32 warps, then up to 16 a
    thread.  C = 25 runs on one warp with no ``__syncthreads`` a request;
    C = 1000 on 4 warps."""
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(
            f"the slot-automaton kernel holds 1 to {MAX_SLOTS} slots, got {n_slots}; "
            "lru, lfu and ftpl run larger caches on their tree automata (impl='tree', "
            "their default), and fifo on the FIFO queue (policy_def('fifo'))"
        )
    threads = 32 * min(32, -(-n_slots // (32 * SLOTS_A_THREAD)))
    need = -(-n_slots // threads)
    return {"threads": threads, "per_thread": next(p for p in PER_THREAD if p >= need)}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("slot_automaton").repro_slot_automaton
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def slot_automaton(
    kind: str,
    slots: torch.Tensor,
    keys: Optional[torch.Tensor],
    counts: Optional[torch.Tensor],
    noise: Optional[torch.Tensor],
    t: Optional[torch.Tensor],
    ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of automaton ``kind`` over int32 ``ids``, in place.

    ``slots`` (K,) int32 (-1 empty, -2 inactive); ``keys`` the (K,) int32
    stamps (lru, fifo) or ticks (lfu), None for ftpl; ``counts`` (N,) int32
    (lfu, ftpl); ``noise`` (N,) float32 (ftpl); ``t`` the () int32 request
    clock (lru, fifo, lfu).  Ids must lie in [0, N) (``run`` checks the
    trace).  Returns ``(hits, stats)``: the () int32 hit count and the (3,)
    float32 (reward, aux, occupancy) of the chunk.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown automaton kind {kind!r} (have {KINDS})")
    if slots.device.type == "cpu":
        return slot_automaton_ref(kind, slots, keys, counts, noise, t, ids)
    counted, clocked = kind in ("lfu", "ftpl"), kind != "ftpl"
    dev = slots.device
    _build.require(slots, torch.int32, "slots")
    _build.require(ids, torch.int32, "ids", dev)
    if ids.dim() != 1 or ids.numel() < 1:
        raise ValueError(f"ids must be a non-empty 1-D tensor, got shape {tuple(ids.shape)}")
    if clocked:
        _build.require(keys, torch.int32, "keys", dev)
        _build.require(t, torch.int32, "t", dev)
        if keys.shape != slots.shape or t.dim() != 0:
            raise ValueError("keys must match slots and t must be 0-d")
    if counted:
        _build.require(counts, torch.int32, "counts", dev)
    if kind == "ftpl":
        _build.require(noise, torch.float32, "noise", dev)
        if noise.shape != counts.shape:
            raise ValueError("noise must match counts")
    launch = plan(slots.numel())
    hits = torch.empty((), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    _build.check(
        _entry()(
            KINDS.index(kind), launch["per_thread"], launch["threads"], slots.numel(),
            ids.numel(), slots.data_ptr(), ptr(keys if clocked else None),
            ptr(counts if counted else None), ptr(noise if kind == "ftpl" else None),
            ptr(t if clocked else None), ids.data_ptr(), hits.data_ptr(), stats.data_ptr(),
            _build.stream_of(slots),
        ),
        "slot_automaton",
    )
    slot_automaton.launches += 1
    return hits, stats


slot_automaton.launches = 0
