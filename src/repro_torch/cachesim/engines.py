"""The comparison baselines on the device: slot automata and OMD.

Counterpart of ``repro.cachesim.engines``.  The paper's baselines, each as
a carry of tensors and a chunk step that :func:`repro_torch.cachesim.api.run`
calls once a chunk:

* **LRU / FIFO** — C slots with a stamp each (last use, or insertion);
  the victim is the least stamp.
* **LFU** — perfect-frequency counters over the catalog and slots with the
  host policy's ``(freq, tick)`` eviction key and its admission rule.
* **FTPL** — counters plus a one-shot float32 noise
  (:func:`repro_torch.core.ftpl.ftpl_noise`), top-C by single swaps.
* **OMD** — negative-entropy mirror descent: a log-weight step and a KL
  projection onto the capped simplex by safeguarded Newton sweeps.

An automaton's chunk is one launch of the slot-automaton kernel
(:func:`repro_torch.kernels.slot_automaton.ops.slot_automaton`), which
updates the carry in place; its plain version, the reference's
per-request steps, is :mod:`repro_torch.kernels.slot_automaton.ref`
(``_lru_step`` ... ``_ftpl_step``, re-exported here).  FIFO runs at any
capacity on a kernel of its own
(:func:`repro_torch.kernels.fifo_queue.ops.fifo_queue`): its victims walk
the active slots in an order that a run derives once from the carry
(:func:`start_fifo_run`, a :class:`FIFORunCarry`), so a request is O(1);
the carry's leaves stay the reference's, bit for bit.  OMD is plain PyTorch
around the port's histogram kernel: the gradient counts are one histogram
launch, the projection's 10 sweeps PyTorch ops on the device.

The reference's deprecated wrappers (``run_engine``, ``run_omd``,
``sweep_engine``) are not ported: ``api.run(api.policy_def(kind), ...)``
is the entry point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim.replay import _check_sample, MADOW_SAMPLES, sample_chunk_metrics
from repro_torch.core.ftpl import ftpl_initial_top_c, ftpl_noise, theoretical_zeta
from repro_torch.jaxcache.fractional import request_counts, warm_bracket_hi
from repro_torch.kernels.fifo_queue.ops import fifo_queue
from repro_torch.kernels.fifo_queue.ref import TICKET_NONE, FIFOQueue, derive_queue
from repro_torch.kernels.slot_automaton.ops import slot_automaton
from repro_torch.kernels.slot_automaton.ref import (  # noqa: F401  (the plain steps)
    I32_MAX,
    KINDS as ENGINE_KINDS,
    _fifo_step,
    _ftpl_step,
    _lfu_step,
    _lru_step,
)

DEFAULT_OMD_SWEEPS = 10


class SlotCarry(NamedTuple):
    """LRU / FIFO state: K slots with an eviction stamp each.

    Slot ids: -1 empty (fillable), -2 inactive (capacity padding; never
    matched, never evicted into).  LRU and FIFO never index by item, so the
    carry holds no catalog size (``catalog_size`` is None)."""

    slots: torch.Tensor  # (K,) int32 item ids
    stamps: torch.Tensor  # (K,) int32; empty -1, inactive INT32_MAX
    t: torch.Tensor  # () int32 request clock

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> Optional[int]:
        return None


class LFUCarry(NamedTuple):
    slots: torch.Tensor  # (K,) int32 item ids (-1 empty, -2 inactive)
    ticks: torch.Tensor  # (K,) int32 tie-break clock; inactive INT32_MAX
    counts: torch.Tensor  # (N,) int32 perfect-LFU counters
    t: torch.Tensor  # () int32

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> int:
        return self.counts.shape[0]


class FTPLCarry(NamedTuple):
    slots: torch.Tensor  # (K,) int32 item ids (-2 inactive; always C cached)
    counts: torch.Tensor  # (N,) int32 request counters
    noise: torch.Tensor  # (N,) float32 one-shot perturbation (constant)

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> int:
        return self.counts.shape[0]


class OMDCarry(NamedTuple):
    """Normalized log-weight state: f = min(1, exp(w)) is always feasible.

    The reference's whole-trace histogram leaf is not kept: ``run``
    computes hindsight OPT from the trace on the host."""

    f: torch.Tensor  # (N,) float32 fractional cache state
    w: torch.Tensor  # (N,) float32 log-weights, renormalized every chunk
    lam: torch.Tensor  # () float32 last chunk's KL-projection threshold


def _padded(active: np.ndarray, n_slots: int, inactive_val: int) -> np.ndarray:
    pad = n_slots - len(active)
    if pad < 0:
        raise ValueError(f"n_slots {n_slots} < capacity {len(active)}")
    return np.concatenate([active, np.full(pad, inactive_val, active.dtype)])


def init_engine_carry(
    kind: str,
    catalog_size: int,
    capacity: int,
    *,
    n_slots: Optional[int] = None,
    seed: int = 0,
    zeta: Optional[float] = None,
    horizon: Optional[int] = None,
    device: DeviceLike = None,
):
    """The initial carry of one automaton, on ``device`` (the card unless
    "cpu" is asked for).  ``n_slots`` > capacity pads with inactive slots."""
    dev = resolve_device(device)
    K = int(n_slots) if n_slots else int(capacity)
    C = int(capacity)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def zero_clock():
        return torch.zeros((), dtype=torch.int32, device=dev)

    empty = np.full(C, -1, np.int32)
    if kind in ("lru", "fifo"):
        return SlotCarry(slots=put(_padded(empty, K, -2)),
                         stamps=put(_padded(empty, K, I32_MAX)), t=zero_clock())
    if kind == "lfu":
        return LFUCarry(
            slots=put(_padded(empty, K, -2)),
            ticks=put(_padded(empty, K, I32_MAX)),
            counts=torch.zeros(catalog_size, dtype=torch.int32, device=dev),
            t=zero_clock(),
        )
    if kind == "ftpl":
        if zeta is None:
            if horizon is None:
                raise ValueError("ftpl needs zeta or horizon")
            zeta = theoretical_zeta(C, catalog_size, horizon)
        noise = ftpl_noise(catalog_size, zeta, seed=seed)
        top = ftpl_initial_top_c(noise, C).astype(np.int32)
        return FTPLCarry(
            slots=put(_padded(top, K, -2)),
            counts=torch.zeros(catalog_size, dtype=torch.int32, device=dev),
            noise=put(noise),
        )
    raise ValueError(f"unknown engine kind {kind!r} (have {ENGINE_KINDS})")


def automaton_args(kind: str, carry) -> tuple:
    """The carry of automaton ``kind`` as the slot-automaton kernel takes
    it: ``(slots, keys, counts, noise, t)``, None where the kind has none."""
    if kind in ("lru", "fifo"):
        return carry.slots, carry.stamps, None, None, carry.t
    if kind == "lfu":
        return carry.slots, carry.ticks, carry.counts, None, carry.t
    return carry.slots, None, carry.counts, carry.noise, None


def automaton_chunk(kind: str, carry, ids: torch.Tensor):
    """One chunk of automaton ``kind``: one slot-automaton launch on the
    card (the plain version on the CPU), the carry updated in place.
    Returns ``(carry, (hits, stats))``, stats the (3,) float32 (reward,
    aux, occupancy)."""
    return carry, slot_automaton(kind, *automaton_args(kind, carry), ids)


class FIFORunCarry(NamedTuple):
    """A FIFO carry during a run: the reference's leaves and the queue the
    run derived from them (:func:`start_fifo_run`)."""

    slots: torch.Tensor  # (K,) int32 item ids (-1 empty, -2 inactive)
    stamps: torch.Tensor  # (K,) int32 insertion clock; empty -1, inactive INT32_MAX
    t: torch.Tensor  # () int32 request clock
    queue: FIFOQueue

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def catalog_size(self) -> Optional[int]:
        return None


def start_fifo_run(carry: SlotCarry, id_bound: Optional[int] = None) -> FIFORunCarry:
    """A private copy of a FIFO carry with its queue derived for items in
    [0, id_bound): the run's one pass over the slots (and one read of the
    device, for the largest item they hold)."""
    if id_bound is None:
        raise ValueError("a FIFO run needs id_bound, a bound on the ids it will see")
    slots, stamps, t = (x.clone() for x in carry[:3])
    return FIFORunCarry(slots, stamps, t, derive_queue(slots, stamps, id_bound))


def finish_fifo_run(carry: FIFORunCarry) -> SlotCarry:
    """The reference's carry at the end of a run."""
    return SlotCarry(carry.slots, carry.stamps, carry.t)


def fifo_chunk(carry: FIFORunCarry, ids: torch.Tensor, flags: Optional[torch.Tensor] = None):
    """One FIFO chunk: one ``fifo_queue`` launch on the card (the plain
    version on the CPU), the carry updated in place.  Returns ``(carry,
    (hits, stats))``; ``flags`` where given gets each request's hit."""
    return carry, fifo_queue(carry.slots, carry.stamps, carry.t, carry.queue, ids, flags)


class FIFOGridCarry(NamedTuple):
    """A sweep's FIFO combos during a run, stacked a row a combo: the
    carries' leaves, each combo's queue (``order`` padded to the slot count,
    ``imap`` to the longest), and each combo's active slots."""

    slots: torch.Tensor  # (R, K) int32
    stamps: torch.Tensor  # (R, K) int32
    t: torch.Tensor  # (R,) int32
    queue: FIFOQueue  # order (R, K), imap (R, M), head, occ, misses (R,)
    active: tuple  # (R,) ints: the combos' active slots


def start_fifo_grid(carries, id_bound: Optional[int] = None) -> FIFOGridCarry:
    """The FIFO combos of a grid (one slot count) stacked, each with its
    queue derived as :func:`start_fifo_run` derives a run's."""
    runs = [start_fifo_run(c, id_bound) for c in carries]
    k = runs[0].slots.shape[0]
    width = max(r.queue.imap.shape[0] for r in runs)
    order = torch.zeros((len(runs), k), dtype=torch.int32, device=runs[0].slots.device)
    imap = torch.full((len(runs), width), TICKET_NONE, dtype=torch.int32, device=order.device)
    for row, r in enumerate(runs):
        order[row, :r.queue.order.shape[0]] = r.queue.order
        imap[row, :r.queue.imap.shape[0]] = r.queue.imap
    queue = FIFOQueue(order=order, head=torch.stack([r.queue.head for r in runs]), imap=imap,
                      occ=torch.stack([r.queue.occ for r in runs]),
                      misses=torch.stack([r.queue.misses for r in runs]))
    return FIFOGridCarry(torch.stack([r.slots for r in runs]),
                         torch.stack([r.stamps for r in runs]),
                         torch.stack([r.t for r in runs]), queue,
                         tuple(r.queue.order.shape[0] for r in runs))


def fifo_grid_chunk(grid: FIFOGridCarry, ids: torch.Tensor,
                    flags: Optional[torch.Tensor] = None):
    """One chunk of every FIFO combo of a grid, in place: one ``fifo_queue``
    launch a plan on the card (at most two), the plain version row by row
    on the CPU.  Returns ``(grid, (hits, stats))``, hits (R,), stats (R, 3)."""
    return grid, fifo_queue(grid.slots, grid.stamps, grid.t, grid.queue, ids, flags,
                            active=grid.active)


def split_fifo_grid(grid: FIFOGridCarry) -> list:
    """Each combo's carry at the end of a run, as :func:`finish_fifo_run`
    gives it (views of the grid's rows)."""
    return [SlotCarry(grid.slots[r], grid.stamps[r], grid.t[r]) for r in range(len(grid.active))]


def _occ_slots(carry) -> torch.Tensor:
    return (carry.slots >= 0).sum(dtype=torch.int32)


def _omd_project(w: torch.Tensor, cap: torch.Tensor, hi: torch.Tensor, sweeps: int):
    """Safeguarded-Newton KL threshold: lam with sum min(1, e^(w-lam)) = C.

    For feasible pre-step weights the root lies in [0, hi], hi covering the
    added gradient mass eta*B: g is convex and decreasing, so Newton from
    the mass-excess side converges monotonically and the bisection midpoint
    safeguards the other side.  The safeguard is the reference's
    (``t_newton >= lo and <= hi``, endpoints accepted), kept so that the
    port agrees with it (ROADMAP.md §3)."""
    lo = torch.zeros((), dtype=torch.float32, device=w.device)
    t = lo
    hi = hi.to(torch.float32)
    for _ in range(sweeps):
        e = torch.exp(w - t)
        mass = torch.clamp(e, max=1.0).sum()
        interior = torch.where(e < 1.0, e, 0.0).sum()
        too_much = mass >= cap
        lo = torch.where(too_much, t, lo)
        hi = torch.where(too_much, hi, t)
        t_newton = t + (mass - cap) / torch.clamp(interior, min=1e-12)
        t_mid = 0.5 * (lo + hi)
        ok = (t_newton >= lo) & (t_newton <= hi)
        t = torch.where(ok, t_newton, t_mid)
    return t


def _make_omd_step(sample: str, sweeps: int, madow_capacity: Optional[int] = None):
    """The per-chunk OMD update with eta and capacity as 0-d tensors — the
    mirror-descent counterpart of :func:`repro_torch.cachesim.replay._make_ogb_step`.

    Returns ``step(eta, p, cap, state, ids, u) -> (state', (reward, hits,
    lam, occupancy))`` over an :class:`OMDCarry` state.  The gradient step
    is ``w + eta * counts``, the counts from the histogram kernel; the
    reference adds eta once per duplicate id (``w.at[ids].add(eta)``), so
    the two differ within float32 rounding where an id repeats."""
    _check_sample(sample)
    if sample in MADOW_SAMPLES and madow_capacity is None:
        raise ValueError("madow sampling needs a static capacity")

    def step(eta, p, cap, state: OMDCarry, ids, u):
        f, w, _lam = state
        reward, hits, occ = sample_chunk_metrics(sample, madow_capacity, f, ids, p, u)
        w = w + eta * request_counts(ids, w.shape[0])
        lam = _omd_project(w, cap, warm_bracket_hi(eta * float(ids.shape[0])), sweeps)
        w = w - lam  # renormalize: f = min(1, e^w) stays threshold-free
        f_new = torch.clamp(torch.exp(w), max=1.0)
        return OMDCarry(f_new, w, lam), (reward, hits, lam, occ)

    return step


def init_omd_carry(catalog_size: int, capacity: int, device: DeviceLike = None) -> OMDCarry:
    dev = resolve_device(device)
    f0 = capacity / catalog_size
    return OMDCarry(
        f=torch.full((catalog_size,), f0, dtype=torch.float32, device=dev),
        w=torch.full((catalog_size,), float(np.log(f0)), dtype=torch.float32, device=dev),
        lam=torch.zeros((), dtype=torch.float32, device=dev),
    )
