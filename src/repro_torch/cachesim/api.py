"""The policy protocol and the replay loop.

Counterpart of ``repro.cachesim.api``: a :class:`PolicyDef` is an
``(init, step)`` pair whose carry holds the policy state and its parameters
(eta, capacity, sampling randomness) as tensors, and :func:`run` replays a
trace through it.  Registered kinds (:func:`policy_def_kinds`):

* ``ogb`` with Poisson, Madow (``madow``, ``madow_tree``) or no sampling,
  and the lazy bucketized ``ogb_tree``; ``ogb_grad``, the dense-gradient
  step an expert cache takes (not trace driven);
* ``omd``, negative-entropy mirror descent (:mod:`.engines`);
* the automata ``lru``, ``fifo``, ``lfu`` and ``ftpl``.  As in the
  reference, ``lru``, ``lfu`` and ``ftpl`` default to the O(log) tree
  automata (``impl="tree"``: one ``tree_lru`` or ``minpair_automaton``
  launch a chunk, :mod:`.tree_engines`), and ``impl="dense"`` runs the slot
  automaton (one ``slot_automaton`` launch a chunk, at most 16 384 slots),
  the differential oracle; both give bit-identical hit sequences.  FIFO has
  no tree form and runs dense, at any capacity: one ``fifo_queue`` launch a
  chunk over the order its victims take (:func:`.engines.start_fifo_run`);
* the sized axis: ``gds`` (GreedyDual-Size on the min-pair trees, one
  ``minpair_automaton`` launch a chunk) and ``ogb_sized`` (the paper's §8
  size-aware OGB: ``flavor="tree"``, K stacked bucket trees, or the dense
  ``flavor="scan"``).  ``run(..., sizes=)`` gives every automaton byte
  accounting (``RunResult.byte_hits``, ``byte_hit_ratio``); the unit
  policies reject ``sizes``/``costs``, as in the reference.

:func:`sweep` replays a (seeds x etas x capacities) grid of combos over
one trace.  Where a kind has a grid form (``PolicyDef.batched``: dense
``ogb`` with Poisson or no sampling and the warm projection, the tree
``lru``, ``lfu`` and ``ftpl``, and ``fifo``) the combos' carries are stacked
and each chunk is one launch for the whole grid of each kernel it runs (the
histogram and the warm projection; ``tree_lru``; ``minpair_automaton``;
``fifo_queue`` a plan), each row bit for bit the combo's own run; other
kinds run their combos one after another.  A grid's step takes one (W,)
chunk for every row (a sweep) or (R, W) ids, a row of its own ids each row:
that is how :func:`repro_torch.cachesim.fleet.run_fleet` steps a fleet's
tenants, each replaying its own stream, in the same launches.
:func:`register_policy_def` adds a kind.

The reference's ``lax.scan`` becomes a Python loop over chunks on the
device.  Per-chunk outputs go into preallocated device tensors, and
:func:`run` synchronises once at the end (``block=False``: not at all, until
``RunResult.consume``); the only reads inside the loop are
``ogb_tree``'s re-anchor checks, one every few dozen chunks at most (the
tree LRU decides its ring compactions on the device).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import engines as _engines
from repro_torch.cachesim import tree_engines as _tree
from repro_torch.cachesim.replay import (
    MADOW_SAMPLES,
    _make_ogb_step,
    opt_hits_by_combo,
    sampling_keys,
)
from repro_torch.cachesim.tree_engines import (
    OGBTreeCarry,
    SizedOGBTreeCarry,
    TreeFTPLCarry,
    TreeGDSCarry,
    TreeLFUCarry,
    TreeLRUCarry,
)
from repro_torch.cachesim.results import RunResult, SweepResult
from repro_torch.core.ogb import theoretical_eta
from repro_torch.core.omd import theoretical_eta_omd
from repro_torch.core.regret import best_static_hits
from repro_torch.jaxcache.fractional import (
    DEFAULT_BISECT_ITERS,
    DEFAULT_WARM_SWEEPS,
    capped_simplex_project,
    poisson_sample,
)
from repro_torch.kernels.capped_simplex.ops import weighted_simplex_project
from repro_torch.kernels.fifo_queue.ref import MAX_REQUESTS as FIFO_MAX_REQUESTS

__all__ = [
    "Batched",
    "OGBCarry",
    "OGBTreeCarry",
    "OMDApiCarry",
    "PolicyDef",
    "SizedAutomatonCarry",
    "SizedOGBScanCarry",
    "SizedOGBTreeCarry",
    "StepOut",
    "SweepResult",
    "TreeFTPLCarry",
    "TreeGDSCarry",
    "TreeLFUCarry",
    "TreeLRUCarry",
    "carry_from_numpy",
    "policy_def",
    "policy_def_kinds",
    "register_policy_def",
    "run",
    "sweep",
]


class StepOut(NamedTuple):
    """Per-chunk observables of a policy step, 0-d tensors on the device.

    ``reward`` is the pre-update fractional reward (OCO order), the hits
    for the automata; ``aux`` is the projection threshold (tau for OGB,
    lambda for OMD, 0 for the automata).  ``byte_hits`` is the bytes the
    chunk's hits served (sized runs; None otherwise), summed in float64:
    exact for integer sizes up to 2^53 bytes a chunk."""

    reward: torch.Tensor  # () float32
    hits: torch.Tensor  # () int32
    aux: torch.Tensor  # () float32
    occupancy: torch.Tensor  # () float32
    byte_hits: Optional[torch.Tensor] = None  # () float64 for sized runs


class OGBCarry(NamedTuple):
    """OGB_cl state with its parameters, all tensors on one device."""

    f: torch.Tensor  # (N,) float32 fractional state
    tau: torch.Tensor  # () float32 previous chunk's projection threshold
    eta: torch.Tensor  # () float32 learning rate
    cap: torch.Tensor  # () float32 capacity
    p: torch.Tensor  # (N,) permanent random numbers (poisson) or (0,)
    u_key: torch.Tensor  # () int64 key of the per-chunk Madow offsets
    t: torch.Tensor  # () int32 chunk counter

    @property
    def device(self) -> torch.device:
        return self.f.device

    @property
    def catalog_size(self) -> int:
        return self.f.shape[0]


class OMDApiCarry(NamedTuple):
    """OMD log-weight state with its parameters, all tensors on one device."""

    f: torch.Tensor  # (N,) float32 fractional state
    w: torch.Tensor  # (N,) float32 log-weights (renormalized every chunk)
    lam: torch.Tensor  # () float32 last KL-projection threshold
    eta: torch.Tensor  # () float32
    cap: torch.Tensor  # () float32
    p: torch.Tensor  # (N,) permanent random numbers (poisson) or (0,)
    u_key: torch.Tensor  # () int64 key of the per-chunk Madow offsets
    t: torch.Tensor  # () int32 chunk counter

    @property
    def device(self) -> torch.device:
        return self.f.device

    @property
    def catalog_size(self) -> int:
        return self.f.shape[0]


class SizedAutomatonCarry(NamedTuple):
    """An automaton's carry with per-item byte sizes.  The automaton is
    size-blind (the same decisions and hits as without sizes); the sizes
    weight its hits, so its steps report ``byte_hits``."""

    inner: Any  # the automaton's own carry (tree, dense or FIFO)
    szs: torch.Tensor  # (N,) float32 sizes (bytes)

    @property
    def device(self) -> torch.device:
        return self.szs.device

    @property
    def catalog_size(self) -> int:
        return self.szs.shape[0]


class SizedOGBScanCarry(NamedTuple):
    """Dense (scan-flavor) sized OGB: exact per-item sizes and an O(N)
    weighted projection a chunk, the differential oracle of the tree
    flavor.  Sizes and costs are normalized by their mean (``sref``), and
    byte outputs scaled back by it."""

    f: torch.Tensor  # (N,) float32 projected fractional state
    tau: torch.Tensor  # () float32 last weighted-projection threshold
    eta: torch.Tensor  # () float32
    cap: torch.Tensor  # () float32 capacity in normalized bytes
    s: torch.Tensor  # (N,) float32 normalized sizes
    wts: torch.Tensor  # (N,) float32 normalized gradient weights (costs)
    sref: torch.Tensor  # () float32 bytes a normalized size unit
    p: torch.Tensor  # (N,) float32 permanent random numbers, or (0,)
    t: torch.Tensor  # () int32 chunk counter

    @property
    def device(self) -> torch.device:
        return self.f.device

    @property
    def catalog_size(self) -> int:
        return self.f.shape[0]


def _sizes_tensor(sizes, catalog_size: int, dev: torch.device) -> torch.Tensor:
    s = np.asarray(sizes, np.float32)
    if s.shape != (int(catalog_size),):
        raise ValueError(f"sizes must be a ({catalog_size},) array, got {s.shape}")
    if not (np.all(np.isfinite(s)) and float(s.min()) > 0.0):
        raise ValueError("sizes must be finite and > 0")
    return torch.from_numpy(s).to(dev)


def _unit_only(kind: str, sizes, costs) -> None:
    if sizes is not None or costs is not None:
        raise ValueError(f"{kind} is unit-size; use policy_def('ogb_sized') for per-item "
                         "sizes/costs")


class Batched(NamedTuple):
    """A kind's grid form: how :func:`sweep` steps all its combos at once.

    ``start(carries, id_bound) -> grid`` stacks the combos' initial carries
    a row a combo (a private copy, with what a run derives from them);
    ``split(grid) -> list`` gives each combo's final carry, of the kind's
    own type, as :func:`run` would have returned it.  The kind's own
    ``step`` takes one chunk for every combo of the grid, each StepOut leaf
    (R,); ``step``, where given, replaces it for the grid (the LRU's host
    bounds a combo, FIFO's active slots a combo)."""

    start: Callable[..., Any]
    split: Callable[[Any], list]
    step: Optional[Callable[[Any, torch.Tensor], Tuple[Any, StepOut]]] = None


@dataclass(frozen=True)
class PolicyDef:
    """An ``(init, step)`` caching policy.

    ``init(catalog_size, capacity, *, seed, eta, horizon, device) -> carry``;
    ``step(carry, ids) -> (carry, StepOut)``.  ``default_eta`` resolves
    ``eta=None`` at :func:`run` time from ``(catalog_size, capacity,
    horizon, window)``.  ``start(carry, id_bound) -> carry``, where given,
    prepares the carry a run starts from (a private copy where the step
    updates in place, with what the run derives from it: ``ogb_tree``'s and
    ``ogb_sized``'s host bounds, FIFO's queue over ids below ``id_bound``),
    and ``finish(carry) -> carry`` turns the run's carry back into the
    policy's own (FIFO).  ``fractional`` policies are scored by their
    fractional reward (regret); ``trace_driven`` steps take request-id
    chunks.  ``batched``, where given, is the kind's grid form
    (:class:`Batched`); :func:`sweep` runs the combos of a kind without one
    one after another.
    """

    kind: str
    name: str
    init: Callable[..., Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOut]]
    default_eta: Optional[Callable[[int, int, int, int], float]] = None
    start: Optional[Callable[..., Any]] = None
    finish: Optional[Callable[[Any], Any]] = None
    fractional: bool = False
    trace_driven: bool = True
    batched: Optional[Batched] = None


def _stack_rows(carries, id_bound=None):
    """The combos' carries stacked a row a combo (every leaf a new tensor)."""
    del id_bound
    return type(carries[0])(*(torch.stack(leaves) for leaves in zip(*carries)))


def _split_rows(grid) -> list:
    """Each combo's carry of a grid stacked by :func:`_stack_rows` (views)."""
    return [type(grid)(*(x[r] for x in grid)) for r in range(grid[0].shape[0])]


_GOLDEN64 = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _i64(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _chunk_u(u_key: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-chunk Madow offset in [0, 1): output t of splitmix64 seeded with
    ``u_key``, counter-mode so streamed and resumed runs draw the same
    sequence.  int64 tensor ops that wrap as uint64 arithmetic does: the
    same bits on the CPU and the card, with no read on the host.  (The
    reference's threefry offsets cannot be reproduced; tests feed them.)"""
    z = u_key + (t.to(torch.int64) + 1) * _i64(_GOLDEN64)
    z = (z ^ _shr(z, 30)) * _i64(_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_MIX2)
    z = z ^ _shr(z, 31)
    return _shr(z, 40).to(torch.float32) * (1.0 / (1 << 24))


def _ogb_def(
    sample: str = "poisson",
    projection: str = "warm",
    sweeps: int = DEFAULT_WARM_SWEEPS,
    iters: int = DEFAULT_BISECT_ITERS,
    madow_capacity: Optional[int] = None,
) -> PolicyDef:
    raw = _make_ogb_step(sample, projection, sweeps, iters, madow_capacity)
    madow = sample in MADOW_SAMPLES

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
        _unit_only("ogb", sizes, costs)
        if eta is None:
            raise ValueError("ogb init needs eta (run() resolves eta=None)")
        if madow and int(madow_capacity) != int(capacity):
            raise ValueError(
                f"madow needs a static capacity: policy_def('ogb', "
                f"sample={sample!r}, madow_capacity={capacity}) "
                f"(got {madow_capacity})"
            )
        dev = resolve_device(device)
        p, u_key = sampling_keys(seed, catalog_size, sample, dev)
        return OGBCarry(
            f=torch.full((catalog_size,), capacity / catalog_size, dtype=torch.float32,
                         device=dev),
            tau=torch.zeros((), dtype=torch.float32, device=dev),
            eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
            cap=torch.tensor(float(capacity), dtype=torch.float32, device=dev),
            p=p,
            u_key=u_key,
            t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(carry, ids):
        u = _chunk_u(carry.u_key, carry.t) if madow else None
        f, tau, (reward, hits, tau_o, occ) = raw(
            carry.eta, carry.p, carry.cap, carry.f, carry.tau, ids, u
        )
        carry = carry._replace(f=f, tau=tau, t=carry.t + 1)
        return carry, StepOut(reward, hits, tau_o, occ)

    # the grid form: the same step over (R, N) f and p, one histogram and
    # one warm-projection launch a chunk for every combo (Madow's static
    # capacity and the bisection run combo by combo)
    grid = None
    if not madow and projection == "warm":
        grid = Batched(start=_stack_rows, split=_split_rows)

    return PolicyDef(
        kind="ogb",
        name="OGB",
        init=init,
        step=step,
        # Theorem 3.1 tuning at B=1, as the reference's default
        default_eta=lambda N, C, T, W: theoretical_eta(C, N, T, 1),
        fractional=True,
        batched=grid,
    )


def _ogb_tree_def(
    sample: str = "poisson",
    buckets: int = _tree.OGB_TREE_BUCKETS,
    radix: int = _tree.OGB_TREE_RADIX,
    iters: int = _tree.OGB_TREE_ITERS,
    batch_hint: int = 4096,
) -> PolicyDef:
    """Lazy bucketized OGB: per-chunk work independent of the catalog size.

    Same gradient step and hit accounting as ``ogb``; the per-chunk
    projection is a scalar threshold solve over a V-bucket histogram of the
    accumulated values (``bucket_mass`` kernel launches).  ``sample`` is
    limited to ``"poisson"``/``"none"``: Madow needs the full fractional
    vector.
    """
    if sample not in ("poisson", "none"):
        raise ValueError(
            f"ogb_tree supports sample='poisson'|'none' (got {sample!r}); "
            "use policy_def('ogb', sample='madow_tree', ...) for Madow"
        )

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
        _unit_only("ogb_tree", sizes, costs)
        if eta is None:
            raise ValueError("ogb_tree init needs eta (run() resolves eta=None)")
        return _tree.init_ogb_tree_carry(
            catalog_size, capacity, eta=eta, seed=seed, sample=sample, buckets=buckets,
            radix=radix, batch_hint=batch_hint, device=device,
        )

    def step(carry, ids):
        chunk = _tree.make_ogb_tree_chunk(buckets, radix, sample, iters)
        carry, (reward, hits, dtau, occ) = chunk(carry, ids)
        return carry, StepOut(reward, hits, dtau, occ)

    return PolicyDef(
        kind="ogb_tree",
        name="OGB_tree",
        init=init,
        step=step,
        default_eta=lambda N, C, T, W: theoretical_eta(C, N, T, 1),
        start=_tree.start_run,
        fractional=True,
    )


def _ogb_grad_def(iters: int = DEFAULT_BISECT_ITERS) -> PolicyDef:
    """OGB on dense gradient vectors, the serving-side flavor.

    ``step(carry, grad)`` takes a raw weight per item (routed token counts
    per (layer, expert)), normalizes it to unit mass and takes one
    fractional OGB step: ``StepOut.reward`` is the weighted resident mass
    and ``hits`` the count of requested items resident, both under the
    carried Poisson sample before the update, ``aux`` the projection's tau
    and ``occupancy`` the items resident after it.  The projection is the
    bisection, ``iters`` mass passes and the final clip (on the card
    ``iters`` K = 1 ``masses`` launches and one standalone ``apply``).
    Swap telemetry is the consumer's, from the residency masks
    (:class:`repro_torch.serve.expert_cache.OGBExpertCache`).  Not trace
    driven: ``run_fleet`` refuses it and the scenarios skip it.  p comes
    from the port's own seeded generator; a carry from
    :func:`carry_from_numpy` brings the reference's."""

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del horizon, n_slots
        if sizes is not None or costs is not None:
            raise ValueError("ogb_grad is unit-size (weights ride the gradient vector); "
                             "sizes/costs unsupported")
        if eta is None:
            raise ValueError("ogb_grad init needs eta")
        dev = resolve_device(device)
        p, u_key = sampling_keys(seed, catalog_size, "poisson", dev)
        return OGBCarry(
            f=torch.full((catalog_size,), capacity / catalog_size, dtype=torch.float32,
                         device=dev),
            tau=torch.zeros((), dtype=torch.float32, device=dev),
            eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
            cap=torch.tensor(float(capacity), dtype=torch.float32, device=dev),
            p=p,
            u_key=u_key,
            t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(carry, grad):
        grad = grad.to(torch.float32)
        norm = grad / torch.clamp_min(grad.sum(), 1.0)  # unit-mass per-step gradient
        resident = poisson_sample(carry.f, carry.p)
        reward = torch.sum(norm * resident)
        hits = torch.sum((grad > 0) & resident, dtype=torch.int32)
        f, tau = capped_simplex_project(carry.f, norm, carry.eta, carry.cap, iters)
        carry = carry._replace(f=f, tau=tau, t=carry.t + 1)
        occupancy = torch.sum(poisson_sample(f, carry.p), dtype=torch.float32)
        return carry, StepOut(reward, hits, tau, occupancy)

    return PolicyDef(kind="ogb_grad", name="OGB_grad", init=init, step=step, fractional=True,
                     trace_driven=False)


def _omd_def(
    sample: str = "poisson",
    sweeps: int = _engines.DEFAULT_OMD_SWEEPS,
    madow_capacity: Optional[int] = None,
) -> PolicyDef:
    """Online mirror descent (Si Salem et al.): the log-weight step through
    the histogram kernel and the KL projection's safeguarded Newton sweeps
    in PyTorch (:func:`repro_torch.cachesim.engines._make_omd_step`)."""
    raw = _engines._make_omd_step(sample, sweeps, madow_capacity)
    madow = sample in MADOW_SAMPLES

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
        _unit_only("omd", sizes, costs)
        if eta is None:
            raise ValueError("omd init needs eta (run() resolves eta=None)")
        if madow and int(madow_capacity) != int(capacity):
            raise ValueError(
                f"madow needs a static capacity: policy_def('omd', "
                f"sample={sample!r}, madow_capacity={capacity}) "
                f"(got {madow_capacity})"
            )
        dev = resolve_device(device)
        p, u_key = sampling_keys(seed, catalog_size, sample, dev)
        f, w, lam = _engines.init_omd_carry(catalog_size, capacity, dev)
        return OMDApiCarry(
            f=f, w=w, lam=lam,
            eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
            cap=torch.tensor(float(capacity), dtype=torch.float32, device=dev),
            p=p, u_key=u_key, t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(carry, ids):
        u = _chunk_u(carry.u_key, carry.t) if madow else None
        state = _engines.OMDCarry(carry.f, carry.w, carry.lam)
        (f, w, lam), (reward, hits, lam_o, occ) = raw(carry.eta, carry.p, carry.cap, state,
                                                      ids, u)
        carry = carry._replace(f=f, w=w, lam=lam, t=carry.t + 1)
        return carry, StepOut(reward, hits, lam_o, occ)

    return PolicyDef(
        kind="omd",
        name="OMD",
        init=init,
        step=step,
        # Si Salem et al. tuning at the replay batch size, as the reference
        default_eta=lambda N, C, T, W: theoretical_eta_omd(C, N, T, W),
        fractional=True,
    )


def _private_copy(carry, id_bound=None):
    """A copy of an automaton's carry for a run to update in place."""
    del id_bound
    return type(carry)(*(x.clone() for x in carry))


def _reject_costs(kind: str, costs) -> None:
    if costs is not None:
        raise ValueError(f"{kind} has no miss-cost model (costs= unsupported); use "
                         "policy_def('gds') or policy_def('ogb_sized')")


def _sized_step(step):
    """The :class:`StepOut` step of an automaton whose ``step`` is
    ``(carry, ids, flags) -> (carry, (hits, stats))``, for one combo or a
    grid's (each leaf then (R,)): a :class:`SizedAutomatonCarry` also
    weights each hit by the requested item's bytes."""

    def sized_step(carry, ids):
        if not isinstance(carry, SizedAutomatonCarry):
            carry, (hits, stats) = step(carry, ids, None)
            return carry, StepOut(stats[..., 0], hits, stats[..., 1], stats[..., 2])
        # the inner carry leads with a tensor of one combo's (X,), a grid's
        # (R, X); ids are (W,), or a fleet's (R, W)
        flags = torch.empty(tuple(carry.inner[0].shape[:-1]) + tuple(ids.shape[-1:]),
                            dtype=torch.bool, device=ids.device)
        inner, (hits, stats) = step(carry.inner, ids, flags)
        szs = carry.szs[ids.to(torch.int64)]
        byte_hits = torch.where(flags, szs, torch.zeros_like(szs)).sum(dim=-1,
                                                                       dtype=torch.float64)
        return (SizedAutomatonCarry(inner, carry.szs),
                StepOut(stats[..., 0], hits, stats[..., 1], stats[..., 2], byte_hits))

    return sized_step


def _sized_hooks(start, step, finish):
    """``(start, step, finish)`` of an automaton that also takes a
    :class:`SizedAutomatonCarry`: its own hooks on the inner carry, and
    :func:`_sized_step` of ``step``."""

    def sized_start(carry, id_bound=None):
        if isinstance(carry, SizedAutomatonCarry):
            return SizedAutomatonCarry(start(carry.inner, id_bound), carry.szs)
        return start(carry, id_bound)

    def sized_finish(carry):
        if isinstance(carry, SizedAutomatonCarry):
            return SizedAutomatonCarry(finish(carry.inner), carry.szs)
        return finish(carry)

    return sized_start, _sized_step(step), sized_finish if finish is not None else None


def _sized_grid(start, split, step=None) -> Batched:
    """The grid form of an automaton that also takes
    :class:`SizedAutomatonCarry` combos (one ``sizes`` for all): the inner
    grid's ``start`` and ``split``, and :func:`_sized_step` of ``step``
    where the grid needs its own."""

    def grid_start(carries, id_bound=None):
        if isinstance(carries[0], SizedAutomatonCarry):
            return SizedAutomatonCarry(start([c.inner for c in carries], id_bound),
                                       carries[0].szs)
        return start(carries, id_bound)

    def grid_split(grid):
        if isinstance(grid, SizedAutomatonCarry):
            return [SizedAutomatonCarry(c, grid.szs) for c in split(grid.inner)]
        return split(grid)

    return Batched(start=grid_start, split=grid_split,
                   step=_sized_step(step) if step is not None else None)


def _automaton_def(kind: str, zeta: Optional[float] = None,
                   impl: Optional[str] = None) -> PolicyDef:
    """An automaton whose step updates the carry in place (a run starts
    from a private copy).

    ``impl`` selects the engine, as in the reference: ``"tree"`` (the
    default for lru, lfu and ftpl) runs the tree automata of
    :mod:`.tree_engines`, one ``tree_lru`` or ``minpair_automaton`` launch a
    chunk; ``"dense"`` (the only engine of fifo, which has no tree form) the
    slot automaton, one ``slot_automaton`` launch a chunk, at most 16 384
    slots on the card, and for fifo the FIFO queue, one ``fifo_queue``
    launch a chunk at any capacity.  Both give bit-identical hit sequences;
    only the carry differs.  The tree init also takes ``ring=``, the LRU
    ring's positions (a power of two >= 4 * n_slots).

    ``init(..., sizes=)`` wraps the carry in a :class:`SizedAutomatonCarry`:
    the same decisions, each hit also weighted by the requested item's
    bytes.  ``costs=`` raises: these automata have no cost model (``gds``
    has).  Sized runs take the tree automata or fifo; the dense slot
    kernel does not report each request's hit."""
    def_zeta = zeta
    if impl is None:
        impl = "tree" if kind in _tree.TREE_ENGINE_KINDS else "dense"
    if impl == "tree":
        if kind not in _tree.TREE_ENGINE_KINDS:
            raise ValueError(f"no tree engine for kind {kind!r} (have "
                             f"{_tree.TREE_ENGINE_KINDS}); it runs dense")

        def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
                 zeta=None, ring=None, sizes=None, costs=None, device=None):
            del eta  # the automata have no learning rate
            _reject_costs(kind, costs)
            inner = _tree.init_tree_engine_carry(
                kind, catalog_size, capacity, n_slots=n_slots, seed=seed,
                zeta=zeta if zeta is not None else def_zeta, horizon=horizon, ring=ring,
                device=device,
            )
            if sizes is None:
                return inner
            return SizedAutomatonCarry(inner, _sizes_tensor(sizes, catalog_size, inner.device))

        start, step, _ = _sized_hooks(_tree.start_tree_run,
                                      lambda c, ids, fl: _tree.tree_chunk(kind, c, ids, fl), None)
        grid = _sized_grid(_tree.grid_start, _tree.grid_split,
                           _tree.grid_lru_chunk if kind == "lru" else None)
        return PolicyDef(kind=kind, name=kind.upper(), init=init, step=step, start=start,
                         batched=grid)
    if impl != "dense":
        raise ValueError(f"unknown automaton impl {impl!r}")
    fifo = kind == "fifo"

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             zeta=None, sizes=None, costs=None, device=None):
        del eta  # the automata have no learning rate
        _reject_costs(kind, costs)
        inner = _engines.init_engine_carry(
            kind, catalog_size, capacity, n_slots=n_slots, seed=seed,
            zeta=zeta if zeta is not None else def_zeta, horizon=horizon, device=device,
        )
        if sizes is None:
            return inner
        if not fifo:
            raise NotImplementedError(
                f"sized runs of {kind} take its tree automaton (impl='tree'): the dense slot "
                "kernel does not report each request's hit")
        return SizedAutomatonCarry(inner, _sizes_tensor(sizes, catalog_size, inner.device))

    if fifo:
        start, step, finish = _sized_hooks(_engines.start_fifo_run, _engines.fifo_chunk,
                                           _engines.finish_fifo_run)
        grid = _sized_grid(_engines.start_fifo_grid, _engines.split_fifo_grid,
                           _engines.fifo_grid_chunk)
        return PolicyDef(kind=kind, name=kind.upper(), init=init, step=step, start=start,
                         finish=finish, batched=grid)

    def step(carry, ids):
        carry, (hits, stats) = _engines.automaton_chunk(kind, carry, ids)
        return carry, StepOut(stats[0], hits, stats[1], stats[2])

    return PolicyDef(kind=kind, name=kind.upper(), init=init, step=step, start=_private_copy)


def _gds_def() -> PolicyDef:
    """GreedyDual-Size, the size/cost-aware automaton baseline, on the
    min-pair trees (one ``minpair_automaton`` launch a chunk): keys H_i =
    L + cost_i / size_i, held against the host ``core.policies.GDS``.
    Unit sizes and costs make it LRU with aging.  It always reports
    ``byte_hits`` (the hits, where every size is 1)."""

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del seed, eta, horizon  # GDS has no randomness and no learning rate
        return _tree.init_tree_gds_carry(int(catalog_size), int(capacity), n_slots,
                                         sizes=sizes, costs=costs, device=device)

    def step(carry, ids):
        flags = torch.empty(ids.shape, dtype=torch.bool, device=ids.device)
        carry, (hits, stats) = _tree.tree_chunk("gds", carry, ids, flags)
        szs = carry.szs.index_select(0, ids.to(torch.int64))
        byte_hits = torch.where(flags, szs, torch.zeros_like(szs)).sum(dtype=torch.float64)
        return carry, StepOut(stats[0], hits, stats[1], stats[2], byte_hits)

    return PolicyDef(kind="gds", name="GDS", init=init, step=step, start=_private_copy)


def _ogb_sized_def(
    flavor: str = "tree",
    sample: str = "poisson",
    classes: int = _tree.SIZED_OGB_CLASSES,
    buckets: int = _tree.OGB_TREE_BUCKETS,
    radix: int = _tree.OGB_TREE_RADIX,
    iters: int = _tree.OGB_TREE_ITERS,
    proj_iters: int = DEFAULT_BISECT_ITERS,
    batch_hint: int = 4096,
) -> PolicyDef:
    """Size-aware OGB over the knapsack-relaxed feasible set (paper §8).

    ``flavor="tree"`` is the per-size-class lazy bucketized form, O(K * B log
    V) a chunk (:func:`.tree_engines.make_sized_ogb_tree_chunk`: three
    stacked ``tree_update`` launches and one ``solve_sized`` launch);
    ``flavor="scan"`` the dense O(N) form with exact per-item sizes and a
    full weighted bisection projection, its differential oracle.  ``init``
    needs per-item ``sizes`` (``run(..., sizes=...)``); ``costs`` default to
    the sizes (byte-weighted rewards).  ``eta=None`` resolves to the
    Theorem 3.1 rate at the capacity in mean-object units."""
    if flavor not in ("tree", "scan"):
        raise ValueError(f"ogb_sized flavor must be 'tree'|'scan': {flavor!r}")
    if sample not in ("poisson", "none"):
        raise ValueError(f"ogb_sized supports sample='poisson'|'none' (got {sample!r})")

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             sizes=None, costs=None, device=None):
        del n_slots
        if sizes is None:
            raise ValueError("ogb_sized init needs per-item sizes: run(..., sizes=...)")
        n = int(catalog_size)
        s64 = np.asarray(sizes, np.float64)
        if s64.shape != (n,):
            raise ValueError(f"sizes must be a ({n},) array: {s64.shape}")
        if eta is None:
            # Theorem 3.1 tuning with the capacity in mean-object units
            c_eq = float(capacity) / float(np.mean(s64))
            eta = theoretical_eta(c_eq, n, int(horizon or 1), 1)
        if flavor == "tree":
            return _tree.init_sized_ogb_tree_carry(
                n, float(capacity), sizes=s64, costs=costs, eta=float(eta), seed=seed,
                sample=sample, classes=classes, buckets=buckets, radix=radix,
                batch_hint=batch_hint, device=device,
            )
        # scan flavor: exact sizes, the same mean-size normalization
        if not (np.all(np.isfinite(s64)) and float(s64.min()) > 0.0):
            raise ValueError("sizes must be finite and > 0")
        sref = float(np.mean(s64))
        s_n = s64 / sref
        if costs is None:
            w = s_n.copy()
        else:
            w = np.asarray(costs, np.float64) / sref
            if w.shape != (n,):
                raise ValueError(f"costs must be a ({n},) array")
            if not (np.all(np.isfinite(w)) and w.min() > 0.0):
                raise ValueError("costs must be finite and > 0")
        cap_n = float(capacity) / sref
        total_s = float(np.sum(s_n))
        if cap_n >= total_s:
            raise ValueError(f"capacity {capacity} holds the whole catalog; caching is trivial")
        dev = resolve_device(device)
        p, _u_key = sampling_keys(seed, n, sample, dev)

        def put(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        return SizedOGBScanCarry(
            f=torch.full((n,), cap_n / total_s, dtype=torch.float32, device=dev),
            tau=torch.zeros((), dtype=torch.float32, device=dev),
            eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
            cap=torch.tensor(cap_n, dtype=torch.float32, device=dev),
            s=put(s_n), wts=put(w),
            sref=torch.tensor(sref, dtype=torch.float32, device=dev),
            p=p, t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    if flavor == "tree":

        def step(carry, ids):
            chunk = _tree.make_sized_ogb_tree_chunk(buckets, radix, sample, iters)
            carry, (reward, hits, byte_hits, drho, occ) = chunk(carry, ids)
            return carry, StepOut(reward * carry.sref, hits, drho, occ, byte_hits)

        start = _tree.start_sized_run
    else:

        def step(carry, ids):
            ids64 = ids.to(torch.int64)
            f, s, wts, p, sref = carry.f, carry.s, carry.wts, carry.p, carry.sref
            sj, wj, fi = s[ids64], wts[ids64], f[ids64]
            reward = (wj * fi).sum()  # pre-update (OCO order)
            if sample == "poisson":
                hflag = fi >= p[ids64]
                hits = hflag.sum(dtype=torch.int32)
                byte_hits = torch.where(hflag, sj, torch.zeros_like(sj)).sum(
                    dtype=torch.float64) * sref.to(torch.float64)
                occ = torch.where(f >= p, s, torch.zeros_like(s)).sum() * sref
            else:
                hits = torch.zeros((), dtype=torch.int32, device=f.device)
                byte_hits = torch.zeros((), dtype=torch.float64, device=f.device)
                occ = carry.cap * sref
            # the step eta * w once a request, in float64 and rounded once
            y = f.to(torch.float64).index_add(0, ids64, (carry.eta * wj).to(torch.float64))
            f_new, tau = weighted_simplex_project(y.to(torch.float32), s, carry.cap, proj_iters)
            carry = carry._replace(f=f_new, tau=tau, t=carry.t + 1)
            return carry, StepOut(reward * sref, hits, tau, occ, byte_hits)

        start = None

    return PolicyDef(kind="ogb_sized", name=f"OGB_sized_{flavor}", init=init, step=step,
                     start=start, fractional=True)


_POLICY_DEFS = {
    "ogb": _ogb_def,
    "ogb_tree": _ogb_tree_def,
    "ogb_grad": _ogb_grad_def,
    "omd": _omd_def,
    "gds": _gds_def,
    "ogb_sized": _ogb_sized_def,
    **{k: functools.partial(_automaton_def, k) for k in _engines.ENGINE_KINDS},
}


def register_policy_def(kind: str, factory: Callable[..., PolicyDef]) -> None:
    """Register a :class:`PolicyDef` factory under a kind string.

    ``factory(**static_options) -> PolicyDef``; static options are those
    that change the step (sample mode, projection flavor, sweep counts), as
    opposed to per-combo parameters, which belong in the carry.  A kind
    registered again replaces the earlier factory."""
    _POLICY_DEFS[kind.lower()] = factory
    _cached_def.cache_clear()


def policy_def_kinds() -> tuple:
    """All registered kind strings."""
    return tuple(_POLICY_DEFS)


@functools.lru_cache(maxsize=None)
def _cached_def(kind: str, options: tuple) -> PolicyDef:
    return _POLICY_DEFS[kind](**dict(options))


def policy_def(kind: str, **options) -> PolicyDef:
    """Resolve a kind to a (memoized) :class:`PolicyDef`.

    ``policy_def("ogb", sample="poisson"|"madow"|"madow_tree"|"none",
    projection="warm"|"bisect", sweeps=5, iters=50, madow_capacity=C)``
    (the Madow modes need ``madow_capacity``, the run's capacity);
    ``policy_def("ogb_tree", sample="poisson"|"none", buckets=65536,
    radix=64, iters=30, batch_hint=4096)``;
    ``policy_def("ogb_grad", iters=50)`` (serving: a step takes a gradient
    vector, not request ids);
    ``policy_def("omd", sample=..., sweeps=10, madow_capacity=C)``;
    ``policy_def(k, impl=None|"tree"|"dense")`` for the automata k in
    ``lru``, ``fifo``, ``lfu`` and ``ftpl``: ``impl=None`` is ``"tree"`` for
    ``lru``, ``lfu`` and ``ftpl`` (the tree automata, as in the reference)
    and ``"dense"`` for ``fifo``, which has no tree form (``"tree"`` raises
    ``ValueError``); ``ftpl`` also takes ``zeta`` (by default it is tuned to
    the run's horizon); ``policy_def("gds")``; ``policy_def("ogb_sized",
    flavor="tree"|"scan", sample="poisson"|"none", classes=16,
    buckets=65536, radix=64, iters=30, proj_iters=50, batch_hint=4096)``.
    """
    kind = kind.lower()
    if kind not in _POLICY_DEFS:
        raise KeyError(
            f"unknown policy kind {kind!r}; ported so far: {sorted(_POLICY_DEFS)}"
        )
    return _cached_def(kind, tuple(sorted(options.items())))


def carry_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None):
    """A carry from the reference's carry leaves as numpy arrays.

    Leaves ``tree, last, pos, nseen, cap`` (the reference's
    ``TreeLRUCarry``) give a :class:`TreeLRUCarry`; leaves ``imap, counts,
    slots, tree_hi, tree_lo`` with ``t`` (``TreeLFUCarry``) or ``noise``
    (``TreeFTPLCarry``) the tree LFU's or FTPL's carry, FTPL's noise with it;
    leaves ``imap, hval, L, prio, szs, slots, tree_hi, tree_lo``
    (``TreeGDSCarry``) a :class:`TreeGDSCarry`; ``inner, szs``
    (``SizedAutomatonCarry``, ``inner`` the automaton's own leaves or
    NamedTuple) a :class:`SizedAutomatonCarry`.  Leaves ``y, rho, ...,
    dcnt`` with ``cls`` (``SizedOGBTreeCarry``) give a
    :class:`SizedOGBTreeCarry`, without it (``OGBTreeCarry``) an
    :class:`OGBTreeCarry`; leaves ``f, tau, eta, cap, s, wts, sref, p, t``
    (``SizedOGBScanCarry``) a :class:`SizedOGBScanCarry`; leaves ``f, w, lam, eta, cap, p, u_key, t`` (its
    ``OMDApiCarry``) an :class:`OMDApiCarry`; leaves ``f, tau, eta, cap, p,
    u_key, t`` (its ``OGBCarry``) an :class:`OGBCarry`; the (2,) uint32
    Madow key data is packed into the port's int64 key.  This is how a run
    is started from the reference's own Poisson ``p``, whose random stream
    PyTorch cannot reproduce.
    """
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=dev)

    def scalar(name):
        return put(name, torch.int32).reshape(())

    def f32(name):
        return put(name, torch.float32)

    if "inner" in d:
        inner = d["inner"]
        inner = inner._asdict() if hasattr(inner, "_asdict") else inner
        return SizedAutomatonCarry(carry_from_numpy(inner, dev), f32("szs"))
    if "hval" in d:
        return TreeGDSCarry(
            imap=put("imap", torch.int32), hval=f32("hval"), L=f32("L").reshape(()),
            prio=f32("prio"), szs=f32("szs"), slots=put("slots", torch.int32),
            tree_hi=put("tree_hi", torch.int32), tree_lo=put("tree_lo", torch.int32))
    if "cls" in d:
        return SizedOGBTreeCarry(
            y=f32("y"), rho=f32("rho").reshape(()), eta=f32("eta").reshape(()),
            cap=f32("cap").reshape(()), cls=put("cls", torch.int32), s=f32("s"),
            wts=f32("wts"), sref=f32("sref").reshape(()), wmax=f32("wmax").reshape(()),
            p=f32("p"), wb=f32("wb").reshape(()), scratch=put("scratch", torch.int32),
            ycnt=f32("ycnt"), ysum=f32("ysum"), dcnt=f32("dcnt"))
    if "wts" in d:
        return SizedOGBScanCarry(
            f=f32("f"), tau=f32("tau").reshape(()), eta=f32("eta").reshape(()),
            cap=f32("cap").reshape(()), s=f32("s"), wts=f32("wts"),
            sref=f32("sref").reshape(()), p=f32("p"), t=scalar("t"))
    if "last" in d:
        return TreeLRUCarry(tree=put("tree", torch.int32), last=put("last", torch.int32),
                            pos=scalar("pos"), nseen=scalar("nseen"), cap=scalar("cap"))
    if "tree_hi" in d:
        common = {k: put(k, torch.int32) for k in ("imap", "counts", "slots", "tree_hi",
                                                   "tree_lo")}
        if "noise" in d:
            return TreeFTPLCarry(noise=put("noise", torch.float32), **common)
        return TreeLFUCarry(t=scalar("t"), **common)
    if "y" in d:
        return OGBTreeCarry(
            y=put("y", torch.float32),
            rho=put("rho", torch.float32).reshape(()),
            eta=put("eta", torch.float32).reshape(()),
            cap=put("cap", torch.float32).reshape(()),
            p=put("p", torch.float32),
            w=put("w", torch.float32).reshape(()),
            scratch=put("scratch", torch.int32),
            ycnt=put("ycnt", torch.float32),
            ysum=put("ysum", torch.float32),
            dcnt=put("dcnt", torch.float32),
        )
    words = np.asarray(d.get("u_key", np.zeros(2, np.uint32)), np.uint64).reshape(-1)
    key = int((words[0] << np.uint64(32)) | words[-1]) if words.size else 0
    u_key = torch.tensor(_i64(key), dtype=torch.int64, device=dev)
    if "lam" in d:
        return OMDApiCarry(
            f=put("f", torch.float32),
            w=put("w", torch.float32),
            lam=put("lam", torch.float32).reshape(()),
            eta=put("eta", torch.float32).reshape(()),
            cap=put("cap", torch.float32).reshape(()),
            p=put("p", torch.float32),
            u_key=u_key,
            t=put("t", torch.int32).reshape(()),
        )
    return OGBCarry(
        f=put("f", torch.float32),
        tau=put("tau", torch.float32).reshape(()),
        eta=put("eta", torch.float32).reshape(()),
        cap=put("cap", torch.float32).reshape(()),
        p=put("p", torch.float32),
        u_key=u_key,
        t=put("t", torch.int32).reshape(()),
    )


def run(
    pd: PolicyDef,
    trace: np.ndarray,
    catalog_size: Optional[int] = None,
    capacity: Optional[int] = None,
    *,
    window: int = 1000,
    carry: Any = None,
    seed: int = 0,
    eta: Optional[float] = None,
    horizon: Optional[int] = None,
    n_slots: Optional[int] = None,
    sizes: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    track_opt: bool = True,
    keep_carry: bool = True,
    name: Optional[str] = None,
    block: bool = True,
    device: DeviceLike = None,
    **init_kw,
) -> RunResult:
    """Replay a trace through one policy, chunk by chunk on the device.

    The trace is cut into ``T // window`` chunks of ``window`` requests (a
    trailing partial chunk is dropped); ``window`` is the OGB/OMD update
    batch B and the automata's hit-accounting granularity.  ``eta=None``
    resolves through ``pd.default_eta`` for the replayed horizon;
    ``horizon`` (default: the replayed length) tunes FTPL's noise;
    ``n_slots`` > capacity pads an automaton's slots with inactive ones;
    other keywords go to ``pd.init`` (the tree LRU's ``ring=``).
    Trace ids must lie in ``[0, N)``; LRU and FIFO carries hold no catalog
    size, so a resumed run of theirs checks against ``catalog_size`` where
    given, else only that ids are not negative.  ``device=None`` is the CUDA card, and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.  For ``ogb_tree``
    the result's ``extras`` holds ``host_syncs`` (steps that read the
    device to decide a re-anchor) and ``reanchors``; for the tree LRU on
    the card ``host_syncs`` (steps that read the device: 0 in a run).

    **Sized runs:** ``sizes`` (bytes, one an item) shape the decisions of
    the sized policies (``ogb_sized``, ``gds``), give every automaton byte
    accounting, and give the result ``byte_hits`` and ``bytes_total``, so
    ``byte_hit_ratio`` is the bytes served from cache over the bytes
    requested; ``costs`` are the items' miss costs (default: the sizes).
    A resumed run takes the policy's sizes from its carry, and ``sizes``
    there only drives ``bytes_total``.

    **Streaming contract:** pass ``carry=result.carry`` to resume where a
    previous call stopped: two chunked runs replay the same dynamics as one
    run, bit for bit.  A resumed run takes every policy parameter from the
    carry, so ``seed``/``eta``/``horizon`` must not be passed with it.
    The carry passed in is not modified.

    **Non-blocking dispatch:** ``block=False`` returns once every chunk is
    enqueued: the trace goes up from pinned host memory without waiting for
    the work already queued, the result's per-chunk outputs stay device
    tensors, a CUDA event marks the end of the run, and ``wall_seconds``
    measures the dispatch alone.  :meth:`RunResult.consume` is the one
    place that waits; it turns the outputs into host arrays.  The returned
    carry can be passed straight to the next ``run``: the stream orders the
    two.  (A kind whose ``start`` reads the device, FIFO's queue and the
    tree LRU's and ``ogb_tree``'s host bounds, waits there for the work
    before it.)  ``name`` labels the result (default ``pd.name``).
    """
    dev = resolve_device(device)
    trace = np.asarray(trace)
    m = len(trace) // window
    if m == 0:
        raise ValueError(f"trace shorter than one window ({len(trace)} < {window})")
    t_used = m * window
    trace_used = trace[:t_used]
    extras = {}
    if carry is None:
        if catalog_size is None or capacity is None:
            raise ValueError("run() needs catalog_size and capacity (or carry=)")
        if eta is None and pd.default_eta is not None:
            eta = pd.default_eta(int(catalog_size), int(capacity), t_used, window)
        sized_kw = {}
        if sizes is not None:
            sized_kw["sizes"] = np.asarray(sizes)
        if costs is not None:
            sized_kw["costs"] = np.asarray(costs)
        carry = pd.init(
            int(catalog_size),
            int(capacity),
            seed=seed,
            eta=eta,
            horizon=int(horizon) if horizon is not None else t_used,
            n_slots=n_slots,
            device=dev,
            **sized_kw,
            **init_kw,
        )
        if eta is not None:
            extras["eta"] = float(eta)
    elif (eta is not None or horizon is not None or n_slots is not None or seed != 0
          or costs is not None or init_kw):
        # a resumed run takes every policy parameter from the carry; a
        # silently ignored eta or seed would mislabel the result (sizes= is
        # allowed: it only drives the byte total)
        raise ValueError(
            "run(carry=...) resumes with the carry's parameters; do not pass "
            "seed/eta/horizon/n_slots/costs or init keywords alongside a carry"
        )
    elif carry.device != dev:
        raise ValueError(f"carry is on {carry.device}, run was asked for {dev}")
    n = carry.catalog_size if carry.catalog_size is not None else catalog_size
    lo, hi = int(trace_used.min()), int(trace_used.max())
    if lo < 0 or (n is not None and hi >= n):
        raise ValueError(f"trace ids must lie in [0, {n}), got [{lo}, {hi}]")
    if pd.kind == "fifo" and t_used > FIFO_MAX_REQUESTS:
        raise ValueError(f"a FIFO run serves at most {FIFO_MAX_REQUESTS} requests (its queue's "
                         f"int32 admission tickets), got {t_used}")
    if pd.start is not None:
        carry = pd.start(carry, int(n) if n is not None else hi + 1)
    chunks, staged = _upload(trace_used.astype(np.int32).reshape(m, window), dev, block)
    if block:
        _sync(dev)
    t0 = time.perf_counter()
    carry, (reward, hits, aux, occupancy, byte_hits) = _replay(pd.step, carry, chunks)
    event = None
    if block:
        _sync(dev)
    elif dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    wall = time.perf_counter() - t0
    if pd.finish is not None:
        carry = pd.finish(carry)
    if isinstance(carry, (OGBTreeCarry, SizedOGBTreeCarry)):
        extras["host_syncs"] = float(carry.host.syncs)
        extras["reanchors"] = float(carry.host.reanchors)
    if isinstance(carry, TreeLRUCarry) and carry.host is not None:
        extras["host_syncs"] = float(carry.host.syncs)
    opt = (
        float(best_static_hits(trace_used, int(capacity)))
        if (track_opt and capacity is not None)
        else 0.0
    )
    result = RunResult(
        name=name or pd.name,
        kind=pd.kind,
        T=t_used,
        window=window,
        capacity=int(capacity) if capacity is not None else -1,
        reward=reward,
        hits=hits,
        aux=aux,
        occupancy=occupancy,
        opt_hits=opt,
        carry=carry if keep_carry else None,
        wall_seconds=wall,
        extras=extras,
        byte_hits=byte_hits,
        bytes_total=_bytes_total(sizes, trace_used),
        pending=(event, staged),
    )
    return result.consume() if block else result


def sweep(
    pd: PolicyDef,
    trace: np.ndarray,
    catalog_size: int,
    capacities: Sequence[int],
    *,
    etas: Sequence[Optional[float]] = (None,),
    seeds: Sequence[int] = (0,),
    window: int = 1000,
    horizon: Optional[int] = None,
    sizes: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    track_opt: bool = True,
    device: DeviceLike = None,
    **init_kw,
) -> SweepResult:
    """Replay one trace through a (seeds x etas x capacities) grid of combos.

    The combos go in seed, eta, capacity order (``SweepResult.combos``).
    One carry a combo is built by ``pd.init``, the automata padded to
    ``n_slots = max(capacities)`` slots; ``eta=None`` resolves through
    ``pd.default_eta`` at each combo's capacity, so a default-tuned row is
    the default-tuned :func:`run`.  Where the kind has a grid form
    (``pd.batched``) the carries are stacked and each chunk is one launch
    for the whole grid of each kernel it runs: dense ``ogb`` (Poisson or no
    sampling, warm projection) one histogram and one warm projection, the
    tree ``lru`` one ``tree_lru`` (and each combo's possible ring
    compaction), ``lfu`` and ``ftpl`` one ``minpair_automaton``, ``fifo``
    one ``fifo_queue`` a plan; each row is bit for bit the combo's own run
    (f and tau, hits and carries; reward and occupancy sum another axis).
    Other kinds (``omd``, ``ogb_tree``, ``ogb_sized``, ``gds``, the Madow
    modes, the bisection, ``impl="dense"`` automata) run their combos one
    after another, each exactly as :func:`run` would.  Hindsight OPT is
    computed on the host once a capacity.

    ``device=None`` is the CUDA card, and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.
    """
    dev = resolve_device(device)
    trace = np.asarray(trace)
    m = len(trace) // window
    if m == 0:
        raise ValueError(f"trace shorter than one window ({len(trace)} < {window})")
    if not len(capacities) or not len(etas) or not len(seeds):
        raise ValueError("sweep needs at least one capacity, eta and seed")
    t_used = m * window
    trace_used = trace[:t_used]
    n = int(catalog_size)
    lo, hi = int(trace_used.min()), int(trace_used.max())
    if lo < 0 or hi >= n:
        raise ValueError(f"trace ids must lie in [0, {n}), got [{lo}, {hi}]")
    if pd.kind == "fifo" and t_used > FIFO_MAX_REQUESTS:
        raise ValueError(f"a FIFO run serves at most {FIFO_MAX_REQUESTS} requests (its queue's "
                         f"int32 admission tickets), got {t_used}")
    horizon = t_used if horizon is None else int(horizon)
    n_slots = int(max(capacities))
    sized_kw = {}
    if sizes is not None:
        sized_kw["sizes"] = np.asarray(sizes)
    if costs is not None:
        sized_kw["costs"] = np.asarray(costs)
    combos, carries = [], []
    for s in seeds:
        for eta in etas:
            for c in capacities:
                e = eta
                if e is None and pd.default_eta is not None:
                    e = pd.default_eta(n, int(c), t_used, window)
                combo = {"capacity": int(c), "seed": int(s)}
                if pd.fractional and e is not None:
                    # ogb_sized resolves eta=None inside init (it needs the
                    # sizes); its default-tuned combos omit the key
                    combo["eta"] = float(e)
                combos.append(combo)
                carries.append(pd.init(n, int(c), seed=int(s), eta=e, horizon=horizon,
                                       n_slots=n_slots, device=dev, **sized_kw, **init_kw))
    chunks = torch.from_numpy(trace_used.astype(np.int32).reshape(m, window)).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    if pd.batched is not None:
        grid = pd.batched.start(carries, n)
        del carries
        grid, outs = _replay(pd.batched.step or pd.step, grid, chunks)
        finals = pd.batched.split(grid)
    else:
        finals, rows = [], []
        for carry in carries:
            if pd.start is not None:
                carry = pd.start(carry, n)
            carry, out = _replay(pd.step, carry, chunks)
            finals.append(pd.finish(carry) if pd.finish is not None else carry)
            rows.append(out)
        outs = tuple(torch.stack(parts) if parts[0] is not None else None
                     for parts in zip(*rows))
    _sync(dev)
    wall = time.perf_counter() - t0
    reward, hits, aux, occupancy, byte_hits = outs
    return SweepResult(
        kind=pd.kind,
        combos=combos,
        T=t_used,
        window=window,
        reward=reward.cpu().numpy().astype(np.float64),
        hits=hits.cpu().numpy().astype(np.int64),
        aux=aux.cpu().numpy().astype(np.float64),
        occupancy=occupancy.cpu().numpy().astype(np.float64),
        opt_hits=(opt_hits_by_combo(trace_used, combos) if track_opt
                  else np.zeros(len(combos))),
        wall_seconds=wall,
        byte_hits=byte_hits.cpu().numpy() if byte_hits is not None else None,
        bytes_total=_bytes_total(sizes, trace_used),
        carries=finals,
    )


def _upload(chunks: np.ndarray, dev: torch.device, block: bool):
    """``chunks`` on ``dev``, and the host buffer the copy reads.  Without
    ``block`` a card's copy goes from pinned memory with ``non_blocking``,
    so it does not wait for the kernels already queued (a copy from pageable
    memory would); the buffer must then live until the copy is done."""
    host = torch.from_numpy(chunks)
    if block or dev.type != "cuda":
        return host.to(dev), None
    staged = host.pin_memory()
    return staged.to(dev, non_blocking=True), staged


def _bytes_total(sizes, trace_used) -> float:
    return float(np.sum(np.asarray(sizes, np.float64)[trace_used])) if sizes is not None else 0.0


def _replay(step, carry, chunks: torch.Tensor):
    """Every chunk of ``chunks`` (M, window) through ``step``, in order:
    ``(carry, (reward, hits, aux, occupancy, byte_hits))``, each output a
    device tensor with the chunks on its last axis (a grid's (R, M)),
    byte_hits None where the step reports none.  Nothing is read on the
    host."""
    m, dev = chunks.shape[0], chunks.device
    outs = None
    for i in range(m):
        carry, out = step(carry, chunks[i])
        if outs is None:
            lead = tuple(out.hits.shape)
            outs = [torch.empty(lead + (m,), dtype=dt, device=dev)
                    for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
            if out.byte_hits is not None:
                outs.append(torch.empty(lead + (m,), dtype=torch.float64, device=dev))
        for buf, x in zip(outs, out):
            buf[..., i] = x
    return carry, (*outs[:4], outs[4] if len(outs) > 4 else None)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
