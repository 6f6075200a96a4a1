"""The policy protocol and the replay loop.

Counterpart of ``repro.cachesim.api``: a :class:`PolicyDef` is an
``(init, step)`` pair whose carry holds the policy state and its parameters
(eta, capacity, sampling randomness) as tensors, and :func:`run` replays a
trace through it.  Registered kinds (:func:`policy_def_kinds`):

* ``ogb`` with Poisson, Madow (``madow``, ``madow_tree``) or no sampling,
  and the lazy bucketized ``ogb_tree``;
* ``omd``, negative-entropy mirror descent (:mod:`.engines`);
* the automata ``lru``, ``fifo``, ``lfu`` and ``ftpl``.  As in the
  reference, ``lru``, ``lfu`` and ``ftpl`` default to the O(log) tree
  automata (``impl="tree"``: one ``tree_lru`` or ``minpair_automaton``
  launch a chunk, :mod:`.tree_engines`), and ``impl="dense"`` runs the slot
  automaton (one ``slot_automaton`` launch a chunk, at most 16 384 slots),
  the differential oracle; both give bit-identical hit sequences.  FIFO has
  no tree form and always runs dense.

The reference's ``lax.scan`` becomes a Python loop over chunks on the
device.  Per-chunk outputs go into preallocated device tensors, and
:func:`run` synchronises once at the end; the only reads inside the loop are
``ogb_tree``'s re-anchor checks, one every few dozen chunks at most (the
tree LRU decides its ring compactions on the device).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import engines as _engines
from repro_torch.cachesim import tree_engines as _tree
from repro_torch.cachesim.replay import MADOW_SAMPLES, _make_ogb_step, sampling_keys
from repro_torch.cachesim.tree_engines import (
    OGBTreeCarry,
    TreeFTPLCarry,
    TreeLFUCarry,
    TreeLRUCarry,
)
from repro_torch.cachesim.results import RunResult
from repro_torch.core.ogb import theoretical_eta
from repro_torch.core.omd import theoretical_eta_omd
from repro_torch.core.regret import best_static_hits
from repro_torch.jaxcache.fractional import DEFAULT_BISECT_ITERS, DEFAULT_WARM_SWEEPS

__all__ = [
    "OGBCarry",
    "OGBTreeCarry",
    "OMDApiCarry",
    "PolicyDef",
    "StepOut",
    "TreeFTPLCarry",
    "TreeLFUCarry",
    "TreeLRUCarry",
    "carry_from_numpy",
    "policy_def",
    "policy_def_kinds",
    "run",
]


class StepOut(NamedTuple):
    """Per-chunk observables of a policy step, 0-d tensors on the device.

    ``reward`` is the pre-update fractional reward (OCO order), the hits
    for the automata; ``aux`` is the projection threshold (tau for OGB,
    lambda for OMD, 0 for the automata)."""

    reward: torch.Tensor  # () float32
    hits: torch.Tensor  # () int32
    aux: torch.Tensor  # () float32
    occupancy: torch.Tensor  # () float32


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


@dataclass(frozen=True)
class PolicyDef:
    """An ``(init, step)`` caching policy.

    ``init(catalog_size, capacity, *, seed, eta, horizon, device) -> carry``;
    ``step(carry, ids) -> (carry, StepOut)``.  ``default_eta`` resolves
    ``eta=None`` at :func:`run` time from ``(catalog_size, capacity,
    horizon, window)``.  ``start(carry) -> carry``, where given, prepares
    the carry a run starts from (a private copy where the step updates in
    place: ``ogb_tree``, with the host's re-anchor bound, and the
    automata).  ``fractional`` policies are scored by their fractional
    reward (regret); ``trace_driven`` steps take request-id chunks.
    """

    kind: str
    name: str
    init: Callable[..., Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOut]]
    default_eta: Optional[Callable[[int, int, int, int], float]] = None
    start: Optional[Callable[[Any], Any]] = None
    fractional: bool = False
    trace_driven: bool = True


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
             device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
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

    return PolicyDef(
        kind="ogb",
        name="OGB",
        init=init,
        step=step,
        # Theorem 3.1 tuning at B=1, as the reference's default
        default_eta=lambda N, C, T, W: theoretical_eta(C, N, T, 1),
        fractional=True,
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
             device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
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
             device=None):
        del horizon, n_slots  # eta is resolved by run(); kept for the reference's signature
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


def _private_copy(carry):
    """A copy of an automaton's carry for a run to update in place."""
    return type(carry)(*(x.clone() for x in carry))


def _automaton_def(kind: str, zeta: Optional[float] = None,
                   impl: Optional[str] = None) -> PolicyDef:
    """An automaton whose step updates the carry in place (a run starts
    from a private copy).

    ``impl`` selects the engine, as in the reference: ``"tree"`` (the
    default for lru, lfu and ftpl) runs the tree automata of
    :mod:`.tree_engines`, one ``tree_lru`` or ``minpair_automaton`` launch a
    chunk; ``"dense"`` (the default for fifo, which has no tree form) the
    slot automaton, one ``slot_automaton`` launch a chunk, at most 16 384
    slots on the card.  Both give bit-identical hit sequences; only the
    carry differs.  The tree init also takes ``ring=``, the LRU ring's
    positions (a power of two >= 4 * n_slots)."""
    def_zeta = zeta
    if impl is None:
        impl = "tree" if kind in _tree.TREE_ENGINE_KINDS else "dense"
    if impl == "tree":
        if kind not in _tree.TREE_ENGINE_KINDS:
            raise ValueError(f"no tree engine for kind {kind!r} (have "
                             f"{_tree.TREE_ENGINE_KINDS}); it runs dense")

        def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
                 zeta=None, ring=None, device=None):
            del eta  # the automata have no learning rate
            return _tree.init_tree_engine_carry(
                kind, catalog_size, capacity, n_slots=n_slots, seed=seed,
                zeta=zeta if zeta is not None else def_zeta, horizon=horizon, ring=ring,
                device=device,
            )

        def step(carry, ids):
            carry, (hits, stats) = _tree.tree_chunk(kind, carry, ids)
            return carry, StepOut(stats[0], hits, stats[1], stats[2])

        return PolicyDef(kind=kind, name=kind.upper(), init=init, step=step,
                         start=_tree.start_tree_run)
    if impl != "dense":
        raise ValueError(f"unknown automaton impl {impl!r}")

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, n_slots=None,
             zeta=None, device=None):
        del eta  # the automata have no learning rate
        return _engines.init_engine_carry(
            kind, catalog_size, capacity, n_slots=n_slots, seed=seed,
            zeta=zeta if zeta is not None else def_zeta, horizon=horizon, device=device,
        )

    def step(carry, ids):
        carry, (hits, stats) = _engines.automaton_chunk(kind, carry, ids)
        return carry, StepOut(stats[0], hits, stats[1], stats[2])

    return PolicyDef(kind=kind, name=kind.upper(), init=init, step=step, start=_private_copy)


_POLICY_DEFS = {
    "ogb": _ogb_def,
    "ogb_tree": _ogb_tree_def,
    "omd": _omd_def,
    **{k: functools.partial(_automaton_def, k) for k in _engines.ENGINE_KINDS},
}


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
    ``policy_def("omd", sample=..., sweeps=10, madow_capacity=C)``;
    ``policy_def(k, impl=None|"tree"|"dense")`` for the automata k in
    ``lru``, ``fifo``, ``lfu`` and ``ftpl``: ``impl=None`` is ``"tree"`` for
    ``lru``, ``lfu`` and ``ftpl`` (the tree automata, as in the reference)
    and ``"dense"`` for ``fifo``, which has no tree form (``"tree"`` raises
    ``ValueError``); ``ftpl`` also takes ``zeta`` (by default it is tuned to
    the run's horizon).
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
    (``TreeFTPLCarry``) the tree LFU's or FTPL's carry, FTPL's noise with it.
    Leaves ``y, rho, ..., dcnt`` (the reference's ``OGBTreeCarry``) give an
    :class:`OGBTreeCarry`; leaves ``f, w, lam, eta, cap, p, u_key, t`` (its
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
    track_opt: bool = True,
    keep_carry: bool = True,
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

    **Streaming contract:** pass ``carry=result.carry`` to resume where a
    previous call stopped: two chunked runs replay the same dynamics as one
    run, bit for bit.  A resumed run takes every policy parameter from the
    carry, so ``seed``/``eta``/``horizon`` must not be passed with it.
    The carry passed in is not modified.
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
        carry = pd.init(
            int(catalog_size),
            int(capacity),
            seed=seed,
            eta=eta,
            horizon=int(horizon) if horizon is not None else t_used,
            n_slots=n_slots,
            device=dev,
            **init_kw,
        )
        if eta is not None:
            extras["eta"] = float(eta)
    elif (eta is not None or horizon is not None or n_slots is not None or seed != 0
          or init_kw):
        # a resumed run takes every policy parameter from the carry; a
        # silently ignored eta or seed would mislabel the result
        raise ValueError(
            "run(carry=...) resumes with the carry's parameters; do not pass "
            "seed/eta/horizon/n_slots or init keywords alongside a carry"
        )
    elif carry.device != dev:
        raise ValueError(f"carry is on {carry.device}, run was asked for {dev}")
    if pd.start is not None:
        carry = pd.start(carry)
    n = carry.catalog_size if carry.catalog_size is not None else catalog_size
    lo, hi = int(trace_used.min()), int(trace_used.max())
    if lo < 0 or (n is not None and hi >= n):
        raise ValueError(f"trace ids must lie in [0, {n}), got [{lo}, {hi}]")
    chunks = torch.from_numpy(trace_used.astype(np.int32).reshape(m, window)).to(dev)

    reward = torch.empty(m, dtype=torch.float32, device=dev)
    hits = torch.empty(m, dtype=torch.int32, device=dev)
    aux = torch.empty(m, dtype=torch.float32, device=dev)
    occupancy = torch.empty(m, dtype=torch.float32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(m):
        carry, out = pd.step(carry, chunks[i])
        reward[i] = out.reward
        hits[i] = out.hits
        aux[i] = out.aux
        occupancy[i] = out.occupancy
    _sync(dev)
    wall = time.perf_counter() - t0
    if isinstance(carry, OGBTreeCarry):
        extras["host_syncs"] = float(carry.host.syncs)
        extras["reanchors"] = float(carry.host.reanchors)
    if isinstance(carry, TreeLRUCarry) and carry.host is not None:
        extras["host_syncs"] = float(carry.host.syncs)
    opt = (
        float(best_static_hits(trace_used, int(capacity)))
        if (track_opt and capacity is not None)
        else 0.0
    )
    return RunResult(
        name=pd.name,
        kind=pd.kind,
        T=t_used,
        window=window,
        capacity=int(capacity) if capacity is not None else -1,
        reward=reward.cpu().numpy().astype(np.float64),
        hits=hits.cpu().numpy().astype(np.int64),
        aux=aux.cpu().numpy().astype(np.float64),
        occupancy=occupancy.cpu().numpy().astype(np.float64),
        opt_hits=opt,
        carry=carry if keep_carry else None,
        wall_seconds=wall,
        extras=extras,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
