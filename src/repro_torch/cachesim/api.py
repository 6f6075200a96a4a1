"""The policy protocol and the replay loop, for the OGB policy.

Counterpart of ``repro.cachesim.api``: a :class:`PolicyDef` is an
``(init, step)`` pair whose carry holds the policy state and its parameters
(eta, capacity, sampling randomness) as tensors, and :func:`run` replays a
trace through it.  Ported so far: ``policy_def("ogb")`` with Poisson,
Madow (``madow``, ``madow_tree``) or no sampling, and the lazy bucketized
``policy_def("ogb_tree")``.

The reference's ``lax.scan`` becomes a Python loop over chunks on the
device.  Per-chunk outputs go into preallocated device tensors, and
:func:`run` synchronises once at the end; the only reads inside the loop are
``ogb_tree``'s re-anchor checks, one every few dozen chunks at most.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim import tree_engines as _tree
from repro_torch.cachesim.replay import MADOW_SAMPLES, _make_ogb_step, sampling_keys
from repro_torch.cachesim.tree_engines import OGBTreeCarry
from repro_torch.cachesim.results import RunResult
from repro_torch.core.ogb import theoretical_eta
from repro_torch.core.regret import best_static_hits
from repro_torch.jaxcache.fractional import DEFAULT_BISECT_ITERS, DEFAULT_WARM_SWEEPS

__all__ = [
    "OGBCarry",
    "OGBTreeCarry",
    "PolicyDef",
    "StepOut",
    "carry_from_numpy",
    "policy_def",
    "run",
]


class StepOut(NamedTuple):
    """Per-chunk observables of a policy step, 0-d tensors on the device.

    ``reward`` is the pre-update fractional reward (OCO order); ``aux`` is
    the projection threshold tau."""

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
    def catalog(self) -> torch.Tensor:
        """The (N,) per-item state, for the catalog size and device."""
        return self.f


@dataclass(frozen=True)
class PolicyDef:
    """An ``(init, step)`` caching policy.

    ``init(catalog_size, capacity, *, seed, eta, horizon, device) -> carry``;
    ``step(carry, ids) -> (carry, StepOut)``.  ``default_eta`` resolves
    ``eta=None`` at :func:`run` time from ``(catalog_size, capacity,
    horizon, window)``.  ``start(carry) -> carry``, where given, prepares
    the carry a run starts from (``ogb_tree``: a private copy, since its
    step updates in place, and the host's re-anchor bound).
    """

    kind: str
    name: str
    init: Callable[..., Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOut]]
    default_eta: Optional[Callable[[int, int, int, int], float]] = None
    start: Optional[Callable[[Any], Any]] = None


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

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, device=None):
        del horizon  # eta is resolved by run(); kept for the reference's signature
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

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, device=None):
        del horizon  # eta is resolved by run(); kept for the reference's signature
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
    )


_POLICY_DEFS = {"ogb": _ogb_def, "ogb_tree": _ogb_tree_def}


@functools.lru_cache(maxsize=None)
def _cached_def(kind: str, options: tuple) -> PolicyDef:
    return _POLICY_DEFS[kind](**dict(options))


def policy_def(kind: str, **options) -> PolicyDef:
    """Resolve a kind to a (memoized) :class:`PolicyDef`.

    ``policy_def("ogb", sample="poisson"|"madow"|"madow_tree"|"none",
    projection="warm"|"bisect", sweeps=5, iters=50, madow_capacity=C)``
    (the Madow modes need ``madow_capacity``, the run's capacity);
    ``policy_def("ogb_tree", sample="poisson"|"none", buckets=65536,
    radix=64, iters=30, batch_hint=4096)``.
    """
    kind = kind.lower()
    if kind not in _POLICY_DEFS:
        raise KeyError(
            f"unknown policy kind {kind!r}; ported so far: {sorted(_POLICY_DEFS)}"
        )
    return _cached_def(kind, tuple(sorted(options.items())))


def carry_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None):
    """A carry from the reference's carry leaves as numpy arrays.

    Leaves ``y, rho, ..., dcnt`` (the reference's ``OGBTreeCarry``) give an
    :class:`OGBTreeCarry`; leaves ``f, tau, eta, cap, p, u_key, t`` (its
    ``OGBCarry``) an :class:`OGBCarry`, with the (2,) uint32 Madow key data
    packed into the port's int64 key.  This is how a run is started from
    the reference's own Poisson ``p``, whose random stream PyTorch cannot
    reproduce.
    """
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=dev)

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
    return OGBCarry(
        f=put("f", torch.float32),
        tau=put("tau", torch.float32).reshape(()),
        eta=put("eta", torch.float32).reshape(()),
        cap=put("cap", torch.float32).reshape(()),
        p=put("p", torch.float32),
        u_key=torch.tensor(_i64(key), dtype=torch.int64, device=dev),
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
    track_opt: bool = True,
    keep_carry: bool = True,
    device: DeviceLike = None,
) -> RunResult:
    """Replay a trace through one policy, chunk by chunk on the device.

    The trace is cut into ``T // window`` chunks of ``window`` requests (a
    trailing partial chunk is dropped); ``window`` is the OGB update batch
    B.  ``eta=None`` resolves through ``pd.default_eta`` for the replayed
    horizon.  ``device=None`` is the CUDA card, and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.  For ``ogb_tree``
    the result's ``extras`` holds ``host_syncs`` (steps that read the
    device to decide a re-anchor) and ``reanchors``.

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
            device=dev,
        )
        if eta is not None:
            extras["eta"] = float(eta)
    elif eta is not None or horizon is not None or seed != 0:
        # a resumed run takes every policy parameter from the carry; a
        # silently ignored eta or seed would mislabel the result
        raise ValueError(
            "run(carry=...) resumes with the carry's parameters; do not pass "
            "seed/eta/horizon alongside a carry"
        )
    elif carry.catalog.device != dev:
        raise ValueError(f"carry is on {carry.catalog.device}, run was asked for {dev}")
    if pd.start is not None:
        carry = pd.start(carry)
    n = carry.catalog.shape[0]
    lo, hi = int(trace_used.min()), int(trace_used.max())
    if lo < 0 or hi >= n:
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
