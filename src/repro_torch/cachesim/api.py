"""The policy protocol and the replay loop, for the OGB policy.

Counterpart of ``repro.cachesim.api``: a :class:`PolicyDef` is an
``(init, step)`` pair whose carry holds the policy state and its parameters
(eta, capacity, sampling randomness) as tensors, and :func:`run` replays a
trace through it.  This slice registers ``policy_def("ogb")`` only.

The reference's ``lax.scan`` becomes a Python loop over chunks on the
device.  Nothing in the loop waits on the host: per-chunk outputs go into
preallocated device tensors, and :func:`run` synchronises once at the end.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim.replay import _make_ogb_step, sampling_keys
from repro_torch.cachesim.results import RunResult
from repro_torch.core.ogb import theoretical_eta
from repro_torch.core.regret import best_static_hits
from repro_torch.jaxcache.fractional import DEFAULT_BISECT_ITERS, DEFAULT_WARM_SWEEPS

__all__ = [
    "OGBCarry",
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
    t: torch.Tensor  # () int32 chunk counter


@dataclass(frozen=True)
class PolicyDef:
    """An ``(init, step)`` caching policy.

    ``init(catalog_size, capacity, *, seed, eta, horizon, device) -> carry``;
    ``step(carry, ids) -> (carry, StepOut)``.  ``default_eta`` resolves
    ``eta=None`` at :func:`run` time from ``(catalog_size, capacity,
    horizon, window)``.
    """

    kind: str
    name: str
    init: Callable[..., Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, StepOut]]
    default_eta: Optional[Callable[[int, int, int, int], float]] = None


def _ogb_def(
    sample: str = "poisson",
    projection: str = "warm",
    sweeps: int = DEFAULT_WARM_SWEEPS,
    iters: int = DEFAULT_BISECT_ITERS,
) -> PolicyDef:
    raw = _make_ogb_step(sample, projection, sweeps, iters)

    def init(catalog_size, capacity, *, seed=0, eta=None, horizon=None, device=None):
        del horizon  # eta is resolved by run(); kept for the reference's signature
        if eta is None:
            raise ValueError("ogb init needs eta (run() resolves eta=None)")
        dev = resolve_device(device)
        return OGBCarry(
            f=torch.full((catalog_size,), capacity / catalog_size, dtype=torch.float32,
                         device=dev),
            tau=torch.zeros((), dtype=torch.float32, device=dev),
            eta=torch.tensor(float(eta), dtype=torch.float32, device=dev),
            cap=torch.tensor(float(capacity), dtype=torch.float32, device=dev),
            p=sampling_keys(seed, catalog_size, sample, dev),
            t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(carry, ids):
        f, tau, (reward, hits, tau_o, occ) = raw(
            carry.eta, carry.p, carry.cap, carry.f, carry.tau, ids
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


_POLICY_DEFS = {"ogb": _ogb_def}


@functools.lru_cache(maxsize=None)
def _cached_def(kind: str, options: tuple) -> PolicyDef:
    return _POLICY_DEFS[kind](**dict(options))


def policy_def(kind: str, **options) -> PolicyDef:
    """Resolve a kind to a (memoized) :class:`PolicyDef`.

    ``policy_def("ogb", sample="poisson"|"none", projection="warm"|"bisect",
    sweeps=5, iters=50)``.
    """
    kind = kind.lower()
    if kind not in _POLICY_DEFS:
        raise KeyError(
            f"unknown policy kind {kind!r}; ported so far: {sorted(_POLICY_DEFS)}"
        )
    return _cached_def(kind, tuple(sorted(options.items())))


def carry_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None) -> OGBCarry:
    """An :class:`OGBCarry` from the reference's carry leaves as numpy arrays.

    Reads ``f, tau, eta, cap, p, t``; other leaves of the reference's carry
    (its Madow key) are not part of this slice's carry.  This is how a run
    is started from the reference's own Poisson ``p``, whose random stream
    PyTorch cannot reproduce.
    """
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=dev)

    return OGBCarry(
        f=put("f", torch.float32),
        tau=put("tau", torch.float32).reshape(()),
        eta=put("eta", torch.float32).reshape(()),
        cap=put("cap", torch.float32).reshape(()),
        p=put("p", torch.float32),
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
    ``device="cpu"`` runs the kernels' plain versions.

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
    elif carry.f.device != dev:
        raise ValueError(f"carry is on {carry.f.device}, run was asked for {dev}")
    n = carry.f.shape[0]
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
