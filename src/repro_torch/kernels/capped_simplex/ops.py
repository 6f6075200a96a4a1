"""The capped-simplex catalog passes and the K-way fused OGB update.

Counterpart of ``repro.kernels.capped_simplex.ops``.  ``masses`` and
``apply`` launch ``csrc/mass.cu`` and ``csrc/apply.cu`` on a CUDA tensor and
run the plain versions of :mod:`.ref` on a CPU tensor; ``project_warm_tau``
launches the warm projection's whole threshold solve, one persistent
launch of ``csrc/mass.cu``, and ``project_warm`` the same launch with the
final clip in its epilogue; either takes one row f of (N,) items or R rows
(R, N) over one histogram, a sweep's grid in one launch (one a group of
rows, :func:`warm_groups`, past ~68 rows of 1e6 items on an H100), or over
R histograms (R, N), a fleet's tenants, a row of counts a row of f.
Scalars (``eta``, the thresholds, ``tau``) stay
on the device and the kernels read them by pointer, so no call waits on the
host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.capped_simplex.ref import (
    apply_ref,
    masses_ref,
    project_warm_ref,
    project_warm_tau_ref,
    warm_rows_ref,
)

Scalar = Union[float, torch.Tensor]

#: per-item work of one mass partials block; the grid is capped so that the
#: partials stay small and the finishing block sums at most this many
_MASS_ITEMS_PER_BLOCK = 1024
_MASS_MAX_BLOCKS = 1024
#: threads of a warm-projection block and items of y each keeps in
#: registers (kWarmThreads and kWarmItems of csrc/mass.cu)
WARM_THREADS, WARM_ITEMS = 1024, 8
#: the most rows one block's tiles may touch, and the tiles of a block's
#: round of partials (kWarmRowsPerBlock, kWarmTilesPerBlock)
WARM_ROWS_PER_BLOCK, WARM_TILES_PER_BLOCK = 64, 64
STANDALONE, EPILOGUE = "standalone", "projection epilogue"


def as_scalar(x: Scalar, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` (a tensor must already be there)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"scalar is on {x.device}, expected {device}")
        return x.reshape(()).to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _check_catalog(f: torch.Tensor, counts: torch.Tensor) -> None:
    if f.dim() != 1 or f.shape != counts.shape or f.numel() == 0:
        raise ValueError(
            f"f and counts must be non-empty 1-D of one shape, got "
            f"{tuple(f.shape)} and {tuple(counts.shape)}"
        )
    if f.device != counts.device:
        raise ValueError(f"f is on {f.device}, counts on {counts.device}")


@functools.lru_cache(maxsize=None)
def _mass_entry():
    fn = _build.library("mass").repro_masses
    p = ctypes.c_void_p
    fn.argtypes = [
        p, p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p, p, p, p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _warm_entry():
    fn = _build.library("mass").repro_project_warm
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    fn.argtypes = [p, p, ll, p, p, p, p, p, ll, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _apply_entry():
    fn = _build.library("apply").repro_apply
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def masses(
    f: torch.Tensor, counts: torch.Tensor, eta: Scalar, taus: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mass[K], cnt[K]) of y = f + eta * counts at each threshold of ``taus``.

    ``mass[k] = sum(clip(y - taus[k], 0, 1))`` and ``cnt[k]`` is the number
    of items strictly inside (0, 1) there, as float32.  Any K >= 1.
    """
    _check_catalog(f, counts)
    eta = as_scalar(eta, f.device)
    if taus.dim() != 1 or taus.numel() == 0:
        raise ValueError(f"taus must be non-empty 1-D, got {tuple(taus.shape)}")
    if f.device.type == "cpu":
        return masses_ref(f, counts, eta, taus)
    for t, name in ((f, "f"), (counts, "counts"), (eta, "eta"), (taus, "taus")):
        _build.require(t, torch.float32, name, f.device)
    n, k = f.numel(), taus.numel()
    blocks = min(-(-n // _MASS_ITEMS_PER_BLOCK), _MASS_MAX_BLOCKS)
    pmass = torch.empty(k * blocks, dtype=torch.float32, device=f.device)
    pcnt = torch.empty(k * blocks, dtype=torch.int32, device=f.device)
    mass = torch.empty(k, dtype=torch.float32, device=f.device)
    cnt = torch.empty(k, dtype=torch.float32, device=f.device)
    _build.check(
        _mass_entry()(
            f.data_ptr(), counts.data_ptr(), eta.data_ptr(), taus.data_ptr(), k, n,
            blocks, pmass.data_ptr(), pcnt.data_ptr(), mass.data_ptr(),
            cnt.data_ptr(), _build.stream_of(f),
        ),
        "masses",
    )
    _build.counted(masses, "k-way, partials and finish")
    return mass, cnt


masses.launches = 0
masses.designs = {}


def warm_groups(n: int, sms: int, stream_blocks_per_sm: int, rows: int) -> list:
    """The launches of the warm projection over ``rows`` rows of ``n``
    items: ``(start, stop)`` row ranges of near-equal size, each as many
    rows as keep a streaming block within ``WARM_TILES_PER_BLOCK`` tiles
    (one range for an 18-row grid at n = 1e6 on 132 SMs); a row whose tiles
    alone pass that takes a launch of its own, its blocks more tiles each."""
    tiles = -(-n // (WARM_THREADS * WARM_ITEMS))
    per = max(1, sms * stream_blocks_per_sm * WARM_TILES_PER_BLOCK // tiles)
    groups = -(-rows // per)
    size = -(-rows // groups)
    return [(r, min(r + size, rows)) for r in range(0, rows, size)]


def warm_plan(n: int, sweeps: int, sms: int, resident_blocks_per_sm: int,
              stream_blocks_per_sm: int, rows: int = 1) -> dict:
    """One persistent launch of the warm projection over ``rows`` rows of
    ``n`` items.

    Each row is cut into ``tiles`` fixed tiles of ``WARM_THREADS *
    WARM_ITEMS`` items (the order of a row's sums, whatever the grid).  If
    every tile has a resident block of the kernel that keeps y in registers
    (``sms`` times the blocks an SM holds of it), a block takes one tile;
    else the kernel that re-reads f and c every sweep takes ``per_block``
    contiguous tiles a block, in rounds of ``WARM_TILES_PER_BLOCK``.
    ``partials`` is the length of each of the (sweeps, rows, tiles)
    partials buffers (the mass in float64, the count in int32).  Raises
    where a block would touch more than ``WARM_ROWS_PER_BLOCK`` rows:
    :func:`warm_groups` splits the rows so that none does."""
    tiles = -(-n // (WARM_THREADS * WARM_ITEMS))
    total = rows * tiles
    resident = total <= sms * resident_blocks_per_sm
    per_block = 1 if resident else -(-total // (sms * stream_blocks_per_sm))
    blocks = -(-total // per_block)
    if total + per_block >= 2**31 or (per_block + tiles - 2) // tiles + 1 > WARM_ROWS_PER_BLOCK:
        raise ValueError(f"{rows} rows of {n} items: a block would touch more than "
                         f"{WARM_ROWS_PER_BLOCK} rows")
    return {"blocks": blocks, "resident": resident, "tiles": tiles, "per_block": per_block,
            "partials": sweeps * total,
            "design": "persistent, y " + ("in registers" if resident else "re-read from L2")}


def _warm_scalars(f, counts, eta, capacity, lo, hi, tau0) -> tuple:
    """The five scalars, as 0-d float32 tensors for one row (f of shape
    (N,)) or (R,) tensors for R rows (f of shape (R, N), over counts (N,) or
    (R, N))."""
    if f.dim() == 1:
        _check_catalog(f, counts)
        return tuple(as_scalar(x, f.device) for x in (eta, capacity, lo, hi, tau0))
    if f.dim() != 2 or counts.shape not in (f.shape[1:], f.shape) or f.numel() == 0:
        raise ValueError(f"f must be (N,) or (R, N) over counts (N,) or (R, N), got "
                         f"{tuple(f.shape)} and {tuple(counts.shape)}")
    if f.device != counts.device:
        raise ValueError(f"f is on {f.device}, counts on {counts.device}")
    rows = f.shape[0]
    out = []
    for x in (eta, capacity, lo, hi, tau0):
        x = as_scalar(x, f.device) if not isinstance(x, torch.Tensor) or x.dim() == 0 else x
        out.append(x.to(torch.float32).expand(rows).contiguous() if x.dim() == 0 else x)
        if out[-1].shape != (rows,) or out[-1].device != f.device:
            raise ValueError(f"a row scalar must be 0-d or ({rows},) on {f.device}, got "
                             f"{tuple(out[-1].shape)} on {out[-1].device}")
    return tuple(out)


def _launch_warm(f: torch.Tensor, counts: torch.Tensor, scalars: tuple, sweeps: int,
                 out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """The persistent launches of the warm projection over f's rows, one a
    group of :func:`warm_groups` (its epilogue writes ``out`` unless it is
    None); returns tau (0-d for one row, (R,) for R) and each launch's
    design."""
    dev = f.device
    for t, name in zip((f, counts) + scalars,
                       ("f", "counts", "eta", "capacity", "lo", "hi", "tau0")):
        _build.require(t, torch.float32, name, dev)
    rows, n = (1, f.numel()) if f.dim() == 1 else f.shape
    sms = _build.sm_count(dev.index)
    per_sm = tuple(_build.blocks_per_sm("mass", "repro_project_warm_occupancy", dev.index,
                                        resident) for resident in (True, False))
    groups = warm_groups(n, sms, per_sm[1], rows)
    plans = [warm_plan(n, sweeps, sms, *per_sm, rows=r1 - r0) for r0, r1 in groups]
    partials = max(plan["partials"] for plan in plans)
    pmass = torch.empty(partials, dtype=torch.float64, device=dev)
    pcnt = torch.empty(partials, dtype=torch.int32, device=dev)
    tau = torch.empty(rows, dtype=torch.float32, device=dev)
    c_stride = n if counts.dim() == 2 else 0  # a row of counts a row of f, or one for all
    for (r0, r1), plan in zip(groups, plans):
        _build.check(
            _warm_entry()(
                f.data_ptr() + 4 * r0 * n, counts.data_ptr() + 4 * r0 * c_stride, c_stride,
                *(x.data_ptr() + 4 * r0 for x in scalars), n, r1 - r0, sweeps,
                plan["blocks"], plan["per_block"], int(plan["resident"]), pmass.data_ptr(),
                pcnt.data_ptr(), tau.data_ptr() + 4 * r0,
                None if out is None else out.data_ptr() + 4 * r0 * n, _build.stream_of(f),
            ),
            "project_warm",
        )
    return tau.reshape(()) if f.dim() == 1 else tau, [plan["design"] for plan in plans]


def project_warm_tau(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: Scalar,
    capacity: Scalar,
    lo: Scalar,
    hi: Scalar,
    tau0: Scalar,
    sweeps: int,
) -> torch.Tensor:
    """The warm projection's threshold: ``sweeps`` safeguarded Newton steps
    on g(tau) = sum(clip(f + eta * counts - tau, 0, 1)) = C from
    clamp(tau0, lo, hi), as :func:`.ref.project_warm_tau_ref` takes them;
    a 0-d float32 tensor.  On the card the whole solve is one persistent
    launch.

    ``f`` may also be (R, N), R rows over the one ``counts`` (a sweep) or
    over (R, N) ``counts``, a row each (a fleet), each scalar 0-d or (R,):
    then tau is (R,), one launch a group of rows (:func:`warm_groups`), and
    each row's tau is bit for bit the one its row gives alone (on the CPU,
    a loop of the plain version over the rows)."""
    scalars = _warm_scalars(f, counts, eta, capacity, lo, hi, tau0)
    if f.device.type == "cpu":
        if f.dim() == 2:
            return warm_rows_ref(project_warm_tau_ref, f, counts, scalars, sweeps)
        return project_warm_tau_ref(f, counts, *scalars, sweeps)
    tau, plans = _launch_warm(f, counts, scalars, sweeps, None)
    for plan in plans:
        _build.counted(project_warm_tau, plan)
    return tau


project_warm_tau.launches = 0
project_warm_tau.designs = {}


def project_warm(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: Scalar,
    capacity: Scalar,
    lo: Scalar,
    hi: Scalar,
    tau0: Scalar,
    sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f', tau): :func:`project_warm_tau`'s tau and f' = clip(f + eta *
    counts - tau, 0, 1) at it, as :func:`.ref.project_warm_ref` gives them.
    On the card both come from one launch, f' from the solve's epilogue; it
    counts as a ``mass`` launch and as an ``apply`` (the clip), by the
    design ``"projection epilogue"``.  An (R, N) ``f`` gives (R, N) f' and
    (R,) tau in one launch, as :func:`project_warm_tau` does."""
    scalars = _warm_scalars(f, counts, eta, capacity, lo, hi, tau0)
    if f.device.type == "cpu":
        if f.dim() == 2:
            return warm_rows_ref(project_warm_ref, f, counts, scalars, sweeps)
        return project_warm_ref(f, counts, *scalars, sweeps)
    out = torch.empty_like(f)
    tau, plans = _launch_warm(f, counts, scalars, sweeps, out)
    for plan in plans:
        _build.counted(project_warm, plan)
        _build.counted(apply, EPILOGUE)
    return out, tau


project_warm.launches = 0
project_warm.designs = {}


def apply(f: torch.Tensor, counts: torch.Tensor, eta: Scalar, tau: Scalar) -> torch.Tensor:
    """f' = clip(f + eta * counts - tau, 0, 1), into a new tensor.  On the
    card f' is given f's offset modulo 16 bytes, so a view of f and counts
    that starts mid-vector still takes the kernel's 16-byte body."""
    _check_catalog(f, counts)
    eta = as_scalar(eta, f.device)
    tau = as_scalar(tau, f.device)
    if f.device.type == "cpu":
        return apply_ref(f, counts, eta, tau)
    for t, name in ((f, "f"), (counts, "counts"), (eta, "eta"), (tau, "tau")):
        _build.require(t, torch.float32, name, f.device)
    n = f.numel()
    shift = f.data_ptr() % 16 // 4
    out = torch.empty(n + shift, dtype=torch.float32, device=f.device)[shift:]
    _build.check(
        _apply_entry()(
            f.data_ptr(), counts.data_ptr(), eta.data_ptr(), tau.data_ptr(), n,
            out.data_ptr(), _build.sm_count(f.device.index), _build.stream_of(f),
        ),
        "apply",
    )
    _build.counted(apply, STANDALONE)
    return out


apply.launches = 0
apply.designs = {}


def fused_ogb_update(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: Scalar,
    capacity: Scalar,
    passes: int = 3,
    k: int = 64,
    tau0: Optional[Scalar] = None,
    hi: Optional[Scalar] = None,
    return_tau: bool = False,
):
    """f' = Proj_F(f + eta * counts) by K-way bracketing, as the TPU driver does.

    ``passes`` launches of :func:`masses` at ``k`` thresholds spread over
    [lo, hi] narrow the bracket to width (hi - lo) / (k - 1)^passes; the
    threshold is then interpolated on the bracket's linear piece and one
    :func:`apply` writes f'.  The bracket is [0, 1 + eta * sum(counts)], or
    [tau0, tau0 + warm_bracket_hi(eta * sum(counts))] when ``tau0`` is given
    (see ``repro.kernels.capped_simplex.ops.fused_ogb_update`` for when a
    nonzero ``tau0`` is a valid lower bound).  ``tau0``, ``hi`` and
    ``return_tau`` mirror the reference's signature; no path of the port
    passes them yet.
    """
    from repro_torch.jaxcache.fractional import warm_bracket_hi

    dev = f.device
    eta = as_scalar(eta, dev)
    cap = as_scalar(capacity, dev)
    step_mass = eta * counts.sum()
    if tau0 is None:
        lo = torch.zeros((), dtype=torch.float32, device=dev)
        hi = 1.0 + step_mass if hi is None else as_scalar(hi, dev)
    else:
        lo = as_scalar(tau0, dev)
        hi = lo + warm_bracket_hi(step_mass) if hi is None else as_scalar(hi, dev)
    frac = torch.arange(k, dtype=torch.float32, device=dev) / (k - 1)
    for _ in range(passes):
        taus = lo + (hi - lo) * frac
        mass, cnt = masses(f, counts, eta, taus)
        # last candidate with mass >= C (mass is non-increasing in tau)
        idx = torch.clamp((mass >= cap).sum() - 1, min=0).reshape(1)
        lo = taus.gather(0, idx)[0]
        hi = taus.gather(0, torch.clamp(idx + 1, max=k - 1))[0]
        g_lo = mass.gather(0, idx)[0]
        cnt_lo = cnt.gather(0, idx)[0]
    # g(tau) = g(lo) - cnt_lo * (tau - lo) while no breakpoint is crossed
    tau_interp = lo + (g_lo - cap) / torch.clamp(cnt_lo, min=1.0)
    tau = torch.where(
        cnt_lo > 0, torch.clamp(tau_interp, lo, hi), 0.5 * (lo + hi)
    )
    out = apply(f, counts, eta, tau)
    return (out, tau) if return_tau else out


# -- the weighted (knapsack) capped simplex -----------------------------------
#
# Sized objects (core/ogb_sized.py, paper §8): the feasible set becomes
# F_s = {f in [0,1]^N : sum_i s_i f_i = C} and the Euclidean projection is
# f_i = clip(y_i - s_i * tau, 0, 1), tau the root of the weighted mass
# g(tau) = sum_i s_i clip(y_i - s_i tau, 0, 1) = C: non-increasing and
# piecewise linear with slope -sum_{interior} s_i^2.  As in the reference
# (repro.kernels.capped_simplex.ops), these are plain tensor sweeps, not
# kernels: they are the scan flavor of ``ogb_sized``, the differential
# oracle of the tree flavor, whose per-chunk solve is the card's
# (prefix_tree.kernel.solve_sized).


def _weighted_mass(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # summed as masses_ref sums a (1, N) row, so that sizes == 1 gives the
    # unit path's bits
    return (s * torch.clamp(y - s * t, 0.0, 1.0))[None, :].sum(dim=1)[0]


def weighted_simplex_project(
    y: torch.Tensor,
    sizes: torch.Tensor,
    capacity: Scalar,
    iters: int = 50,
    lo: Optional[Scalar] = None,
    hi: Optional[Scalar] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bisection projection of ``y`` onto F_s; returns (f, tau).

    Step for step the unit bisection
    (:func:`repro_torch.jaxcache.fractional.capped_simplex_project`): the
    cold bracket [min((y - 1) / s), max(y / s)] and midpoint bisection on
    ``mass >= C``, so ``sizes == 1`` gives its bits on the CPU.  Sizes
    must be > 0 (the callers check them on the host)."""
    dev = y.device
    s = sizes.to(y.dtype)
    cap = as_scalar(capacity, dev)
    lo = torch.min((y - 1.0) / s) if lo is None else as_scalar(lo, dev)
    hi = torch.max(y / s) if hi is None else as_scalar(hi, dev)
    lo, hi = lo.to(torch.float32), hi.to(torch.float32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_much = _weighted_mass(y, s, mid) >= cap
        lo, hi = torch.where(too_much, mid, lo), torch.where(too_much, hi, mid)
    tau = 0.5 * (lo + hi)
    return torch.clamp(y - s * tau, 0.0, 1.0), tau


def weighted_simplex_project_warm(
    y: torch.Tensor,
    sizes: torch.Tensor,
    capacity: Scalar,
    lo: Scalar,
    hi: Scalar,
    tau0: Scalar,
    sweeps: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-bracketed safeguarded Newton on the weighted mass; returns (f, tau).

    Each sweep evaluates g(t) and its slope in one pass, shrinks the
    bracket by the sign of g(t) - C and takes the Newton point where the
    slope is positive and the point lies in the bracket, else the midpoint.
    Needs g(lo) >= C >= g(hi).  The safeguard is the reference's, which
    accepts a Newton point equal to an end of the bracket (ROADMAP.md §3:
    on some instances the iterate alternates between the two ends)."""
    dev = y.device
    cap = as_scalar(capacity, dev)
    s = sizes.to(y.dtype)
    lo, hi = as_scalar(lo, dev), as_scalar(hi, dev)
    t = torch.clamp(as_scalar(tau0, dev), lo, hi)
    for _ in range(sweeps):
        clipped = torch.clamp(y - s * t, 0.0, 1.0)
        interior = (clipped > 0.0) & (clipped < 1.0)
        mass = (s * clipped).sum()
        slope = torch.where(interior, s * s, torch.zeros_like(s)).sum()
        too_much = mass >= cap
        lo = torch.where(too_much, t, lo)
        hi = torch.where(too_much, hi, t)
        t_newton = t + (mass - cap) / torch.clamp(slope, min=1e-12)
        t_mid = 0.5 * (lo + hi)
        ok = (slope > 0.0) & (t_newton >= lo) & (t_newton <= hi)
        t = torch.where(ok, t_newton, t_mid)
    return torch.clamp(y - s * t, 0.0, 1.0), t
