"""The prefix-tree block reductions: one tree level, and bucket masses.

Counterpart of ``repro.kernels.prefix_tree.kernel``.  On a CUDA tensor
:func:`block_segment_sums` launches ``csrc/segsum.cu`` and
:func:`bucket_masses` ``csrc/bucket_mass.cu``; on a CPU tensor each runs
its plain version in :mod:`.ref`.  The thresholds stay on the device and
the kernel reads them by pointer, so no call waits on the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_tree.ref import bucket_masses_ref, segment_sums_ref

#: buckets of one bucket-mass partials block; the grid is capped so that
#: the finishing block sums at most this many partials
_MASS_ITEMS_PER_BLOCK = 1024
_MASS_MAX_BLOCKS = 1024


@functools.lru_cache(maxsize=None)
def _segsum_entry():
    fn = _build.library("segsum").repro_segsum
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bucket_mass_entry():
    fn = _build.library("bucket_mass").repro_bucket_masses
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def block_segment_sums(values: torch.Tensor, out_size: int, radix: int) -> torch.Tensor:
    """One tree-build level: (out_size,) sums of ``radix`` consecutive
    float32 children, the last group zero-padded."""
    if values.dim() != 1 or radix < 1 or out_size * radix < values.shape[0]:
        raise ValueError(
            f"{values.shape[0]} values do not fit {out_size} groups of {radix}"
        )
    if values.device.type == "cpu":
        return segment_sums_ref(values, out_size, radix)
    _build.require(values, torch.float32, "values")
    out = torch.empty(out_size, dtype=torch.float32, device=values.device)
    _build.check(
        _segsum_entry()(
            values.data_ptr(), values.numel(), radix, out.data_ptr(), out_size,
            _build.stream_of(values),
        ),
        "block_segment_sums",
    )
    block_segment_sums.launches += 1
    return out


block_segment_sums.launches = 0


def bucket_masses(cnt: torch.Tensor, total: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[k] = sum_b cnt_b * clip(mean_b - taus[k], 0, 1) over (V,)
    bucket counts and sums: float32 terms summed in float64, rounded to
    float32.  Any K >= 1."""
    if cnt.dim() != 1 or cnt.shape != total.shape or cnt.numel() == 0:
        raise ValueError(
            f"cnt and total must be non-empty 1-D of one shape, got "
            f"{tuple(cnt.shape)} and {tuple(total.shape)}"
        )
    if taus.dim() != 1 or taus.numel() == 0:
        raise ValueError(f"taus must be non-empty 1-D, got {tuple(taus.shape)}")
    if cnt.device.type == "cpu":
        return bucket_masses_ref(cnt, total, taus)
    for t, name in ((cnt, "cnt"), (total, "total"), (taus, "taus")):
        _build.require(t, torch.float32, name, cnt.device)
    v, k = cnt.numel(), taus.numel()
    blocks = min(-(-v // _MASS_ITEMS_PER_BLOCK), _MASS_MAX_BLOCKS)
    pmass = torch.empty(k * blocks, dtype=torch.float64, device=cnt.device)
    mass = torch.empty(k, dtype=torch.float32, device=cnt.device)
    _build.check(
        _bucket_mass_entry()(
            cnt.data_ptr(), total.data_ptr(), taus.data_ptr(), k, v, blocks,
            pmass.data_ptr(), mass.data_ptr(), _build.stream_of(cnt),
        ),
        "bucket_masses",
    )
    bucket_masses.launches += 1
    return mass


bucket_masses.launches = 0
