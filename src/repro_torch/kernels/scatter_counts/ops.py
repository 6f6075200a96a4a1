"""The gradient histogram: dense float32 counts of request ids.

Counterpart of ``repro.kernels.scatter_counts.ops.scatter_counts``.  On a
CUDA tensor it launches ``csrc/histogram.cu``; on a CPU tensor it runs the
plain version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scatter_counts.ref import histogram_ref


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("histogram").repro_histogram
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def histogram(ids: torch.Tensor, catalog_size: int) -> torch.Tensor:
    """Dense float32 histogram of int32 ``ids`` over ``[0, catalog_size)``.

    Ids outside that range (negative padding, or >= catalog_size) are
    ignored, as the TPU kernel ignores them.
    """
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
    if ids.device.type == "cpu":
        return histogram_ref(ids, catalog_size)
    _build.require(ids, torch.int32, "ids")
    counts = torch.empty(catalog_size, dtype=torch.float32, device=ids.device)
    _build.check(
        _entry()(
            ids.data_ptr(), ids.numel(), counts.data_ptr(), catalog_size,
            _build.stream_of(ids),
        ),
        "histogram",
    )
    histogram.launches += 1
    return counts


histogram.launches = 0
