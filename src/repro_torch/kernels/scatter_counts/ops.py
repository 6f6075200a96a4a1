"""The gradient histogram: dense float32 counts of request ids.

Counterpart of ``repro.kernels.scatter_counts.ops.scatter_counts``.  On a
CUDA tensor it launches ``csrc/histogram.cu`` once, in the plan
:func:`design` names; on a CPU tensor it runs the plain version in
:mod:`.ref`.  A fleet's (R, B) ids, a row of ids a tenant, give (R, N)
counts in one bin-tiles launch, each row its own one-row call's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scatter_counts.ref import histogram_ref

BIN_TILES, ID_SLICES = "bin tiles", "id slices"
#: the most rows of ids one launch takes (the grid's y dimension)
MAX_ROWS = 65535
#: threads of a bin-tiles block, the bins it keeps in shared memory, and
#: the blocks an SM is given before tiles loop (kTileThreads and kTileBins
#: of csrc/histogram.cu; 4 blocks of 32 KB fill an SM's threads)
TILE_THREADS, TILE_BINS, TILE_BLOCKS_PER_SM = 512, 8192, 4
#: threads of an id-slices block, the bins of its 16-bit counters in shared
#: memory, and the ids it counts before they are flushed (kSliceThreads,
#: kSliceBins and kPieceIds of csrc/histogram.cu)
SLICE_THREADS, SLICE_BINS, SLICE_PIECE_IDS = 1024, 65536, 64512


def design(b: int, n: int) -> str:
    """The plan a CUDA call over ``b`` ids and ``n`` bins launches.

    A bin-tiles block reads every id; an id-slices block zeroes and scans
    its n / 2 words of paired 16-bit counters.  So the ids are sliced once
    there are more of them than half the bins: the chunk's gradient (1000
    ids over 1e6 items) takes bin tiles, a re-anchor's bucket ids (1e6 over
    65 536 buckets) id slices.  Bins that fit one tile take bin tiles
    whatever the ids, one block and no cooperative launch over every SM:
    ``ogb_tree``'s count of a chunk's requests by lead (1000 over 1000)."""
    return ID_SLICES if 2 * b > n > TILE_BINS else BIN_TILES


def histogram_plan(b: int, n: int, sms: int, slice_blocks_per_sm: int, rows: int = 1) -> dict:
    """The launch over ``b`` ids and ``n`` bins on ``sms`` SMs: bin tiles on
    one block a tile, at most ``TILE_BLOCKS_PER_SM`` an SM (each of ``rows``
    rows of ids as many: a fleet's rows always take bin tiles); id slices
    on every resident slot (``slice_blocks_per_sm`` an SM), a cooperative
    launch."""
    plan = design(b, n) if rows == 1 else BIN_TILES
    if plan == ID_SLICES:
        blocks = sms * slice_blocks_per_sm
    else:
        blocks = max(1, min(-(-n // TILE_BINS), sms * TILE_BLOCKS_PER_SM))
    return {"design": plan, "blocks": blocks}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("histogram").repro_histogram
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_longlong, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def histogram(ids: torch.Tensor, catalog_size: int) -> torch.Tensor:
    """Dense float32 histogram of int32 ``ids`` over ``[0, catalog_size)``.

    Ids outside that range (negative padding, or >= catalog_size) are
    ignored, as the TPU kernel ignores them.  ``ids`` of shape (R, B), a
    row of ids a tenant, give (R, catalog_size) counts, row r the histogram
    of ids[r]: one bin-tiles launch for every row on the card (a block a
    tile and a row), the plain version row by row on the CPU.
    """
    if ids.dim() not in (1, 2):
        raise ValueError(f"ids must be 1-D or 2-D, got shape {tuple(ids.shape)}")
    if ids.device.type == "cpu":
        return histogram_ref(ids, catalog_size)
    _build.require(ids, torch.int32, "ids")
    dev = ids.device
    rows = ids.shape[0] if ids.dim() == 2 else 1
    if rows > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows of ids a launch, got {rows}")
    counts = torch.empty(tuple(ids.shape[:-1]) + (catalog_size,), dtype=torch.float32,
                         device=dev)
    if catalog_size == 0 or rows == 0:
        return counts
    b = ids.shape[-1]
    slices = rows == 1 and design(b, catalog_size) == ID_SLICES
    per_sm = (_build.blocks_per_sm("histogram", "repro_histogram_slices_occupancy", dev.index, True)
              if slices else 0)
    plan = histogram_plan(b, catalog_size, _build.sm_count(dev.index), per_sm, rows)
    _build.check(
        _entry()(
            ids.data_ptr(), b, counts.data_ptr(), catalog_size, rows, int(slices),
            plan["blocks"], _build.stream_of(ids),
        ),
        "histogram",
    )
    _build.counted(histogram, plan["design"])
    return counts


histogram.launches = 0
histogram.designs = {}
