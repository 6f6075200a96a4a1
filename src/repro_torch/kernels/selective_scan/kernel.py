"""Binding of ``csrc/selective_scan.cu``: Mamba's selective scan, a thread a channel.

Counterpart of the ``lax.scan`` in ``repro.models.mamba.mamba_forward``,
which has no Pallas kernel.  A block of 128 threads takes as many channels
of one sequence; each thread keeps its channel's n state values and its row
of A, pre-scaled by log2(e), in registers for the whole sequence, and takes
each decay as half of one ``ex2.approx.ftz`` of 1 + dt a' (the argument the
accurate ``expf`` hands the SFU where a decay is near 1).  A prompt (S > 1)
runs the prefill design (:data:`DESIGN`): x, dt, B and C reach shared
memory :data:`CHUNK` steps at a time by asynchronous copies, in a ring of
:data:`STAGES` chunks, at :data:`MIN_BLOCKS` blocks an SM (the plan
``tools/time_selective_scan_designs.py --sweep`` chose).  A decode step
(S = 1) runs a kernel of its own (:data:`DESIGN_STEP`): every load first,
the state and A moved a warp's 32 rows at a time, no block barrier.  The
state is read from, and written back to, the tensor given.  It takes n in
:data:`STATE_DIMS`, contiguous float32 inputs on 16-byte boundaries; any
other call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)  # n, a template argument of the kernel
#: the prefill design's plan: blocks an SM (the __launch_bounds__ minimum),
#: steps a chunk, chunks in the ring, steps unrolled together (kMinBlocks,
#: kChunk, kStages, kUnroll in the source)
MIN_BLOCKS, CHUNK, STAGES, UNROLL = 3, 32, 2, 4
DESIGN = ("a thread a channel, its n states (scaled by 2^j at a chunk's step j) and row of A "
          "log2(e) in registers; 128 channels of one sequence a block, 3 blocks an SM; 2 dec "
          "one ex2.approx of fma(dt, a', 1), h and y by fmas; x, dt, B and C staged by "
          "cp.async, 32 steps a chunk in a 2-chunk ring")
DESIGN_STEP = ("a decode step: a thread a channel, every load (state, A, x, dt, D, B, C) "
               "issued before its arithmetic; the state and A read and written a warp's 32 "
               "rows at a time through a swizzled shared copy; no block barrier")


def design(S: int) -> str:
    """The design a launch over S steps runs: the decode step's at S = 1."""
    return DESIGN_STEP if S == 1 else DESIGN


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("selective_scan").repro_selective_scan
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, D: torch.Tensor, state: torch.Tensor) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"need x and dt of one (B, S, d_in) shape; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    B, S, d_in = x.shape
    if S < 1:
        raise ValueError("the sequence is empty")
    if A.dim() != 2 or A.shape[0] != d_in:
        raise ValueError(f"A must be ({d_in}, n), got {tuple(A.shape)}")
    n = A.shape[1]
    for t, name in ((Bm, "Bm"), (Cm, "Cm")):
        if t.shape != (B, S, n):
            raise ValueError(f"{name} must be ({B}, {S}, {n}), got {tuple(t.shape)}")
    if D.shape != (d_in,):
        raise ValueError(f"D must be ({d_in},), got {tuple(D.shape)}")
    if state.shape != (B, d_in, n):
        raise ValueError(f"state must be ({B}, {d_in}, {n}), got {tuple(state.shape)}")


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, D: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors; returns y (B, S, d_in), the final
    state written into ``state``."""
    B, S, d_in = x.shape
    n = A.shape[1]
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} is outside the kernel's {STATE_DIMS}")
    for t, name in ((x, "x"), (dt, "dt"), (A, "A"), (Bm, "Bm"), (Cm, "Cm"), (D, "D"),
                    (state, "state")):
        _build.require(t, torch.float32, name, x.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x)
    _build.check(
        _entry()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 D.data_ptr(), state.data_ptr(), y.data_ptr(), B, S, d_in, n,
                 _build.stream_of(x)),
        "selective_scan",
    )
    return y
