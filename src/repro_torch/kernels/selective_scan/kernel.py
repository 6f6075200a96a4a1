"""Binding of ``csrc/selective_scan.cu``: Mamba's selective scan, a thread a channel.

Counterpart of the ``lax.scan`` in ``repro.models.mamba.mamba_forward``,
which has no Pallas kernel.  A block of 128 threads takes as many channels
of one sequence; each thread keeps its channel's n state values and its row
of A in registers for the whole sequence, B and C reach shared memory 64
steps at a time, x and dt are loaded 8 steps ahead of their arithmetic
(:data:`DESIGN`).  The state is read from, and written back to, the tensor
given.  It takes n in :data:`STATE_DIMS`, contiguous float32 inputs on
16-byte boundaries; any other call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)  # n, a template argument of the kernel
DESIGN = ("a thread a channel, its n states and row of A in registers; 128 channels of one "
          "sequence a block; B and C staged in shared memory 64 steps at a time; x and dt "
          "loaded 8 steps ahead")


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
