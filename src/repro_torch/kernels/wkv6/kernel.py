"""Binding of ``csrc/wkv6.cu``: the WKV-6 recurrence, a block a (sequence, head).

Counterpart of ``repro.models.rwkv._wkv_scan``, which has no Pallas kernel:
the reference scans the recurrence with ``lax.scan``.  The kernel factors
the u term out (y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i), cuts each
column of a head's n x n state into P row blocks and gives each thread one
block of C adjacent columns (:data:`PLANS`), in registers for the whole
sequence; a chunk's partial sums of y are added over the row blocks in
order at the chunk's end.  The state is read from, and written back to, the
tensor given; r, k, w and v reach shared memory :data:`CHUNK` steps at a
time by 16-byte asynchronous copies, in a ring of :data:`STAGES` chunks.
It takes n in :data:`HEAD_DIMS`, contiguous float32 inputs on 16-byte
boundaries; any other call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64)  # n, a template argument of the kernel
#: n -> (P row blocks a column, C columns a thread): Plan<n> in the source
PLANS = {16: (4, 2), 32: (8, 4), 64: (8, 4)}
CHUNK = 16  # steps staged in shared memory at once (kChunk in the source)
STAGES = 3  # chunks in the ring (kStages in the source)
DESIGN = ("u term factored; a block a (sequence, head), each column's rows cut over P "
          "threads of C columns (n = 64: 8 x 4, 128 threads, 32 state registers a thread); "
          "partials summed over the row blocks in order a 16-step chunk; r, k, w, v staged "
          "by cp.async in a 3-chunk ring")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("wkv6").repro_wkv6
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, state: torch.Tensor) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one (B, S, H, n) shape; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    B, S, H, n = r.shape
    if S < 1:
        raise ValueError("the sequence is empty")
    if u.shape != (H, n):
        raise ValueError(f"u must be ({H}, {n}), got {tuple(u.shape)}")
    if state.shape != (B, H, n, n):
        raise ValueError(f"state must be ({B}, {H}, {n}, {n}), got {tuple(state.shape)}")


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors; returns y (B, S, H, n), the final
    state written into ``state``."""
    B, S, H, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"head dim {n} is outside the kernel's {HEAD_DIMS}")
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w"), (u, "u"), (state, "state")):
        _build.require(t, torch.float32, name, r.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(r)
    _build.check(
        _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 state.data_ptr(), y.data_ptr(), B, S, H, n, _build.stream_of(r)),
        "wkv6",
    )
    return y
