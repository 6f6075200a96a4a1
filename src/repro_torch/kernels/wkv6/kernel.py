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

:func:`launch_bwd` binds ``csrc/wkv6_bwd.cu``, the gradient (dr, dk, dv,
dw, du) from the forward's inputs, its start state and dy, in
:data:`BWD_LAUNCHES` launches: a block of one warp a (sequence, head, slice
of :data:`BWD_ROWS` rows of the state) runs the recurrence forward writing
the state every :data:`CHUNK` steps into a float32 scratch, then walks the
chunks in reverse, recomputing a chunk's states in shared memory, with the
gradient of the state in registers (:data:`BWD_DESIGN`); the second launch
adds dv's partials over the slices and du's over the sequences, in order.
The same head dims and inputs; any other call raises.
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
#: the backward's rows of the state a block, launches a call and design
BWD_ROWS = 16
BWD_LAUNCHES = 2
BWD_DESIGN = ("a warp a (sequence, head, 16 rows of the state), a lane 2 rows x n/4 columns of S "
              "and its gradient in registers; S checkpointed every 16 steps by a forward pass, a "
              "chunk's states recomputed into shared memory and walked in reverse; dr, dk, dw "
              "complete a slice, dv's slice partials and du's sequence partials summed in order "
              "by a second launch")
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


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    fn = _build.library("wkv6_bwd").repro_wkv6_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 15 + [i, i, i, i, p]
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
    _require_all((("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state)),
                 r.device)
    y = torch.empty_like(r)
    _build.check(
        _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 state.data_ptr(), y.data_ptr(), B, S, H, n, _build.stream_of(r)),
        "wkv6",
    )
    return y


def _require_all(named, device) -> None:
    for name, t in named:
        _build.require(t, torch.float32, name, device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state0: torch.Tensor, dy: torch.Tensor):
    """Run the backward kernel on CUDA tensors: dr, dk, dv, dw (B, S, H, n)
    and du (H, n), float32, the gradient of y given ``dy`` for a forward that
    started from ``state0`` (none flows into ``state0`` or from the final
    state)."""
    B, S, H, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"head dim {n} is outside the kernel's {HEAD_DIMS}")
    if dy.shape != r.shape:
        raise ValueError(f"dy must be r's {tuple(r.shape)}, got {tuple(dy.shape)}")
    _require_all((("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state0", state0),
                  ("dy", dy)), r.device)
    chunks = -(-S // CHUNK)
    dev = r.device
    ckpt = torch.empty(B * H * chunks * n * n, dtype=torch.float32, device=dev)
    dv_part = torch.empty((n // BWD_ROWS, B, S, H, n), dtype=torch.float32, device=dev)
    du_part = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    _build.check(
        _entry_bwd()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                     state0.data_ptr(), dy.data_ptr(), ckpt.data_ptr(), dr.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                     dv_part.data_ptr(), du_part.data_ptr(), B, S, H, n, _build.stream_of(r)),
        "wkv6_bwd",
    )
    return dr, dk, dv, dw, du
