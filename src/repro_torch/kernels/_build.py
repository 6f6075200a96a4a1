"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/*/csrc/*.cu`` source is compiled on first use into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes); sources may include the shared headers of
``kernels/csrc/``.  All sources are compiled together, one ``nvcc``
process each.  Libraries land in ``build/repro_torch/`` at the root of the
checkout under a name hashed from the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) -> path of its ``.cu`` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _headers() -> bytes:
    """The shared headers (``kernels/csrc/*.cuh``) that sources include."""
    return b"".join(p.read_bytes() for p in sorted(KERNELS_DIR.glob("csrc/*.cuh")))


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + _headers() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_all() -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """Compile every stale source in parallel and load every library.

    Returns ``(libraries, logs)``: name -> loaded library, and name -> the
    compiler's output (``-Xptxas -v`` register and shared-memory report;
    empty for a library that was already built).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name, src in sources().items():
        out = _target(src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs = {name: "" for name in sources()}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    libs = {name: ctypes.CDLL(str(_target(src))) for name, src in sources().items()}
    return libs, logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use)."""
    return build_all()[0][name]


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def counted(fn, design: str) -> None:
    """Count one launch of wrapper ``fn``, in total and by design."""
    fn.launches += 1
    fn.designs[design] = fn.designs.get(design, 0) + 1


@functools.lru_cache(maxsize=None)
def blocks_per_sm(name: str, symbol: str, index: int, variant: bool) -> int:
    """Blocks of a persistent kernel that one SM of CUDA device ``index``
    holds at once, from the occupancy entry point ``symbol`` of library
    ``name``, for the kernel's ``variant``."""
    fn = getattr(library(name), symbol)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        check(fn(int(variant), ctypes.byref(out)), symbol)
    return out.value


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: grad
    mode on and an input that requires grad.  The kernel's output comes from
    ``torch.empty`` and carries no ``grad_fn``, so its inputs would silently
    get no gradient from it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward on the card: call it under torch.no_grad(), "
                           f"or on tensors that do not require grad")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, dtype, name: str, device=None) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
