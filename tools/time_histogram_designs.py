#!/usr/bin/env python3
"""The histogram kernel against the design it replaced, on one NVIDIA card.

    python3 tools/time_histogram_designs.py

Run from the root of a checkout on one NVIDIA card.  The earlier design, a
zero fill of the counts and then one global atomic add an id (two launches;
``scatter_counts/csrc/histogram.cu`` at commit 27d0a85, kept here as text and
not in the package), is compiled with nvcc into ``build/`` and timed beside
the package's ``histogram`` at the shapes the main paths give it:

* the chunk's gradient, chip_smoke.py's first W = 1000 trace ids over
  N = 1e6 items (``histogram`` takes its bin-tiles plan);
* a re-anchor's two histograms, the bucket ids of chip_smoke.py's mid-run
  ``ogb_tree`` state's y (ycnt) and y - p (dcnt), 1e6 ids over V = 65 536
  buckets (its id-slices plan).

Cold (L2 flushed before each call) and warm in L2, in the order earlier,
current, current, earlier; both designs are held to the plain version
exactly.  It prints the card and its power limit first, a line a shape,
and a JSON line of every time last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 50
EARLIER_SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fill_zero_kernel(float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = 0.0f;
  }
}

__global__ void scatter_kernel(const int* __restrict__ ids, long long b,
                               float* __restrict__ counts, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const long long id = ids[i];
  if (id >= 0 && id < n) atomicAdd(counts + id, 1.0f);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int repro_histogram_earlier(const void* ids, long long b, void* counts, long long n,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(counts);
  if (n > 0) {
    const long long blocks = cdiv(n, kThreads) < 4096 ? cdiv(n, kThreads) : 4096;
    fill_zero_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(out, n);
  }
  if (b > 0) {
    scatter_kernel<<<(unsigned)cdiv(b, kThreads), kThreads, 0, s>>>(
        static_cast<const int*>(ids), b, out, n);
  }
  return (int)cudaGetLastError();
}
"""


def earlier_histogram():
    """Build the earlier design with the package's nvcc flags; returns
    ``histogram(ids, n)`` through it (two launches, nothing counted)."""
    import torch

    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "histogram_earlier.cu", out_dir / "libhistogram_earlier.so"
    src.write_text(EARLIER_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).repro_histogram_earlier
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int

    def histogram(ids, n):
        counts = torch.empty(n, dtype=torch.float32, device=ids.device)
        _build.check(fn(ids.data_ptr(), ids.numel(), counts.data_ptr(), n,
                        _build.stream_of(ids)), "earlier histogram")
        return counts

    return histogram


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.cachesim.traces import zipf
    from repro_torch.cachesim.tree_engines import _ogb_bucket
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import _build
    from repro_torch.kernels.scatter_counts.ops import design, histogram
    from repro_torch.kernels.scatter_counts.ref import histogram_ref

    print(f"card: {smoke.nvidia_smi_line()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build_all()
    earlier_design = earlier_histogram()
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    trace = zipf(smoke.N, smoke.T, alpha=smoke.ALPHA, seed=0)
    eta = theoretical_eta(smoke.C, smoke.N, smoke.T, 1)
    carry = smoke.tree_state(trace, eta)
    y = torch.clamp(carry.y - carry.rho, 0.0, 1.0)
    shapes = {
        "chunk": (torch.from_numpy(trace[: smoke.W].astype("int32")).to(dev), smoke.N),
        "reanchor ycnt": (_ogb_bucket(y, carry.w, smoke.V).to(torch.int32), smoke.V),
        "reanchor dcnt": (_ogb_bucket(y - carry.p, carry.w, smoke.V).to(torch.int32), smoke.V),
    }
    out = []
    for label, (ids, n) in shapes.items():
        b = ids.numel()

        def earlier(ids=ids, n=n):
            return earlier_design(ids, n)

        def current(ids=ids, n=n):
            return histogram(ids, n)

        want = histogram_ref(ids, n)
        for name, fn in (("earlier", earlier), ("current", current)):
            smoke.need(torch.equal(fn(), want), f"{label}: the {name} design differs")
        times = {"earlier": [], "current": []}
        for name in ("earlier", "current", "current", "earlier"):
            fn = earlier if name == "earlier" else current
            times[name].append([smoke.timed_ms(torch, fn, REPS, fl) * 1e3 for fl in (flush, None)])
        mean = {k: [sum(t[i] for t in v) / len(v) for i in (0, 1)] for k, v in times.items()}
        bound, by = smoke.bound_ms(4 * b + 4 * n, b)
        row = {"shape": label, "ids": b, "bins": n, "non_empty": int(want.gt(0).sum()),
               "largest": int(want.max()), "design": design(b, n), "us_cold_warm": mean,
               "runs": times, "bound_us": bound * 1e3, "bound_by": by}
        out.append(row)
        print(f"{label} ({b} ids over {n} bins, {row['non_empty']} non-empty, the largest "
              f"{row['largest']}): earlier design {mean['earlier'][0]:.2f} / "
              f"{mean['earlier'][1]:.2f} us cold / warm, current ({row['design']}) "
              f"{mean['current'][0]:.2f} / {mean['current'][1]:.2f} us; bound "
              f"{bound * 1e3:.3f} us by {by}; both exact")
    print(json.dumps({"histogram_designs": out}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
