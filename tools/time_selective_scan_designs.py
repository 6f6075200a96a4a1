#!/usr/bin/env python3
"""The selective-scan kernel beside its earlier design, and the sweep of its plans, on one card.

    python3 tools/time_selective_scan_designs.py            # both designs, timed in turns
    python3 tools/time_selective_scan_designs.py --sweep    # every candidate prefill plan
    python3 tools/time_selective_scan_designs.py --decays   # the decay's candidate forms
    python3 tools/time_selective_scan_designs.py --parts    # the kernel without its exponentials

Run from the root of a checkout.  ``csrc/selective_scan.cu`` (twice the
decay one ``ex2.approx.ftz`` of 1 + dt A log2(e), the state kept scaled by
2^j at a chunk's j-th step, the state update and y by fmas, x, dt, B and C
staged by cp.async in a ring, a decode step a kernel of its own) replaced a
design that took each decay as an accurate ``expf`` and rounded every
product and sum apart (``_rn``), loaded x and dt 8 steps ahead into
registers and staged B and C 64 steps at a time behind two barriers, for a
decode step too.  That design is kept here as text (``EARLIER``) and built
into ``build/repro_torch/earlier/``.

:func:`time_designs` holds both against the plain version at jamba's
served layer (B 8, S 2048, d_in 16 384, n 16, from a zero state) and at a
decode step (S 1, from a mid-run state) and times them cold (L2 flushed), in
the order earlier, current, current, earlier, beside the bound, the
exponentials' floor, the plain version and the floor of the timing (the
current kernel at B = S = 1, d_in 128: one block, one step).  chip_smoke.py
phase 27 (a) calls it.

:func:`sweep` builds ``csrc/selective_scan.cu`` once more with every plan of
``SWEEP`` (``SCAN_SWEEP_PLANS`` defined, entry point
``repro_selective_scan_plan``), holds each against the plain version on
short inputs (bit for bit on repeat) and times it cold at the served layer,
with ptxas's registers and spills and the blocks an SM holds: the sweep that
chose ``kernel.MIN_BLOCKS``, ``kernel.CHUNK``, ``kernel.STAGES`` and
``kernel.UNROLL``.

:func:`variants` builds ``csrc/selective_scan.cu`` with each form of the
decay of ``DECAYS`` (the one it has; ex2.approx of dt a' itself; the
accurate ``expf`` of dt A) or each part of ``PARTS`` (the whole kernel; the
exponentials taken out, each MUFU.EX2 replaced by its argument, whose output
is wrong and whose time alone is read: the kernel without the SFU), holds
each against the plain version at the served layer with served dt from zero
and with slow dt from a mid-run state (phase 27 (a)'s cases and seeds) and
times it cold at the served layer, in rounds: the measurements behind the
decay's form and what bounds the kernel.

Alone, the script prints the card and its power limit first and a JSON
line last.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 10
#: what the earlier design did
EARLIER_DESIGN = ("a thread a channel, its n states and row of A in registers; the "
                  "decay an accurate expf, every product and sum rounded apart (_rn); B and C "
                  "staged 64 steps at a time behind two barriers, x and dt loaded 8 steps "
                  "ahead into registers; a decode step the same kernel")
#: the prefill plans the sweep builds at n = 16, (blocks an SM, steps a chunk,
#: chunks in the ring, steps unrolled): rings whose shared memory lets that
#: many blocks of 128 threads share an SM (227 KB, 1 KB a block reserved)
SWEEP = ((8, 8, 3, 4), (6, 16, 2, 4), (5, 16, 2, 4), (4, 16, 2, 4), (4, 16, 3, 4), (4, 24, 2, 4),
         (3, 16, 3, 4), (3, 32, 2, 2), (3, 32, 2, 4), (3, 32, 2, 8), (2, 32, 3, 4), (2, 48, 2, 4))
SWEEP_N = 16
#: the short inputs each plan is held to the plain version on: (B, S, d_in, dt, state)
SWEEP_CHECKS = ((2, 37, 200, "served", "mid-run"), (2, 19, 130, "slow", "mid-run"))
#: the decay in the source (twice the decay: the state is kept scaled by 2^j
#: at a chunk's j-th step), and the edits that give each other form of it
_DECAY = "ex2(__fmaf_rn(dv, a2[k], 1.0f))"
DECAYS = (
    ("ex2.approx(fma(dt, a', 1)), 2 dec (the source's)", ()),
    ("ex2.approx(dt a'), times 2", ((_DECAY, "__fmul_rn(2.0f, ex2(__fmul_rn(dv, a2[k])))"),)),
    ("expf(dt A), times 2", ((_DECAY, "__fmul_rn(2.0f, expf(__fmul_rn(dv, a2[k])))"),
                             ("a2[k] = __fmul_rn(a2[k], kLog2e);", "a2[k] = a2[k];"))),
)
PARTS = (
    ("whole kernel", ()),
    ("the exponentials taken out (wrong output)", ((_DECAY, "__fmaf_rn(dv, a2[k], 1.0f)"),)),
)
VARIANT_ROUNDS = 2
#: ``csrc/selective_scan.cu`` as the earlier design had it
EARLIER = r"""// csrc/selective_scan.cu as the earlier design had it (kept as text by
// tools/time_selective_scan_designs.py, its entry point renamed
// repro_selective_scan_earlier).
// The selective scan of a Mamba layer (Jamba's), a whole sequence in one launch.
// Per (sequence b, channel d), with the state h of n floats:
//
//   h_t[k] = exp(dt_t[d] * A[d][k]) * h_{t-1}[k] + (dt_t[d] * x_t[d]) * B_t[k]
//   y_t[d] = sum_k h_t[k] * C_t[k] + D[d] * x_t[d]
//
// Replaces no Pallas kernel: the reference scans the recurrence with lax.scan
// (src/repro/models/mamba.py:77, inside mamba_forward) over the decay and drive
// tensors it forms first, (B, S, d_in, n) float32 each.  Prefill runs it over a
// prompt from a zero state, decode over one token from the cache's state; both
// read the state from the (B, d_in, n) tensor they are given and write the
// final state back into it.  x, dt and y are float32 (B, S, d_in) (dt already
// through softplus), A float32 (d_in, n) (-exp(A_log)), B and C float32
// (B, S, n), D float32 (d_in,); every tensor starts on a 16-byte boundary
// (the wrapper checks the addresses).  n is 8 or 16.
//
// Bound on an H100: bytes.  x and dt are read and y written once, 12 bytes a
// (b, t, d): at jamba's served layer (B 8, S 2048, d_in 16 384, n 16) 3.22 GB,
// 0.961 ms at 3.35 TB/s; its float32 work, about 6 flops a (b, t, d, n), is
// 2.58e10, 0.385 ms at 67 TFLOP/s.  The 4.29e9 exponentials are a third
// floor the bound does not count: expf issues one MUFU.EX2 each, 16 an SM a
// clock, about 1.0 ms at 1.98 GHz, beside the FP32 instructions of its range
// reduction.
//
// Design (a first, simple one).  A block of 128 threads takes 128 channels of
// one sequence, grid (ceil(d_in / 128), B); a thread owns one channel, its n
// state values and its row of A in registers for the whole sequence.  B_t and
// C_t are the same for every channel of a sequence: the block stages them in
// shared memory kChunk steps at a time (16-byte loads), and each step reads
// them as broadcast float4s.  Loads of x and dt are coalesced across the
// block (neighbouring threads, neighbouring channels), kBatch steps of them
// issued before the batch's arithmetic, so the loads of a batch overlap; y is
// stored the same way.  The kernel never forms the reference's decay and
// drive tensors (17.2 GB each at the served layer).  The arithmetic is the
// reference's, in its order, rounded at every step (the _rn intrinsics keep
// nvcc from contracting into fmas): dec = expf(dt * A), drv = (dt * x) * B,
// h = dec * h + drv, y summed over k in index order, then y + D * x.  Two runs
// agree bit for bit: no atomics, no order that depends on timing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 64;     // steps of B and C staged in shared memory at once
constexpr int kBatch = 8;      // steps of x and dt loaded before their arithmetic

// A row of N floats in shared memory into registers, as N / 4 float4s.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ D,
                          float* __restrict__ state, float* __restrict__ y, int seq, int d_in) {
  static_assert(N % 4 == 0, "a row of B, C, A or the state is whole float4s");
  __shared__ __align__(16) float sb[kChunk * N];
  __shared__ __align__(16) float sc[kChunk * N];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = d < d_in;
  float h[N], a[N], dd = 0.0f;
  float* st = state + ((long long)b * d_in + d) * N;
  if (active) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 s4 = reinterpret_cast<const float4*>(st)[q];
      const float4 a4 = reinterpret_cast<const float4*>(A + (long long)d * N)[q];
      h[4 * q] = s4.x, h[4 * q + 1] = s4.y, h[4 * q + 2] = s4.z, h[4 * q + 3] = s4.w;
      a[4 * q] = a4.x, a[4 * q + 1] = a4.y, a[4 * q + 2] = a4.z, a[4 * q + 3] = a4.w;
    }
    dd = D[d];
  }
  const long long first = (long long)b * seq;  // the sequence's first (b, t) row
  const float4* bq = reinterpret_cast<const float4*>(Bm + first * N);
  const float4* cq = reinterpret_cast<const float4*>(Cm + first * N);
  const float* xs = x + first * d_in + d;
  const float* ds = dt + first * d_in + d;
  float* ys = y + first * d_in + d;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int steps = min(kChunk, seq - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int q = threadIdx.x; q < steps * (N / 4); q += kThreads) {
      reinterpret_cast<float4*>(sb)[q] = bq[t0 * (N / 4) + q];
      reinterpret_cast<float4*>(sc)[q] = cq[t0 * (N / 4) + q];
    }
    __syncthreads();
    if (!active) continue;
    for (int s0 = 0; s0 < steps; s0 += kBatch) {
      float xv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < steps) {
          const long long at = (long long)(t0 + s0 + u) * d_in;
          xv[u] = xs[at];
          dv[u] = ds[at];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        if (s >= steps) break;
        float bk[N], ck[N];
        load_row<N>(sb + s * N, bk);
        load_row<N>(sc + s * N, ck);
        const float dx = __fmul_rn(dv[u], xv[u]);
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float dec = expf(__fmul_rn(dv[u], a[k]));
          h[k] = __fadd_rn(__fmul_rn(dec, h[k]), __fmul_rn(dx, bk[k]));
          const float term = __fmul_rn(h[k], ck[k]);
          acc = k == 0 ? term : __fadd_rn(acc, term);
        }
        ys[(long long)(t0 + s) * d_in] = __fadd_rn(acc, __fmul_rn(dd, xv[u]));
      }
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(st)[q] =
          make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* D, float* state, float* y, int batch, int seq, int d_in,
           cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, A, Bm, Cm, D, state, y, seq,
                                                          d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y: (batch, seq, d_in) float32; A: (d_in, n); Bm, Cm: (batch, seq, n);
// D: (d_in,); state: (batch, d_in, n), read and written in place.  n is 8 or 16.
extern "C" int repro_selective_scan_earlier(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* D, void* state, void* y,
                                    int batch, int seq, int d_in, int n, void* stream) {
  if (batch < 1 || seq < 1 || d_in < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(D);
  auto* sf = static_cast<float*>(state);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch<8>(xf, df, af, bf, cf, Df, sf, yf, batch, seq, d_in, s);
    case 16: return launch<16>(xf, df, af, bf, cf, Df, sf, yf, batch, seq, d_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def _nvcc(src: Path, lib: Path) -> str:
    """Build ``src`` into ``lib`` with the package's flags; the compiler's output."""
    from repro_torch.kernels import _build

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _bind(fn, extra_ints=0):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * (4 + extra_ints) + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def earlier_entry():
    """The earlier design, built with the package's nvcc flags: its C entry point."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "selective_scan_earlier.cu"
    src.write_text(EARLIER)
    lib = out_dir / "libselective_scan_earlier.so"
    _nvcc(src, lib)
    return _bind(ctypes.CDLL(str(lib)).repro_selective_scan_earlier)


@functools.lru_cache(maxsize=None)
def sweep_entry():
    """``csrc/selective_scan.cu`` built with every plan of SWEEP: its
    repro_selective_scan_plan, the blocks an SM of each plan, and ptxas's
    registers and spill bytes by kernel (``ptxas_registers``)."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    plans = " ".join(f"X({SWEEP_N}, {', '.join(map(str, plan))})" for plan in SWEEP)
    src = out_dir / "selective_scan_sweep.cu"
    src.write_text(f"#define SCAN_SWEEP_PLANS {plans}\n"
                   f"#include \"{_build.sources()['selective_scan'].resolve()}\"\n")
    lib = out_dir / "libselective_scan_sweep.so"
    log = _nvcc(src, lib)
    dll = ctypes.CDLL(str(lib))
    blocks = dll.repro_selective_scan_plan_blocks
    blocks.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    blocks.restype = ctypes.c_int
    return _bind(dll.repro_selective_scan_plan, extra_ints=4), blocks, ptxas_registers(log)


def ptxas_registers(log: str) -> dict:
    """Kernel -> (registers, spill store bytes) of each instance in a
    ``-Xptxas -v`` log: ("prefill", n, blocks, chunk, stages, unroll) or ("step", n)."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"selective_scan_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                          line)
            s = re.search(r"selective_scan_step_kernelILi(\d+)E", line)
            key = (("prefill", *(int(x) for x in m.groups())) if m else
                   ("step", int(s.group(1))) if s else None)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if key and spill:
            out[key] = [None, int(spill.group(1))]
        used = re.search(r"Used (\d+) registers", line)
        if key and used:
            out.setdefault(key, [None, 0])[0] = int(used.group(1))
            key = None
    return {k: tuple(v) for k, v in out.items()}


def _call(fn, x, dt, A, Bm, Cm, D, state, y, *plan):
    """Run a C entry point on the tensors, y written into ``y``."""
    from repro_torch.kernels import _build

    B, S, d_in = x.shape
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    D.data_ptr(), state.data_ptr(), y.data_ptr(), B, S, d_in, A.shape[1], *plan,
                    _build.stream_of(x)), "selective_scan design")
    return y


def _held(label, runs, want):
    """Each design's (y, state) within SCAN_TOL of the plain version's; the
    relative errors by design."""
    errs = {name: smoke.scan_errors(*got, *want) for name, got in runs.items()}
    smoke.need(all(max(e.values()) <= smoke.SCAN_TOL for e in errs.values()),
               f"selective_scan designs {label} against plain: {errs} (limit {smoke.SCAN_TOL})")
    return errs


def _time_shape(torch, dev, flush, label, S, state):
    """Both designs at the served (B, d_in, n) and S steps from a zero or a
    mid-run state: held against the plain version, timed cold in turns."""
    from repro_torch.kernels.selective_scan.kernel import launch
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    old = earlier_entry()
    B, _, d_in, n = smoke.SCAN_SERVED
    x, dt, A, Bm, Cm, D, h0 = smoke.scan_inputs(torch, dev, B, S, d_in, n, seed=40, state=state)
    work, y_old = h0.clone(), torch.empty_like(x)

    def reset():
        work.copy_(h0)

    def current():
        return launch(x, dt, A, Bm, Cm, D, work)

    def earlier():
        return _call(old, x, dt, A, Bm, Cm, D, work, y_old)

    designs = {"current": current, "earlier": earlier}
    runs = {}
    for name, fn in designs.items():
        reset()
        runs[name] = (fn().clone(), work.clone())
    reset()
    again = current()
    smoke.need(torch.equal(again, runs["current"][0]) and torch.equal(work, runs["current"][1]),
               f"selective_scan {label}: the current design does not repeat")
    errs = _held(label, runs, selective_scan_ref(x, dt, A, Bm, Cm, D, h0))
    del runs, again
    times = {"earlier": [], "current": []}
    for name in ("earlier", "current", "current", "earlier"):
        times[name].append(smoke.timed_ms(torch, designs[name], REPS, flush, reset=reset))
    warm = smoke.timed_ms(torch, current, REPS, reset=reset)
    plain_ms = smoke.timed_ms(torch, lambda: selective_scan_ref(x, dt, A, Bm, Cm, D, h0),
                              2 if S > 1 else 10, flush)
    b, by, exp_floor = smoke.scan_bound(torch, dev, B, S, d_in, n)
    cur, ear = sum(times["current"]) / 2, sum(times["earlier"]) / 2
    print(f"selective_scan {label} B={B} S={S} d_in={d_in} n={n}, cold in turns (earlier, "
          f"current, current, earlier): current {times['current'][0] * 1e3:.2f} / "
          f"{times['current'][1] * 1e3:.2f} us, earlier ({EARLIER_DESIGN}) "
          f"{times['earlier'][0] * 1e3:.2f} / {times['earlier'][1] * 1e3:.2f} us; current / "
          f"earlier {cur / ear:.3f}; warm in L2 {warm * 1e3:.2f} us; bound {b * 1e3:.2f} us by "
          f"{by} (current / bound {cur / b:.2f}), the exponentials' floor {exp_floor * 1e3:.2f} "
          f"us; plain {plain_ms * 1e3:.1f} us; |design - plain| / largest {errs}")
    return {"shape": f"B={B} S={S} d_in={d_in} n={n}", "ms": cur, "earlier_ms": ear,
            "turns": times, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "exp_floor_ms": exp_floor, "relative_err": errs}


def time_designs(torch, dev, flush):
    """Both designs at the served layer (from zero) and at a decode step
    (from a mid-run state): each within SCAN_TOL of the plain version, the
    current one bit for bit on repeat; cold in turns, beside the bound, the
    exponentials' floor, the plain version and the floor.  Returns the times
    and errors by shape, and ptxas's registers and spills of the current
    kernels where this process built the library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan.kernel import launch

    out = {"served": _time_shape(torch, dev, flush, "served layer", smoke.SCAN_SERVED[1], "zero")}
    torch.cuda.empty_cache()
    out["decode"] = _time_shape(torch, dev, flush, "decode step", 1, "mid-run")
    x, dt, A, Bm, Cm, D, h0 = smoke.scan_inputs(torch, dev, 1, 1, 128, 16, seed=41)
    floor = smoke.timed_ms(torch, lambda: launch(x, dt, A, Bm, Cm, D, h0), 20, flush)
    regs = {" ".join(map(str, k)): v for k, v in
            ptxas_registers(_build.build_all()[1]["selective_scan"]).items()}
    print(f"selective_scan floor of the timing (the current kernel at B = S = 1, d_in 128: one "
          f"block, one step): {floor * 1e3:.2f} us cold; ptxas (registers, spill bytes) "
          f"{regs or 'not in this process (the library was built before it)'}")
    out.update(floor_ms=floor, earlier_design=EARLIER_DESIGN, ptxas=regs)
    return out


def sweep(torch, dev, flush):
    """Every plan of SWEEP: held against the plain version at SWEEP_CHECKS
    (within SCAN_TOL, bit for bit on repeat), timed cold at the served
    layer; printed fastest first."""
    from repro_torch.kernels.selective_scan.kernel import CHUNK, MIN_BLOCKS, STAGES, UNROLL
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    fn, blocks_fn, regs = sweep_entry()
    checks = []
    for i, (B, S, d_in, dt, state) in enumerate(SWEEP_CHECKS):
        small = smoke.scan_inputs(torch, dev, B, S, d_in, SWEEP_N, seed=50 + i, dt=dt,
                                  state=state)
        checks.append((small, selective_scan_ref(*small)))
    B, S, d_in, n = smoke.SCAN_SERVED
    big = smoke.scan_inputs(torch, dev, B, S, d_in, n, seed=40)
    work, y = big[-1].clone(), torch.empty_like(big[0])
    rows = []
    for plan in SWEEP:
        errs = {}
        for (small, want), label in zip(checks, SWEEP_CHECKS):
            got = []
            for _ in range(2):
                s = small[-1].clone()
                got.append((_call(fn, *small[:-1], s, torch.empty_like(small[0]), *plan), s))
            smoke.need(torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1]),
                       f"selective_scan plan {plan} does not repeat")
            errs[str(label)] = _held(f"plan {plan} at {label}", {"plan": got[0]}, want)["plan"]
        ms = smoke.timed_ms(torch, functools.partial(_call, fn, *big[:-1], work, y, *plan), REPS,
                            flush, reset=functools.partial(work.copy_, big[-1]))
        held = ctypes.c_int(0)
        smoke.need(blocks_fn(SWEEP_N, *plan, ctypes.byref(held)) == 0, "occupancy query failed")
        reg, spill = regs.get(("prefill", SWEEP_N, *plan), (None, None))
        rows.append({"blocks": plan[0], "chunk": plan[1], "stages": plan[2], "unroll": plan[3],
                     "ms": ms, "blocks_an_sm": held.value, "registers": reg,
                     "spill_bytes": spill, "relative_err": errs,
                     "chosen": plan == (MIN_BLOCKS, CHUNK, STAGES, UNROLL)})
    print(f"selective_scan prefill plans at B={B} S={S} d_in={d_in} n={n}, cold, fastest first "
          f"(blocks an SM asked / held, steps a chunk, chunks in the ring, steps unrolled):")
    for row in sorted(rows, key=lambda r: r["ms"]):
        print(f"  {row['blocks']} / {row['blocks_an_sm']} blocks, chunk {row['chunk']:2d}, "
              f"{row['stages']} stages, unroll {row['unroll']} ({row['registers']} registers, "
              f"{row['spill_bytes']} B "
              f"spilled): {row['ms'] * 1e3:9.2f} us{'  <- the plan' if row['chosen'] else ''}")
    steps = {k: v for k, v in regs.items() if k[0] == "step"}
    print(f"selective_scan decode-step kernel (registers, spill bytes) by n: {steps}")
    return rows


def variants(torch, dev, flush, table, name):
    """The kernel with each edit of ``table`` (DECAYS or PARTS), built in
    parallel: held against the plain version at phase 27 (a)'s served and
    slow-dt cases (each error printed; a form over SCAN_TOL is reported, not
    failed), timed cold at the served layer in VARIANT_ROUNDS rounds."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    text = _build.sources()["selective_scan"].read_text()
    out_dir = _build.BUILD_DIR / name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, edits) in enumerate(table):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/selective_scan.cu")
            src = src.replace(old, new)
        path, lib = out_dir / f"selective_scan_{name}{i}.cu", out_dir / f"lib{name}{i}.so"
        path.write_text(src)
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for label, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        fns[label] = _bind(ctypes.CDLL(str(lib)).repro_selective_scan)
    B, S, d_in, n = smoke.SCAN_SERVED
    errs = {label: {} for label in fns}
    for case, seed, dt, state in (("served", 27, "served", "zero"),
                                  ("slow dt", 29, "slow", "mid-run")):
        inputs = smoke.scan_inputs(torch, dev, B, S, d_in, n, seed=seed, dt=dt, state=state)
        want = selective_scan_ref(*inputs)
        for label, fn in fns.items():
            h = inputs[-1].clone()
            y = _call(fn, *inputs[:-1], h, torch.empty_like(inputs[0]))
            errs[label][case] = smoke.scan_errors(y, h, *want)
            del y, h
        del inputs, want
        torch.cuda.empty_cache()
    big = smoke.scan_inputs(torch, dev, B, S, d_in, n, seed=40)
    work, y = big[-1].clone(), torch.empty_like(big[0])
    times = {label: [] for label in fns}
    for _ in range(VARIANT_ROUNDS):
        for label, fn in fns.items():
            times[label].append(smoke.timed_ms(
                torch, functools.partial(_call, fn, *big[:-1], work, y), REPS, flush,
                reset=functools.partial(work.copy_, big[-1])))
    print(f"selective_scan {name} at B={B} S={S} d_in={d_in} n={n}, cold in {VARIANT_ROUNDS} "
          f"rounds; |variant - plain| / largest (limit {smoke.SCAN_TOL:.0e}):")
    for label, ts in times.items():
        print(f"  {label}: {' / '.join(f'{t * 1e3:.2f}' for t in ts)} us; "
              + "; ".join(f"{case} y {e['y']:.3e}, state {e['state']:.3e}"
                          for case, e in errs[label].items()))
    return {label: {"ms": sum(ts) / VARIANT_ROUNDS, "turns": ts, "relative_err": errs[label]}
            for label, ts in times.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: time_selective_scan_designs.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(smoke.nvidia_smi_line())
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2
    if "--sweep" in sys.argv[1:]:
        out = {"sweep": sweep(torch, dev, scratch.zero_)}
    elif "--decays" in sys.argv[1:]:
        out = {"decays": variants(torch, dev, scratch.zero_, DECAYS, "decays")}
    elif "--parts" in sys.argv[1:]:
        out = {"parts": variants(torch, dev, scratch.zero_, PARTS, "parts")}
    else:
        out = time_designs(torch, dev, scratch.zero_)
    print(smoke.nvidia_smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
