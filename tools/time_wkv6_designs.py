#!/usr/bin/env python3
"""The WKV-6 kernel beside its PR 30 design, and the sweep of its plans, on one NVIDIA card.

    python3 tools/time_wkv6_designs.py            # both designs, timed in turns
    python3 tools/time_wkv6_designs.py --sweep    # every candidate plan of each n
    python3 tools/time_wkv6_designs.py --parts    # where the kernel's time goes

Run from the root of a checkout.  ``csrc/wkv6.cu`` (the u term factored out,
each column's rows cut over P threads of C columns, the partial sums of y
added over the row blocks in order at a chunk's end) replaced a design that
gave each of n threads a whole column of the state and applied u at every
(i, j): 4 FP32 instructions an (i, j), one warp a scheduler.  That design is
kept here as text (``EARLIER``) and built into ``build/repro_torch/earlier/``.

:func:`time_designs` holds both against the plain version at rwkv6-1.6b's
served layer (B 8, S 2048, H 32, n 64, from a zero state) and at a decode
step (S 1, from a mid-run state) and times them cold (L2 flushed), in the
order earlier, current, current, earlier, beside the bound, the plain
version and the floor of the timing (the current kernel at B = H = S = 1,
n = 16: one block, one step).  chip_smoke.py phase 26 (a) calls it.

:func:`sweep` builds ``csrc/wkv6.cu`` once more with every plan of
``SWEEP`` (``WKV6_SWEEP_PLANS`` defined, entry point ``repro_wkv6_plan``), holds
each against the plain version on a short input and times it cold at
B 8, S 2048 and H = 2048 / n (rwkv6-1.6b's d_model), with ptxas's registers
and spills: the sweep that chose ``Plan<n>`` (``kernel.PLANS``).

:func:`parts` builds ``csrc/wkv6.cu`` with parts of its work taken out (y's
pass at a chunk's end; the step's loads of r, k, w, v; its stores of
partial sums; all three, which leaves the FP32 instructions of the steps
and the staging) and times each at the served layer cold, in rounds: what
each part costs.  Their outputs are wrong; only their times are read.

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

REPS = 20
SWEEP_REPS = 10
#: what the earlier design did
EARLIER_DESIGN = ("PR 30: a block a (sequence, head) of n threads, thread j column j of the "
                  "state in n registers, u applied at every (i, j) (4 FP32 instructions), "
                  "16 steps staged by cp.async in two stages")
#: n -> the (P row blocks, C columns a thread) plans the sweep builds: every
#: P, C with whole float4 row loads and whole warps, two blocks an SM,
#: short of 32 rows a thread
SWEEP = {
    16: ((2, 1), (4, 1), (4, 2)),
    32: ((4, 1), (8, 1), (2, 2), (4, 2), (8, 2), (4, 4), (8, 4)),
    64: ((4, 1), (8, 1), (4, 2), (8, 2), (16, 2), (4, 4), (8, 4), (16, 4)),
}
SWEEP_MODEL_DIM = 2048
PART_ROUNDS = 2
#: source edits that take a part of the kernel's work out
_NO_FINISH = (("    finish_y<N, P, Sh::kThreads>(cur, part, us, y, head + (long long)c * kChunk * "
               "row, row, steps);\n", ""),)
_LOOP = "#pragma unroll 4\n  for (int t = 0; t < steps; ++t) {"
_NO_LOADS = (  # a chunk's first step's r, k, w, v kept in registers for all its steps
    (_LOOP, "float4 pre[3][R / 4];\n  float vpre[C];\n  load(cv + C * q, vpre);\n"
            "#pragma unroll\n  for (int i = 0; i < R; i += 4) {\n"
            "    pre[0][i / 4] = *reinterpret_cast<const float4*>(cr + R * p + i);\n"
            "    pre[1][i / 4] = *reinterpret_cast<const float4*>(ck + R * p + i);\n"
            "    pre[2][i / 4] = *reinterpret_cast<const float4*>(cw + R * p + i);\n  }\n" + _LOOP),
    ("load(cv + t * N + C * q, vj);", "for (int j = 0; j < C; ++j) vj[j] = vpre[j];"),
    ("*reinterpret_cast<const float4*>(cr + t * N + R * p + i)", "pre[0][i / 4]"),
    ("*reinterpret_cast<const float4*>(ck + t * N + R * p + i)", "pre[1][i / 4]"),
    ("*reinterpret_cast<const float4*>(cw + t * N + R * p + i)", "pre[2][i / 4]"),
)
_NO_STORES = (  # the partial sums added into registers, stored once a chunk
    (_LOOP, "float sink[C] = {};\n" + _LOOP),
    ("    store(part + (t * P + p) * N + C * q, acc);\n  }\n}",
     "    for (int j = 0; j < C; ++j) sink[j] = __fadd_rn(sink[j], acc[j]);\n  }\n"
     "  store(part + p * N + C * q, sink);\n}"),
)
PARTS = (
    ("whole kernel", ()),
    ("without y's pass at a chunk's end", _NO_FINISH),
    ("r, k, w, v loaded once a chunk", _NO_LOADS),
    ("the partial sums stored once a chunk", _NO_STORES),
    ("the steps' FP32 and the staging only", _NO_FINISH + _NO_LOADS + _NO_STORES),
)  # H = 2048 / n heads at each n (rwkv6-1.6b's d_model)
#: ``csrc/wkv6.cu`` as PR 30 had it
EARLIER = r"""// csrc/wkv6.cu as PR 30 had it (kept as text by tools/time_wkv6_designs.py,
// its entry point renamed repro_wkv6_earlier).
// The WKV-6 recurrence of RWKV-6 ("Finch"), a whole sequence in one launch.
// Per (sequence b, head h), with the state S of n x n floats:
//
//   a_t[i][j] = k_t[i] * v_t[j]
//   y_t[j]    = sum_i r_t[i] * (S[i][j] + u[i] * a_t[i][j])
//   S[i][j]  <- w_t[i] * S[i][j] + a_t[i][j]
//
// Replaces no Pallas kernel: the reference scans the recurrence with lax.scan
// (src/repro/models/rwkv.py:74, _wkv_scan), and a plain PyTorch loop over it
// would launch about six small operations a token and a layer.  Prefill runs
// it over a prompt from a zero state, decode over one token from the cache's
// state; both read the state from the (B, H, n, n) tensor they are given and
// write the final state back into it.  r, k, v, w are float32 (B, S, H, n),
// u float32 (H, n), y float32 (B, S, H, n); every row of n floats starts on a
// 16-byte boundary (the wrapper checks the tensors' addresses).
//
// Bound on an H100: bytes.  The function needs 5 float32 flops a
// (b, t, h, i, j), since y[j] = sum_i r[i] S[i][j] + v[j] sum_i r[i] u[i] k[i]
// (2 for y, 3 for S <- w S + k v) and 5n a (b, t, h) for the u term; at
// rwkv6-1.6b's served layer (B 8, S 2048, H 32, n 64) 1.09e10 flops, 163 us
// at 67 TFLOP/s, where its bytes (r, k, v, w read once, y written once:
// 5 * 4 * 33.5e6 B, and the state) take 203 us at 3.35 TB/s.  This design
// spends four FP32 instructions an (i, j) (the product k v and three fmas)
// and a quarter of four 16-byte shared loads, so the SMs' instruction rate,
// not the memory, is what it works against.
//
// Design (the formulation of RWKV's own CUDA forward): a block a (b, h) of n
// threads; thread j keeps column j of S in n registers for the whole
// sequence, so the state never leaves the SM between steps.  r, k, w and v
// of kChunk steps are staged in shared memory at once by cp.async, 16 bytes a
// copy, in two stages: the next chunk's copies are in flight while the
// block runs the current chunk's steps, which need no barrier between them
// (two a chunk).  A step reads r_t, k_t, w_t and u as float4 broadcasts.
// Each thread sums its y_j over i = 0 .. n-1 in order, in one accumulator,
// with explicit fmas: two runs agree bit for bit, and no atomics are used.
// n is a template argument (16, 32, 64), so the loop over i unrolls and S
// stays in registers.  At the served shape the grid is 256 blocks of 2 warps
// on 132 SMs: one warp a scheduler, no other warp to hide a stall behind.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // steps staged in shared memory at once

template <int N>
struct Stage {
  float r[kChunk][N];
  float k[kChunk][N];
  float w[kChunk][N];
  float v[kChunk][N];
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Stage steps [t0, t0 + steps) of the head's r, k, w, v rows: thread
// threadIdx.x copies the float4 columns q = threadIdx.x, threadIdx.x + N, ...
template <int N>
__device__ __forceinline__ void stage_chunk(Stage<N>& st, const float* __restrict__ r,
                                            const float* __restrict__ k,
                                            const float* __restrict__ w,
                                            const float* __restrict__ v, long long head,
                                            long long row, int t0, int steps) {
  constexpr int kQuads = N / 4;
  for (int q = threadIdx.x; q < steps * kQuads; q += N) {
    const int s = q / kQuads, c = 4 * (q % kQuads);
    const long long at = head + (t0 + s) * row + c;
    copy16(&st.r[s][c], r + at);
    copy16(&st.k[s][c], k + at);
    copy16(&st.w[s][c], w + at);
    copy16(&st.v[s][c], v + at);
  }
  commit();
}

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state, float* __restrict__ y,
            int seq, int heads) {
  __shared__ __align__(16) Stage<N> stages[2];
  __shared__ __align__(16) float us[N];
  const int j = threadIdx.x;
  const int h = blockIdx.x % heads;
  const long long b = blockIdx.x / heads;
  const long long row = (long long)heads * N;  // elements from step t to step t + 1
  const long long head = (b * seq * heads + h) * N;  // (b, 0, h, 0)
  float* st = state + (long long)blockIdx.x * N * N + j;  // column j of (b, h)'s state

  const int chunks = (seq + kChunk - 1) / kChunk;
  stage_chunk<N>(stages[0], r, k, w, v, head, row, 0, min(kChunk, seq));
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = st[i * N];
  us[j] = u[h * N + j];

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    if (c + 1 < chunks) {  // the next chunk's copies, in flight during this one
      stage_chunk<N>(stages[(c + 1) & 1], r, k, w, v, head, row, t0 + kChunk,
                     min(kChunk, seq - t0 - kChunk));
      wait_pending<1>();
    } else {
      wait_pending<0>();
    }
    __syncthreads();  // chunk c (and u) visible to every thread
    const Stage<N>& cur = stages[c & 1];
    const int steps = min(kChunk, seq - t0);
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const float vj = cur.v[t][j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&cur.r[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&cur.k[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&cur.w[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = __fmul_rn(kk[e], vj);
          acc = __fmaf_rn(rr[e], __fmaf_rn(uu[e], a, s[i + e]), acc);
          s[i + e] = __fmaf_rn(ww[e], s[i + e], a);
        }
      }
      y[head + (t0 + t) * row + j] = acc;
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
#pragma unroll
  for (int i = 0; i < N; ++i) st[i * N] = s[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* state, float* y, int batch, int seq, int heads, cudaStream_t stream) {
  wkv6_kernel<N><<<batch * heads, N, 0, stream>>>(r, k, v, w, u, state, y, seq, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (batch, seq, heads, n) float32; u: (heads, n); state:
// (batch, heads, n, n), read and written in place.  n is 16, 32 or 64.
extern "C" int repro_wkv6_earlier(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* state, void* y, int batch, int seq, int heads,
                          int n, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* sf = static_cast<float*>(state);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
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
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i] + [i] * extra_ints + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def earlier_entry():
    """The earlier design, built with the package's nvcc flags: its C entry point."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "wkv6_pr30.cu"
    src.write_text(EARLIER)
    lib = out_dir / "libwkv6_pr30.so"
    _nvcc(src, lib)
    return _bind(ctypes.CDLL(str(lib)).repro_wkv6_earlier)


@functools.lru_cache(maxsize=None)
def sweep_entry():
    """``csrc/wkv6.cu`` built with every plan of SWEEP: repro_wkv6_plan and
    ptxas's registers and spill bytes by (n, P, C)."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    plans = " ".join(f"X({n}, {p}, {c})" for n, pcs in SWEEP.items() for p, c in pcs)
    src = out_dir / "wkv6_sweep.cu"
    src.write_text(f"#define WKV6_SWEEP_PLANS {plans}\n"
                   f"#include \"{_build.sources()['wkv6'].resolve()}\"\n")
    lib = out_dir / "libwkv6_sweep.so"
    log = _nvcc(src, lib)
    return _bind(ctypes.CDLL(str(lib)).repro_wkv6_plan, extra_ints=2), ptxas_registers(log)


def ptxas_registers(log: str) -> dict:
    """(n, P, C) -> (registers, spill store bytes) of each wkv6_kernel
    instance in a ``-Xptxas -v`` log."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"wkv6_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            key = tuple(int(x) for x in m.groups())
        spill = re.search(r"(\d+) bytes spill stores", line)
        if key and spill:
            out[key] = [None, int(spill.group(1))]
        used = re.search(r"Used (\d+) registers", line)
        if key and used:
            out.setdefault(key, [None, 0])[0] = int(used.group(1))
            key = None
    return {k: tuple(v) for k, v in out.items()}


def _call(fn, r, k, v, w, u, state, y, *plan):
    """Run a C entry point on the tensors, y written into ``y``."""
    from repro_torch.kernels import _build

    B, S, H, n = r.shape
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                    state.data_ptr(), y.data_ptr(), B, S, H, n, *plan, _build.stream_of(r)),
                 "wkv6 design")
    return y


def wkv6_bound(B, S, H, n):
    """(ms, "bytes" or "operations"): the least time of the recurrence at
    (B, S, H, n).  Bytes: r, k, v, w read and y written once, the state read
    and written once, u read.  Operations: the least work of the function,
    y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, so 2 flops an (i, j) for y
    and 3 for S <- w S + k v, and a (b, t, h) 3n for the u term's dot and 2n
    to add it into y."""
    elems = B * S * H * n
    return smoke.bound_ms(5 * 4 * elems + 2 * 4 * B * H * n * n + 4 * H * n,
                          5 * elems * n + 5 * elems)


def _held(torch, label, runs, want):
    """Each design's (y, state) within WKV_TOL of the plain version's; the
    relative errors by design."""
    errs = {name: smoke.wkv6_errors(torch, *got, *want) for name, got in runs.items()}
    smoke.need(all(max(e.values()) <= smoke.WKV_TOL for e in errs.values()),
               f"wkv6 designs {label} against plain: {errs} (limit {smoke.WKV_TOL})")
    return errs


def _time_shape(torch, dev, flush, label, S, state):
    """Both designs at the served (B, H, n) and S steps from a zero or a
    mid-run state: held against the plain version, timed cold in turns."""
    from repro_torch.kernels.wkv6.kernel import launch
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    old = earlier_entry()
    B, _, H, n = smoke.WKV_SERVED
    r, k, v, w, u, s0 = smoke.wkv6_inputs(torch, dev, B, S, H, n, seed=31 + S, state=state)
    work, y_old = s0.clone(), torch.empty_like(r)

    def reset():
        work.copy_(s0)

    def current():
        return launch(r, k, v, w, u, work)

    def earlier():
        return _call(old, r, k, v, w, u, work, y_old)

    designs = {"current": current, "earlier": earlier}
    runs = {}
    for name, fn in designs.items():
        reset()
        runs[name] = (fn().clone(), work.clone())
    reset()
    again = current()
    smoke.need(torch.equal(again, runs["current"][0]) and torch.equal(work, runs["current"][1]),
               f"wkv6 {label}: the current design does not repeat")
    errs = _held(torch, label, runs, wkv6_ref(r, k, v, w, u, s0))
    times = {"earlier": [], "current": []}
    for name in ("earlier", "current", "current", "earlier"):
        times[name].append(smoke.timed_ms(torch, designs[name], REPS, flush, reset=reset))
    plain_ms = smoke.timed_ms(torch, lambda: wkv6_ref(r, k, v, w, u, s0), 2 if S > 1 else 10,
                              flush)
    b, by = wkv6_bound(B, S, H, n)
    cur, ear = sum(times["current"]) / 2, sum(times["earlier"]) / 2
    print(f"wkv6 {label} B={B} S={S} H={H} n={n}, cold in turns (earlier, current, current, "
          f"earlier): current {times['current'][0] * 1e3:.2f} / {times['current'][1] * 1e3:.2f} "
          f"us, earlier ({EARLIER_DESIGN}) {times['earlier'][0] * 1e3:.2f} / "
          f"{times['earlier'][1] * 1e3:.2f} us; earlier / current {ear / cur:.3f}; bound "
          f"{b * 1e3:.2f} us by {by} (current / bound {cur / b:.2f}); plain {plain_ms * 1e3:.1f} "
          f"us; |design - plain| / largest {errs}")
    return {"ms": cur, "earlier_ms": ear, "turns": times, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "relative_err": errs}


def time_designs(torch, dev, flush):
    """Both designs at the served layer (from zero) and at a decode step
    (from a mid-run state): each within WKV_TOL of the plain version, the
    current one bit for bit on repeat; cold in turns, beside the bound, the
    plain version and the floor.  Returns the times and errors by shape."""
    from repro_torch.kernels.wkv6.kernel import launch

    out = {"served": _time_shape(torch, dev, flush, "served layer", smoke.WKV_SERVED[1], "zero"),
           "decode": _time_shape(torch, dev, flush, "decode step", 1, "mid-run")}
    r, k, v, w, u, s0 = smoke.wkv6_inputs(torch, dev, 1, 1, 1, 16, seed=31)
    floor = smoke.timed_ms(torch, lambda: launch(r, k, v, w, u, s0), REPS, flush)
    print(f"wkv6 floor of the timing (the current kernel at B = H = S = 1, n = 16: one block, "
          f"one step): {floor * 1e3:.2f} us cold")
    out.update(floor_ms=floor, earlier_design=EARLIER_DESIGN)
    return out


def parts(torch, dev, flush):
    """The kernel at the served layer with each of PARTS' edits, built in
    parallel, timed cold in PART_ROUNDS rounds; the times by part."""
    from repro_torch.kernels import _build

    text = _build.sources()["wkv6"].read_text()
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, edits) in enumerate(PARTS):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"parts: {old!r} is not in csrc/wkv6.cu")
            src = src.replace(old, new)
        path, lib = out_dir / f"wkv6_part{i}.cu", out_dir / f"libwkv6_part{i}.so"
        path.write_text(src)
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for label, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        fns[label] = _bind(ctypes.CDLL(str(lib)).repro_wkv6)
    B, S, H, n = smoke.WKV_SERVED
    r, k, v, w, u, s0 = smoke.wkv6_inputs(torch, dev, B, S, H, n, seed=31)
    work, y = s0.clone(), torch.empty_like(r)
    times = {label: [] for label in fns}
    for _ in range(PART_ROUNDS):
        for label, fn in fns.items():
            times[label].append(smoke.timed_ms(
                torch, functools.partial(_call, fn, r, k, v, w, u, work, y), REPS, flush,
                reset=functools.partial(work.copy_, s0)))
    whole = sum(times[PARTS[0][0]]) / PART_ROUNDS
    print(f"wkv6 at B={B} S={S} H={H} n={n}, parts taken out, cold in {PART_ROUNDS} rounds:")
    for label, ts in times.items():
        mean = sum(ts) / PART_ROUNDS
        print(f"  {label}: {' / '.join(f'{t * 1e3:.2f}' for t in ts)} us "
              f"({(mean - whole) * 1e3:+.2f} against the whole kernel)")
    return {label: sum(ts) / PART_ROUNDS for label, ts in times.items()}


def sweep(torch, dev, flush):
    """Every plan of SWEEP: held against the plain version at B 2, S 33,
    H 4 from a mid-run state (within WKV_TOL, bit for bit on repeat), timed
    cold at B 8, S 2048, H = 2048 / n; printed fastest first by n."""
    from repro_torch.kernels.wkv6.kernel import PLANS
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    fn, regs = sweep_entry()
    rows = []
    for n, plans in SWEEP.items():
        small = smoke.wkv6_inputs(torch, dev, 2, 33, 4, n, seed=n + 1, state="mid-run")
        want = wkv6_ref(*small)
        big = smoke.wkv6_inputs(torch, dev, 8, 2048, SWEEP_MODEL_DIM // n, n, seed=n)
        work, y = big[-1].clone(), torch.empty_like(big[0])
        for P, C in plans:
            got = []
            for _ in range(2):
                s = small[-1].clone()
                got.append((_call(fn, *small[:-1], s, torch.empty_like(small[0]), P, C), s))
            smoke.need(torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1]),
                       f"wkv6 plan n={n} P={P} C={C} does not repeat")
            errs = _held(torch, f"plan n={n} P={P} C={C}", {"plan": got[0]}, want)["plan"]
            ms = smoke.timed_ms(torch, functools.partial(_call, fn, *big[:-1], work, y, P, C),
                                SWEEP_REPS, flush, reset=functools.partial(work.copy_, big[-1]))
            reg, spill = regs.get((n, P, C), (None, None))
            rows.append({"n": n, "P": P, "C": C, "threads": P * n // C, "ms": ms,
                         "registers": reg, "spill_bytes": spill, "relative_err": errs,
                         "chosen": PLANS[n] == (P, C)})
    for n in SWEEP:
        print(f"wkv6 plans at n={n}, B=8 S=2048 H={SWEEP_MODEL_DIM // n}, cold, fastest first:")
        for row in sorted((x for x in rows if x["n"] == n), key=lambda x: x["ms"]):
            print(f"  P={row['P']:2d} C={row['C']} ({row['threads']:4d} threads, "
                  f"{row['registers']} registers, {row['spill_bytes']} B spilled): "
                  f"{row['ms'] * 1e3:9.2f} us{'  <- Plan<n>' if row['chosen'] else ''}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: time_wkv6_designs.py needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(smoke.nvidia_smi_line())
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2
    if "--sweep" in sys.argv[1:]:
        out = {"sweep": sweep(torch, dev, scratch.zero_)}
    elif "--parts" in sys.argv[1:]:
        out = {"parts": parts(torch, dev, scratch.zero_)}
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
