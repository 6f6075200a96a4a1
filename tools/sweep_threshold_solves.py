#!/usr/bin/env python3
"""Grid and step sweeps of the port's two persistent threshold solves.

    python3 tools/sweep_threshold_solves.py

Run from the root of a checkout on one NVIDIA card.  Each solve is launched
through its C entry point (so at grids other than its wrapper's plan, and
with no launch counted), cold (L2 flushed) and warm in L2, at a few step
counts: 0 steps is the launch and the prologue alone, and the rest shows
what a step costs.

* the warm projection (``project_warm_tau``) over chip_smoke.py phase 3's
  catalog (N = 1e6) from a mid-run tau: one block an SM with y in registers
  (the plan), and with y re-read from L2 at one and at half a block an SM;
  0, 1 and 5 sweeps;
* the bucket solve (``solve_buckets``) over a mid-run ogb_tree histogram
  (V = 65 536, as chip_smoke.py phase 3 builds it) and over a histogram of
  the same size with every bucket non-empty: 132, 66, 33 and 16 blocks
  (16 is the SM count of the largest thread-block cluster), the means in
  shared memory; 0, 6 and 30 halvings.  Every grid's threshold is held to
  the plain version's, bit for bit;
* the sized solve (``solve_sized``) at a recorded sized_cdn full chunk
  (chip_smoke.py's ``sized_state``) and at built instances of 4 classes of
  65 536 buckets with G = 1, 6, 32, 33 and 200 groups of 64 buckets that
  hold an item (:func:`time_sized`), beside its earlier design, whose
  source is kept here as text (``EARLIER_SIZED``, built into
  ``build/repro_torch/earlier/``): both held to the plain version bit for
  bit, the plan the card took counted, cold in the order earlier, current,
  current, earlier, and at 0, 1 and 30 steps.  chip_smoke.py phase 20 runs
  :func:`time_sized`.

It prints the card and its power limit first, one line a grid, and a JSON
line of every time last.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 30
#: the sized solve's built instances: groups of 64 buckets that hold an item
SIZED_GROUPS = (1, 6, 32, 33, 200)
#: the sized solve's step counts: the prologue alone, one step, the path's
SIZED_STEPS = (0, 1, 30)
#: what the sized solve's earlier design did
EARLIER_SIZED_DESIGN = ("one block of 1024 threads for every step: a warp a group, a warp a "
                        "class, Newton by one thread, three __syncthreads a step")
#: ``csrc/bucket_mass.cu``'s sized solve before its few-groups plan
EARLIER_SIZED = r"""// ../csrc/bucket_mass.cu's sized solve before its few-groups plan: every step
// on the whole 1024-thread block, three __syncthreads a step.

#include <climits>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bucket_mean(float c, float total) {
  return c > 0.0f ? __fdiv_rn(total, fmaxf(c, 1.0f)) : 0.0f;
}

}  // namespace

// The sized OGB's threshold solve: K size classes, Newton on rho, one launch.
//
// The reference solves sum_k s_k * m_k(s_k * rho) = C, m_k class k's
// bucket mass at its own threshold t_k = s_k * rho, by `iters` (30)
// safeguarded Newton steps, each reading 2 prefix sums a class
// (src/repro/cachesim/tree_engines.py: make_sized_ogb_tree_chunk, the
// per-class form of bucket_mass_kernel's mass).  The plain version is
// ../ref.py's solve_sized_ref; this computes the same, sum for sum.
//
// One block.  Class k's buckets are the leaves of row k of the stacked
// count and sum trees (row_stride nodes apart); the tree's first level above
// the leaves holds each group of 64 buckets' count, so the groups that hold
// an item are found from it, in (class, group) order, by one ordered
// compaction, and the first kCacheGroups of them keep their 64 (count, mean)
// pairs in shared memory (the rest are re-read from L2 each step, the same
// values).  Then per step:
//  1. warp w takes the groups w, w + 32, ...: lane l the buckets l and l + 32,
//     each term cnt * clip(mean - t_k, 0, 1) and its interior count in
//     float64, the warp's sum by an xor butterfly, added in order to the
//     warp's running sum of the class, flushed where the class changes;
//  2. a warp a class sums the 32 warps' sums by a butterfly; thread 0 adds
//     the classes in order (s_k * m_k and float32(s_k^2) * i_k in float64),
//     rounds once to float32 and takes the Newton step, the midpoint where
//     the point is not strictly inside the bracket, as the reference does.
// Every float op is the plain version's, rounded as it rounds (__fmul_rn,
// __fsub_rn, __fdiv_rn, __dadd_rn, __dmul_rn: no contraction), so the
// iterate is its bit for bit.
// Bound: the counts of the groups that hold an item, and their sums, read
// once, and 5 operations a bucket a step over them; latency-bound at a
// mid-run histogram (a few hundred groups): two __syncthreads a step.

namespace {

constexpr int kSizedThreads = 1024;
constexpr int kSizedWarps = kSizedThreads / 32;
constexpr int kSizedMaxClasses = 32;
constexpr int kGroup = 64;
constexpr int kCacheGroups = 192;  // groups whose pairs stay in shared memory: 96 KB

struct SizedShared {
  float2 pairs[kCacheGroups * kGroup];          // (count, mean)
  double part[2][kSizedMaxClasses][kSizedWarps];  // the warps' sums by class
  int warp_kept[kSizedWarps];
  int n_groups;
  float t, lo, hi;
};

__device__ __forceinline__ float2 bucket(const float* cnt, const float* total, long long at) {
  const float c = __ldg(cnt + at);
  return make_float2(c, bucket_mean(c, __ldg(total + at)));
}

__global__ void __launch_bounds__(kSizedThreads, 1)
solve_sized_kernel(const float* __restrict__ cnt, const float* __restrict__ total,
                   long long row_stride, long long v, int classes, const float* __restrict__ s,
                   const float* __restrict__ cap_p, const float* __restrict__ lo_p,
                   const float* __restrict__ hi_p, int iters, int* __restrict__ groups,
                   float* __restrict__ t_out) {
  extern __shared__ unsigned char smem_raw[];
  SizedShared& sh = *reinterpret_cast<SizedShared*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per_class = v / kGroup;  // groups a class: the first level's nodes
  const long long total_groups = per_class * classes;
  // the groups that hold an item, in (class, group) order, into `groups`
  int kept = 0;
  for (long long i0 = 0; i0 < total_groups; i0 += kSizedThreads) {
    const long long i = i0 + threadIdx.x;
    bool keep = false;
    if (i < total_groups) {
      const long long k = i / per_class;
      keep = __ldg(cnt + k * row_stride + v + (i - k * per_class)) != 0.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sh.warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int at = kept + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kSizedWarps; ++w) {
      at += w < warp ? sh.warp_kept[w] : 0;
      kept += sh.warp_kept[w];
    }
    if (keep) groups[at] = (int)i;
    __syncthreads();
  }
  const int n_groups = kept;
  __syncthreads();  // the list is in global memory: read it below through L2 (__ldcg)
  for (int e = threadIdx.x; e < min(n_groups, kCacheGroups) * kGroup; e += kSizedThreads) {
    const int i = __ldcg(groups + e / kGroup);
    const long long k = i / per_class;
    sh.pairs[e] = bucket(cnt, total, k * row_stride + (i - k * per_class) * kGroup + e % kGroup);
  }
  for (int e = threadIdx.x; e < 2 * kSizedMaxClasses * kSizedWarps; e += kSizedThreads) {
    (&sh.part[0][0][0])[e] = 0.0;
  }
  if (threadIdx.x == 0) {
    sh.lo = *lo_p;
    sh.hi = *hi_p;
    sh.t = sh.lo;
  }
  __syncthreads();
  const float cap = *cap_p;
  for (int it = 0; it < iters; ++it) {
    const float t = sh.t;
    // 1. the groups, a warp at a time, in order within the warp
    double acc_m = 0.0, acc_i = 0.0;
    int cls = -1;
    for (int g = warp; g < n_groups; g += kSizedWarps) {
      const int i = __ldcg(groups + g);
      const int k = (int)(i / per_class);
      if (k != cls) {
        if (cls >= 0 && lane == 0) {
          sh.part[0][cls][warp] = acc_m;
          sh.part[1][cls][warp] = acc_i;
        }
        cls = k;
        acc_m = acc_i = 0.0;
      }
      const float tk = __fmul_rn(__ldg(s + k), t);
      double m2 = 0.0, i2 = 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int leaf = lane + 32 * h;
        float2 b;
        if (g < kCacheGroups) {
          b = sh.pairs[g * kGroup + leaf];
        } else {
          b = bucket(cnt, total, (long long)k * row_stride + (i - (long long)k * per_class) *
                                                                 kGroup + leaf);
        }
        const float z = fminf(fmaxf(__fsub_rn(b.y, tk), 0.0f), 1.0f);
        m2 = __dadd_rn(m2, (double)__fmul_rn(b.x, z));
        i2 = __dadd_rn(i2, z > 0.0f && z < 1.0f ? (double)b.x : 0.0);
      }
      for (int o = 16; o > 0; o >>= 1) {
        m2 = __dadd_rn(m2, __shfl_xor_sync(0xffffffffu, m2, o));
        i2 = __dadd_rn(i2, __shfl_xor_sync(0xffffffffu, i2, o));
      }
      acc_m = __dadd_rn(acc_m, m2);
      acc_i = __dadd_rn(acc_i, i2);
    }
    if (cls >= 0 && lane == 0) {
      sh.part[0][cls][warp] = acc_m;
      sh.part[1][cls][warp] = acc_i;
    }
    __syncthreads();
    // 2. a warp a class and sum; thread 0 the step
    if (warp < classes) {
      double m = sh.part[0][warp][lane], n_in = sh.part[1][warp][lane];
      sh.part[0][warp][lane] = 0.0;
      sh.part[1][warp][lane] = 0.0;
      for (int o = 16; o > 0; o >>= 1) {
        m = __dadd_rn(m, __shfl_xor_sync(0xffffffffu, m, o));
        n_in = __dadd_rn(n_in, __shfl_xor_sync(0xffffffffu, n_in, o));
      }
      if (lane == 0) {
        sh.part[0][warp][0] = m;  // read by thread 0 after the warps of the classes
        sh.part[1][warp][0] = n_in;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double mass = 0.0, slope = 0.0;
      for (int k = 0; k < classes; ++k) {
        const float sk = __ldg(s + k);
        mass = __dadd_rn(mass, __dmul_rn((double)sk, sh.part[0][k][0]));
        slope = __dadd_rn(slope, __dmul_rn((double)__fmul_rn(sk, sk), sh.part[1][k][0]));
        sh.part[0][k][0] = 0.0;
        sh.part[1][k][0] = 0.0;
      }
      const float m32 = __double2float_rn(mass), s32 = __double2float_rn(slope);
      float lo = sh.lo, hi = sh.hi;
      const bool too_much = m32 >= cap;
      lo = too_much ? t : lo;
      hi = too_much ? hi : t;
      const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(m32, cap), fmaxf(s32, 1e-12f)));
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const bool ok = s32 > 0.0f && t_newton > lo && t_newton < hi;
      sh.lo = lo;
      sh.hi = hi;
      sh.t = ok ? t_newton : t_mid;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *t_out = sh.t;
}

}  // namespace

// cnt and total: `classes` stacked trees, row_stride nodes apart, each with
// v leaves (a multiple of 64) and, right after them, the level of the sums
// of each 64 (a radix-64 tree).  s: (classes,) float32 class sizes; cap, lo,
// hi: () float32.  groups: scratch of classes * v / 64 int32.  t_out: ()
// float32, the last iterate.
extern "C" int repro_solve_sized(const void* cnt, const void* total, long long row_stride,
                                 long long v, int classes, const void* s, const void* cap,
                                 const void* lo, const void* hi, int iters, void* groups,
                                 void* t_out, void* stream) {
  if (classes < 1 || classes > kSizedMaxClasses || v < kGroup || v % kGroup || iters < 0 ||
      row_stride < v + v / kGroup || (long long)classes * (v / kGroup) > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(SizedShared);
  const cudaError_t e = cudaFuncSetAttribute(
      solve_sized_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_sized_kernel<<<1, kSizedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cnt), static_cast<const float*>(total), row_stride, v, classes,
      static_cast<const float*>(s), static_cast<const float*>(cap), static_cast<const float*>(lo),
      static_cast<const float*>(hi), iters, static_cast<int*>(groups),
      static_cast<float*>(t_out));
  return (int)cudaGetLastError();
}
"""


def sweep(torch, label, launch, grids, steps, flush, out):
    """Cold and warm us of ``launch(blocks, flag, steps)()`` at each grid
    ``(blocks, flag, name)`` and step count."""
    for blocks, flag, name in grids:
        row = {}
        for n in steps:
            call = launch(blocks, flag, n)
            row[n] = [smoke.timed_ms(torch, call, REPS, fl) * 1e3 for fl in (flush, None)]
        out.append({"solve": label, "blocks": blocks, "design": name, "us_cold_warm": row})
        print(f"{label} at {blocks} blocks, {name}; steps: cold / warm us: "
              + ", ".join(f"{n}: {c:.2f} / {w:.2f}" for n, (c, w) in row.items()))


@functools.lru_cache(maxsize=None)
def earlier_sized_entry():
    """The earlier sized solve, built with the package's nvcc flags: its C
    entry point (the current one's arguments less the tally)."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "solve_sized_earlier.cu", out_dir / "libsolve_sized_earlier.so"
    src.write_text(EARLIER_SIZED)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}")
    fn = ctypes.CDLL(str(lib)).repro_solve_sized
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, i, p, p, p, p, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def sized_instance(torch, dev, groups, seed, kk=4, v=65536):
    """``groups`` groups of 64 buckets that hold an item, spread over ``kk``
    classes of ``v`` buckets, as stacked radix-64 trees on ``dev``, with
    the dyadic class sizes and a capacity whose root lies inside [0, 0.25]:
    ``(ycnt, ysum, v, s, cap, lo, hi)``."""
    from repro_torch.kernels.prefix_tree.ops import tree_build

    gen = torch.Generator().manual_seed(seed)
    cnt = torch.zeros(kk, v)
    picks = torch.randperm(kk * (v // 64), generator=gen)[:groups]
    for p in picks.tolist():
        k, g = divmod(p, v // 64)
        c = torch.randint(0, 6, (64,), generator=gen).float()
        c[int(torch.randint(0, 64, (1,), generator=gen))] += 1.0  # at least one item
        cnt[k, g * 64:(g + 1) * 64] = c
    tot = cnt * torch.rand((kk, v), generator=gen) * 3
    s = torch.tensor([1.0, 4.0, 16.0, 64.0][:kk])
    cap = torch.tensor(0.3 * float((cnt * s[:, None]).sum()))
    ycnt = torch.stack([tree_build(x, 64) for x in cnt]).to(dev)
    ysum = torch.stack([tree_build(x, 64) for x in tot]).to(dev)
    return ycnt, ysum, v, s.to(dev), cap.to(dev), torch.zeros((), device=dev), \
        torch.tensor(0.25, device=dev)


def time_sized(torch, dev, flush, recorded=None):
    """The sized solve at ``recorded`` (a ``solve_sized`` call's arguments,
    where given) and at a built instance of each of SIZED_GROUPS: the card
    against the plain version on the card and the CPU, bit for bit, for the
    current and the earlier design; the plan the current one took (its
    tally); both timed cold in the order earlier, current, current,
    earlier, and at SIZED_STEPS steps through their C entry points.
    Returns ``{label: row}``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_tree import kernel as pk
    from repro_torch.kernels.prefix_tree.ref import sized_groups, solve_sized_ref

    earlier = earlier_sized_entry()
    stream = torch.cuda.current_stream().cuda_stream
    cases = [(f"G={g}", sized_instance(torch, dev, g, g)) for g in SIZED_GROUPS]
    if recorded is not None:
        cases.insert(0, ("recorded sized_cdn full chunk", recorded))
    rows = {}
    for label, (ycnt, ysum, v, s, cap, lo, hi, *rest) in cases:
        iters = rest[0] if rest else SIZED_STEPS[-1]
        kk = s.numel()
        groups = torch.empty(kk * (v // 64), dtype=torch.int32, device=dev)

        def launch(design, steps, ycnt=ycnt, ysum=ysum, v=v, s=s, cap=cap, lo=lo, hi=hi,
                   groups=groups, kk=kk):
            out = torch.empty((), dtype=torch.float32, device=dev)
            args = [ycnt.data_ptr(), ysum.data_ptr(), ycnt.shape[1], v, kk, s.data_ptr(),
                    cap.data_ptr(), lo.data_ptr(), hi.data_ptr(), steps, groups.data_ptr(),
                    out.data_ptr()]
            if design == "current":
                args.append(pk.sized_tally(dev).data_ptr())
                fn = pk._sized_entry()
            else:
                fn = earlier

            def call():
                _build.check(fn(*args, stream), f"{design} solve_sized")
                return out

            return call

        want = solve_sized_ref(ycnt[:, :v], ysum[:, :v], s, cap, lo, hi, iters)
        on_cpu = solve_sized_ref(ycnt[:, :v].cpu(), ysum[:, :v].cpu(), s.cpu(), cap.cpu(),
                                 lo.cpu(), hi.cpu(), iters)
        before = pk.read_sized_tally(dev)
        got = {d: launch(d, iters)() for d in ("current", "earlier")}
        after = pk.read_sized_tally(dev)
        plan = "few groups" if after["few groups"] > before["few groups"] else "block"
        g_count = sized_groups(ycnt[:, :v]).shape[0]
        smoke.need(after[plan] == before[plan] + 1 and (plan == "few groups") == (g_count <= 32),
                   f"sized solve, {label}: G={g_count} took the {plan} plan")
        for d, t in got.items():
            smoke.need(torch.equal(t, want) and torch.equal(t.cpu(), on_cpu),
                       f"sized solve, {label}: the {d} design {float(t)!r} is not the plain "
                       f"version's {float(want)!r} (CPU {float(on_cpu)!r})")
        runs = {"earlier": [], "current": []}
        for d in ("earlier", "current", "current", "earlier"):
            runs[d].append(smoke.timed_ms(torch, launch(d, iters), REPS, flush))
        ms = {d: sum(r) / len(r) for d, r in runs.items()}
        by_steps = {d: {n: smoke.timed_ms(torch, launch(d, n), REPS, flush) * 1e3
                        for n in SIZED_STEPS} for d in ("current", "earlier")}
        b, by = smoke.bound_ms(4 * kk * (v // 64) + 8 * 64 * g_count, 6 * iters * 64 * g_count)
        rows[label] = {"ms": ms["current"], "earlier_ms": ms["earlier"], "runs_ms": runs,
                       "us_by_steps": by_steps, "groups": g_count, "classes": kk,
                       "iters": iters, "plan": plan, "bound_ms": b, "bound_by": by,
                       "max_abs_err": 0.0, "t": float(want)}
        print(f"sized solve, {label} ({kk} classes, G={g_count}, {iters} steps, the {plan} "
              f"plan): cold {ms['current'] * 1e3:.2f} us, the earlier design "
              f"{ms['earlier'] * 1e3:.2f} us; by steps "
              + ", ".join(f"{n}: {by_steps['current'][n]:.2f} / {by_steps['earlier'][n]:.2f}"
                          for n in SIZED_STEPS)
              + f" us (current / earlier); bound {b * 1e3:.4f} us by {by}; both bit for bit")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this sweep needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.jaxcache.fractional import warm_bracket_hi
    from repro_torch.kernels import _build
    from repro_torch.kernels.capped_simplex import ops
    from repro_torch.kernels.prefix_tree import kernel as pk
    from repro_torch.kernels.prefix_tree.ref import solve_buckets_ref, solve_rounds
    from repro_torch.kernels.scatter_counts.ops import histogram

    print(f"card: {smoke.nvidia_smi_line()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build_all()
    stream = torch.cuda.current_stream().cuda_stream
    sms = _build.sm_count(dev.index)
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    def scalar(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    trace = zipf(smoke.N, smoke.T, alpha=smoke.ALPHA, seed=0)
    eta = theoretical_eta(smoke.C, smoke.N, smoke.T, 1)
    out = []

    # the warm projection, as chip_smoke.py phase 3 calls it
    gen = torch.Generator().manual_seed(1)
    f = (torch.rand(smoke.N, generator=gen) * (2.0 * smoke.C / smoke.N)).to(dev)
    counts = histogram(torch.from_numpy(trace[: smoke.W].astype("int32")).to(dev), smoke.N)
    eta_t, cap = scalar(eta), scalar(smoke.C)
    lo, hi = scalar(0.0), warm_bracket_hi(eta_t * float(smoke.W))
    tau0 = scalar(smoke.dense_tau(trace, eta))

    def warm_launch(blocks, resident, sweeps):
        pmass = torch.empty(max(1, sweeps * blocks), dtype=torch.float64, device=dev)
        pcnt = torch.empty(max(1, sweeps * blocks), dtype=torch.int32, device=dev)
        tau = torch.empty((), dtype=torch.float32, device=dev)
        return lambda: _build.check(ops._warm_entry()(
            f.data_ptr(), counts.data_ptr(), eta_t.data_ptr(), cap.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), tau0.data_ptr(), smoke.N, sweeps, blocks, int(resident),
            pmass.data_ptr(), pcnt.data_ptr(), tau.data_ptr(), None, stream), "project_warm_tau")

    sweep(torch, "project_warm_tau", warm_launch,
          [(sms, True, "y in registers [plan]"), (sms, False, "y re-read from L2"),
           (sms // 2, False, "y re-read from L2")], (0, 1, smoke.SWEEPS), flush, out)

    # the bucket solve: the mid-run histogram, and one with every bucket
    # non-empty, over a bracket with the root inside
    carry = smoke.tree_state(trace, eta)
    v = smoke.V
    rho, half = float(carry.rho), max(eta * smoke.W, 4.0 * float(carry.w))
    gen = torch.Generator().manual_seed(3)
    dense_cnt = torch.randint(1, 31, (v,), generator=gen).to(torch.float32)
    centre = -1.0 + (torch.arange(v) + torch.rand(v, generator=gen)) * (3.0 / v)
    histograms = {
        "mid-run histogram": (carry.ycnt[:v], carry.ysum[:v], scalar(smoke.C),
                              scalar(rho - half), scalar(rho + half)),
        "every bucket non-empty": (dense_cnt.to(dev), (dense_cnt * centre).to(dev),
                                   scalar(0.4 * float(dense_cnt.double().sum())),
                                   scalar(-1.5), scalar(2.5)),
    }
    for label, (cnt, tot, bcap, blo, bhi) in histograms.items():
        nnz = int((cnt != 0).sum())
        want = solve_buckets_ref(cnt, tot, bcap, blo, bhi, smoke.TREE_ITERS)

        def solve_launch(blocks, on_chip, iters, cnt=cnt, tot=tot, bcap=bcap, blo=blo, bhi=bhi):
            pmass = torch.empty(max(1, len(solve_rounds(iters)) * pk.SOLVE_POINTS * blocks),
                                dtype=torch.float64, device=dev)
            lo_out = torch.empty((), dtype=torch.float32, device=dev)

            def call():
                _build.check(pk._solve_entry()(
                    cnt.data_ptr(), tot.data_ptr(), bcap.data_ptr(), blo.data_ptr(),
                    bhi.data_ptr(), v, iters, blocks, int(on_chip), pmass.data_ptr(),
                    lo_out.data_ptr(), stream), "solve_buckets")
                return lo_out

            return call

        grids = [(sms, True, "means in shared memory [plan]")] + [
            (b, True, "means in shared memory") for b in (sms // 2, sms // 4, 16)]
        for blocks, on_chip, _ in grids:
            got = solve_launch(blocks, on_chip, smoke.TREE_ITERS)()
            if not torch.equal(got, want):
                print(f"FAILED: {label}, {blocks} blocks: {float(got)!r} is not the plain "
                      f"version's {float(want)!r}", file=sys.stderr)
                return 1
        print(f"solve_buckets over the {label} ({nnz} of {v} buckets non-empty): every grid "
              f"equal to the plain version bit for bit")
        sweep(torch, f"solve_buckets, {label}", solve_launch, grids, (0, 6, smoke.TREE_ITERS),
              flush, out)

    # the sized solve, beside its earlier design
    try:
        sized = time_sized(torch, dev, flush, smoke.sized_state(torch)["solve"][0])
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"card": smoke.nvidia_smi_line(), "sweeps": out, "solve_sized": sized}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
