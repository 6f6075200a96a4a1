#!/usr/bin/env python3
"""The warm projection's solve over R rows beside its one-row design, on one
NVIDIA card.

    python3 tools/time_warm_solves.py

Run from the root of a checkout.  ``csrc/mass.cu``'s ``repro_project_warm``
(the port's ``project_warm`` and ``project_warm_tau`` on a CUDA tensor)
cuts each row into fixed tiles of 8192 items and takes R rows, a sweep's
grid of combos over one histogram, in one persistent launch.  Its one-row
design (item i to thread i mod (blocks x threads), the block partials summed
in block order, so a row's bits followed the grid) is kept here as text
(``EARLIER``) and built into ``build/repro_torch/earlier/``.

:func:`time_solves` takes rows of real fractional states: at one row
(R = 1, N = 1e6) the earlier design and the current solve, tau alone, cold
(L2 flushed) in the order earlier, current, current, earlier, each within
1e-6 of the plain version; then at R = 1, 4 and 18 the current launch, with
and without its f' epilogue, beside R one-row launches of the same rows,
each row bit for bit its one-row launch, beside the plain version row by
row and the bound.  chip_smoke.py phase 22 calls it.  Alone it draws its
rows at random from a seed; it prints the card and its power limit first and
a JSON line of every case last.
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

REPS = 20
#: the grid sizes timed, and the sweeps of a solve (replay's default)
ROWS, SWEEPS = (1, 4, 18), 5
#: what the earlier design did
EARLIER_DESIGN = ("one row a launch: item i to thread i mod (blocks x threads), y in registers "
                  "where the resident blocks hold the row; the block partials summed in block "
                  "order, so a row's bits follow the grid")
#: ``csrc/mass.cu``'s warm projection before its fixed tiles
EARLIER = r"""// The warm projection's whole solve in one persistent launch, one row, as
// csrc/mass.cu had it before its fixed tiles: item i of the row to thread
// i mod (blocks x threads), y kept in registers (kWarmItems a thread) where
// the resident blocks hold the row, else re-read every sweep; each block's
// partial summed in block order after the grid barrier, so the order of the
// row's sums follows the grid.

#include <cuda_runtime.h>

#include "persistent.cuh"

// ---------------------------------------------------------------------------
// The warm projection in one persistent launch.

namespace {

constexpr int kWarmThreads = 1024;
constexpr int kWarmWarps = kWarmThreads / 32;
constexpr int kWarmBlocksPerSm = 1;
constexpr int kWarmItems = 8;   // items of y a thread keeps in registers
constexpr int kWarmUnroll = 8;  // partials a lane loads at once: 32 * 8 >= 132 blocks

__device__ __forceinline__ void add_term(float y, float t, double& m, unsigned& q) {
  const float z = __fsub_rn(y, t);
  m += (double)fminf(fmaxf(z, 0.0f), 1.0f);
  q += (z > 0.0f && z < 1.0f) ? 1u : 0u;
}

template <bool kResident>
__global__ void __launch_bounds__(kWarmThreads, kWarmBlocksPerSm)
project_warm_kernel(const float* __restrict__ f, const float* __restrict__ c,
                    const float* __restrict__ eta_p, const float* __restrict__ cap_p,
                    const float* __restrict__ lo_p, const float* __restrict__ hi_p,
                    const float* __restrict__ tau0_p, long long n, int sweeps,
                    double* __restrict__ pmass, unsigned* __restrict__ pcnt,
                    float* __restrict__ tau_out, float* __restrict__ out) {
  __shared__ double sm[kWarmWarps];
  __shared__ unsigned sq[kWarmWarps];
  __shared__ float next_t;
  const float eta = *eta_p, cap = *cap_p;
  float lo = *lo_p, hi = *hi_p;
  float t = fminf(fmaxf(*tau0_p, lo), hi);
  const int blocks = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)blocks * kWarmThreads;
  const long long first = (long long)blockIdx.x * kWarmThreads + threadIdx.x;
  float y[kResident ? kWarmItems : 1];
  if constexpr (kResident) {
#pragma unroll
    for (int j = 0; j < kWarmItems; ++j) {
      const long long i = first + j * stride;
      // past n: -inf adds nothing to the mass and is never interior
      y[j] = i < n ? __fadd_rn(f[i], __fmul_rn(eta, c[i])) : __int_as_float(0xff800000);
    }
  }
  for (int s = 0; s < sweeps; ++s) {
    double m = 0.0;
    unsigned q = 0u;
    if constexpr (kResident) {
#pragma unroll
      for (int j = 0; j < kWarmItems; ++j) add_term(y[j], t, m, q);
    } else {
      for (long long i = first; i < n; i += stride) {
        add_term(__fadd_rn(f[i], __fmul_rn(eta, c[i])), t, m, q);
      }
    }
    // the block's partial: warps by butterflies, then warp 0 over the warps
    m = persistent::warp_sum(m);
    q = persistent::warp_sum(q);
    if (lane == 0) {
      sm[warp] = m;
      sq[warp] = q;
    }
    __syncthreads();
    double* pm = pmass + (long long)s * blocks;
    unsigned* pq = pcnt + (long long)s * blocks;
    if (warp == 0) {
      m = persistent::warp_sum(lane < kWarmWarps ? sm[lane] : 0.0);
      q = persistent::warp_sum(lane < kWarmWarps ? sq[lane] : 0u);
      if (lane == 0) {
        pm[blockIdx.x] = m;
        pq[blockIdx.x] = q;
      }
    }
    persistent::grid_barrier();
    // warp 0 sums the G partials in one fixed order, every load in flight
    // at once, takes the Newton step and hands the next tau to the block
    if (warp == 0) {
      m = 0.0;
      q = 0u;
      for (int b0 = lane; b0 < blocks; b0 += 32 * kWarmUnroll) {
        double vm[kWarmUnroll];
        unsigned vq[kWarmUnroll];
#pragma unroll
        for (int u = 0; u < kWarmUnroll; ++u) {
          const int b = b0 + 32 * u;
          vm[u] = b < blocks ? __ldcg(pm + b) : 0.0;
          vq[u] = b < blocks ? __ldcg(pq + b) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kWarmUnroll; ++u) {
          m += vm[u];
          q += vq[u];
        }
      }
      m = persistent::warp_sum(m);
      q = persistent::warp_sum(q);
      // the safeguarded Newton step, rounded as the plain version's 0-d ops
      const float mass = (float)m, cnt = (float)q;
      if (mass >= cap) {
        lo = t;
      } else {
        hi = t;
      }
      const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(mass, cap), fmaxf(cnt, 1.0f)));
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (lane == 0) next_t = (cnt > 0.0f && t_newton >= lo && t_newton <= hi) ? t_newton : t_mid;
    }
    __syncthreads();
    // next_t is written again only past the next barrier
    t = next_t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *tau_out = t;
  if (out == nullptr) return;
  if constexpr (kResident) {
#pragma unroll
    for (int j = 0; j < kWarmItems; ++j) {
      const long long i = first + j * stride;
      if (i < n) out[i] = fminf(fmaxf(__fsub_rn(y[j], t), 0.0f), 1.0f);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const float z = __fsub_rn(__fadd_rn(f[i], __fmul_rn(eta, c[i])), t);
      out[i] = fminf(fmaxf(z, 0.0f), 1.0f);
    }
  }
}

const void* warm_kernel(int resident) {
  return resident ? (const void*)project_warm_kernel<true>
                  : (const void*)project_warm_kernel<false>;
}

}  // namespace

// Blocks of the warm projection that one SM holds at once.
extern "C" int repro_project_warm_occupancy(int resident, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, warm_kernel(resident),
                                                            kWarmThreads, 0);
}

// pmass (double) and pcnt hold sweeps * blocks partials; the wrapper
// allocates them.  resident: y in registers, which needs
// n <= blocks * kWarmThreads * kWarmItems.  out: n floats for f', or null
// for tau alone.
extern "C" int repro_project_warm(const void* f, const void* c, const void* eta, const void* cap,
                                  const void* lo, const void* hi, const void* tau0, long long n,
                                  int sweeps, int blocks, int resident, void* pmass, void* pcnt,
                                  void* tau, void* out, void* stream) {
  if (blocks < 1 || sweeps < 0 ||
      (resident && n > (long long)blocks * kWarmThreads * kWarmItems)) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&f, &c, &eta, &cap, &lo, &hi, &tau0, &n, &sweeps, &pmass, &pcnt, &tau, &out};
  return persistent::launch(warm_kernel(resident), blocks, kWarmThreads, args,
                            static_cast<cudaStream_t>(stream));
}
"""


@functools.lru_cache(maxsize=None)
def earlier_entry():
    """The earlier design, built with the package's nvcc flags: its C entry
    point and its occupancy query."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mass_one_row.cu"
    src.write_text(EARLIER)
    lib = out_dir / "libmass_one_row.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.KERNELS_DIR / "csrc"), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    fn = so.repro_project_warm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    occ = so.repro_project_warm_occupancy
    occ.argtypes = [i, ctypes.POINTER(i)]
    occ.restype = i
    return fn, occ


def earlier_plan(torch, dev, n):
    """The earlier design's grid: every resident slot of the kernel that
    keeps y in registers if they hold the row, else of the streaming one."""
    _, occ = earlier_entry()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = []
    for resident in (1, 0):
        out = ctypes.c_int(0)
        if occ(resident, ctypes.byref(out)) != 0:
            raise RuntimeError("occupancy query failed")
        per.append(out.value)
    resident = n <= sms * per[0] * 1024 * 8
    return sms * (per[0] if resident else per[1]), resident


def earlier_tau(torch, f, counts, eta, cap, lo, hi, tau0, sweeps, plan):
    """One launch of the earlier design: tau of one row."""
    from repro_torch.kernels import _build

    blocks, resident = plan
    pmass = torch.empty(sweeps * blocks, dtype=torch.float64, device=f.device)
    pcnt = torch.empty(sweeps * blocks, dtype=torch.int32, device=f.device)
    tau = torch.empty((), dtype=torch.float32, device=f.device)
    fn, _ = earlier_entry()
    _build.check(fn(f.data_ptr(), counts.data_ptr(), eta.data_ptr(), cap.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), tau0.data_ptr(), f.numel(), sweeps, blocks,
                    int(resident), pmass.data_ptr(), pcnt.data_ptr(), tau.data_ptr(), None,
                    _build.stream_of(f)), "earlier project_warm")
    return tau


def random_rows(torch, dev, rows, n, seed=0):
    """Rows of a warm step drawn from a seed: f on [0, 2C/N), one histogram
    of n / 1000 ids, a combo's eta, capacity, bracket and seed each."""
    from repro_torch.jaxcache.fractional import warm_bracket_hi
    from repro_torch.kernels.scatter_counts.ops import histogram

    gen = torch.Generator().manual_seed(seed)
    caps = torch.tensor([n / 80.0 * (1 + r % 4) for r in range(rows)])
    f = torch.rand((rows, n), generator=gen) * (2.0 * caps[:, None] / n)
    b = max(1, n // 1000)
    ids = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32).to(dev)
    eta = 0.02 + 0.05 * torch.rand(rows, generator=gen)
    hi = warm_bracket_hi(eta * float(b))
    return (f.to(dev), histogram(ids, n), eta.to(dev), caps.to(dev),
            torch.zeros(rows, device=dev), hi.to(dev), (0.3 * hi).to(dev))


def time_solves(torch, dev, flush, rows):
    """Every case above, over ``rows``: (f (R, N), counts (N,), eta, cap,
    lo, hi, tau0 (R,)) with R >= max(ROWS).  Returns the cases by name."""
    from repro_torch.kernels.capped_simplex.ops import project_warm, project_warm_tau, warm_plan
    from repro_torch.kernels.capped_simplex.ref import project_warm_tau_ref
    from repro_torch.kernels import _build

    f, counts, eta, cap, lo, hi, tau0 = rows
    n = f.shape[1]
    out = {}
    one = [x[0] for x in (eta, cap, lo, hi, tau0)]
    f0 = f[0].contiguous()
    plan = earlier_plan(torch, dev, n)
    got = project_warm_tau(f0, counts, *one, SWEEPS)
    old = earlier_tau(torch, f0, counts, *one, SWEEPS, plan)
    want = project_warm_tau_ref(f0, counts, *one, SWEEPS)
    smoke.need(abs(float(got) - float(want)) <= 1e-6 and abs(float(old) - float(want)) <= 1e-6,
               f"warm solve, one row: {float(got)} and the earlier {float(old)} against plain "
               f"{float(want)}")

    def new_call():
        return project_warm_tau(f0, counts, *one, SWEEPS)

    def old_call():
        return earlier_tau(torch, f0, counts, *one, SWEEPS, plan)

    times = {"earlier": [], "current": []}
    for name in ("earlier", "current", "current", "earlier"):
        call = old_call if name == "earlier" else new_call
        times[name].append(smoke.timed_ms(torch, call, REPS, flush))
    cur, ear = sum(times["current"]) / 2, sum(times["earlier"]) / 2
    bound, by = smoke.bound_ms(8 * n, 9 * n * SWEEPS)
    print(f"warm solve, one row of N={n}, tau alone, cold in turns (earlier, current, current, "
          f"earlier): current {times['current'][0] * 1e3:.2f} / {times['current'][1] * 1e3:.2f} us, "
          f"earlier ({EARLIER_DESIGN}) {times['earlier'][0] * 1e3:.2f} / "
          f"{times['earlier'][1] * 1e3:.2f} us; current / earlier {cur / ear:.3f}; bound "
          f"{bound * 1e3:.3f} us by {by}")
    out["one_row"] = {"ms": cur, "earlier_ms": ear, "turns": times, "bound_ms": bound,
                      "bound_by": by, "earlier_design": EARLIER_DESIGN,
                      "max_abs_err": abs(float(got) - float(want))}
    sms = _build.sm_count(dev.index)
    per = [_build.blocks_per_sm("mass", "repro_project_warm_occupancy", dev.index, r)
           for r in (True, False)]
    for r in ROWS:
        args = (f[:r].contiguous(), counts, eta[:r], cap[:r], lo[:r], hi[:r], tau0[:r])
        design = warm_plan(n, SWEEPS, sms, *per, rows=r)["design"]
        got_f, got_tau = project_warm(*args, SWEEPS)
        tau_only = project_warm_tau(*args, SWEEPS)
        smoke.need(torch.equal(tau_only, got_tau), f"warm solve R={r}: tau differs with f'")
        err = 0.0
        for i in range(r):
            row = [x[i] for x in args[2:]]
            one_f, one_tau = project_warm(args[0][i].contiguous(), counts, *row, SWEEPS)
            smoke.need(torch.equal(one_tau, got_tau[i]) and torch.equal(one_f, got_f[i]),
                       f"warm solve R={r}: row {i} differs from its one-row launch")
            want = project_warm_tau_ref(args[0][i], counts, *row, SWEEPS)
            err = max(err, abs(float(want) - float(got_tau[i])))
        smoke.need(err <= 1e-6, f"warm solve R={r}: {err} from the plain version")
        rows_f = [args[0][i].contiguous() for i in range(r)]
        scal = [[x[i] for x in args[2:]] for i in range(r)]

        def singles(epilogue, rows_f=rows_f, scal=scal):
            fn = project_warm if epilogue else project_warm_tau
            for i in range(r):
                fn(rows_f[i], counts, *scal[i], SWEEPS)

        case = {"design": design, "max_abs_err": err}
        for epilogue in (False, True):
            fn = project_warm if epilogue else project_warm_tau
            ms = smoke.timed_ms(torch, lambda fn=fn: fn(*args, SWEEPS), REPS, flush)
            # the device held busy while the host enqueues all r launches
            single = smoke.timed_ms(torch, lambda e=epilogue: singles(e), REPS, flush,
                                    hold=smoke.HOLD_CYCLES * (1 + r))
            # bytes: each row of f and the one c read once (and f' written)
            bound, by = smoke.bound_ms(4 * r * n + 4 * n + (4 * r * n if epilogue else 0),
                                       9 * r * n * SWEEPS)
            key = "with_epilogue" if epilogue else "tau"
            case[key] = {"ms": ms, "singles_ms": single, "bound_ms": bound, "bound_by": by}
            print(f"warm solve R={r} x N={n} ({design}), "
                  f"{'with its f epilogue' if epilogue else 'tau alone'}: one launch cold "
                  f"{ms * 1e3:.2f} us, {r} one-row launches {single * 1e3:.2f} us "
                  f"({single / ms:.2f}x), bound {bound * 1e3:.3f} us by {by}")
        plain = smoke.timed_ms(torch, lambda: [project_warm_tau_ref(args[0][i], counts,
                                                                     *scal[i], SWEEPS)
                                               for i in range(r)], 3, flush)
        case["plain_ms"] = plain
        print(f"warm solve R={r}: each row bit for bit its one-row launch; tau within {err:.2e} "
              f"of the plain version, row by row {plain * 1e3:.2f} us")
        out[f"rows_{r}"] = case
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: time_warm_solves.py needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(smoke.nvidia_smi_line())
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        scratch.zero_()

    cases = time_solves(torch, dev, flush, random_rows(torch, dev, max(ROWS), 1_000_000))
    print(json.dumps(cases))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
