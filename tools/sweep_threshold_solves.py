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
  the plain version's, bit for bit.

It prints the card and its power limit first, one line a grid, and a JSON
line of every time last.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 30


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

    print(json.dumps({"card": smoke.nvidia_smi_line(), "sweeps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
