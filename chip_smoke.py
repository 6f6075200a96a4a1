#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit, and builds the kernels from the checkout's sources on first use
(into build/repro_torch/).  Phases, in order; the first failure stops the
script with a non-zero exit:

1. versions, and the card's name and power limit (nvidia-smi);
2. build every kernel;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (N = 1e6 items, B = 1000 ids, mass at K = 1 and 64), and
   its time beside its bound, the plain version's and a library call's;
4. the main path: run(policy_def("ogb")) over zipf(0.8) with N = 1e6,
   T = 1e7, C = 50 000, window 1000, with every kernel's launches counted;
5. the card against the CPU (the plain versions) over the first 200 chunks;
6. resume: 2000 chunks in two calls equal one call, bit for bit;
7. where a chunk's time goes, from torch.profiler over 300 chunks.

The line before the last is the card and its power limit again, preceded
by one JSON line of per-kernel numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, T, C, W = 1_000_000, 10_000_000, 50_000, 1000
ALPHA = 0.8
CPU_CHUNKS, RESUME_CHUNKS, PROFILE_CHUNKS = 200, 2000, 300
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
MASS_TOL = 1e-6 * N  # float32 summation order over N items
HOLD_CYCLES = 2_000_000  # about 1 ms of device time at the H100's clock
REPLACES = {
    "histogram": "src/repro/kernels/scatter_counts/kernel.py:28",
    "mass": "src/repro/kernels/capped_simplex/kernel.py:59",
    "apply": "src/repro/kernels/capped_simplex/kernel.py:97",
}
SOURCES = {
    "histogram": "src/repro_torch/kernels/scatter_counts/csrc/histogram.cu",
    "mass": "src/repro_torch/kernels/capped_simplex/csrc/mass.cu",
    "apply": "src/repro_torch/kernels/capped_simplex/csrc/apply.cu",
}


class Failed(Exception):
    pass


def need(cond, what):
    if not cond:
        raise Failed(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes, n_ops):
    """The least time for the work: bytes over HBM rate or ops over fp32 peak."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timed_ms(torch, fn, reps, flush=None):
    """Mean device time of one fn() call, by CUDA events around each call.

    Before each call the device is held busy (torch.cuda._sleep) until the
    host has enqueued the whole call, so the events time the device and not
    the host's launch overhead.  Cold (L2 flushed before each call) when
    ``flush`` is given, else warm in L2 from the previous call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def root_tau(y, cap):
    """The tau with sum(clip(y - tau, 0, 1)) = cap, by float64 bisection."""
    import numpy as np

    lo, hi = float(y.min()) - 1.0, float(y.max())
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if np.clip(y - mid, 0.0, 1.0).sum() >= cap:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def check_kernels(torch, dev, trace, eta):
    """Phase 3: each kernel against its plain version, then timings."""
    from repro_torch.kernels.capped_simplex.ops import apply, masses
    from repro_torch.kernels.capped_simplex.ref import apply_ref, masses_ref
    from repro_torch.kernels.scatter_counts.ops import histogram
    from repro_torch.kernels.scatter_counts.ref import histogram_ref

    gen = torch.Generator().manual_seed(1)
    f = (torch.rand(N, generator=gen) * (2.0 * C / N)).to(dev)
    ids = torch.from_numpy(trace[:W].astype("int32")).to(dev)
    eta_t = torch.tensor(eta, dtype=torch.float32, device=dev)
    counts = histogram(ids, N)
    want = histogram_ref(ids, N)
    need(torch.equal(counts, want), "histogram differs from its plain version")
    print(f"histogram: exact ({int(counts.gt(0).sum())} distinct ids of {W})")

    # Thresholds inside the range of y = f + eta * counts, so that every
    # check sees items on each side of the clip: the projection's root for
    # (f, counts), and K = 64 spread over [0, max(y)].
    y = (f.double() + eta * counts.double()).cpu().numpy()
    tau_root = root_tau(y, C)
    taus = {1: torch.tensor([tau_root], dtype=torch.float32, device=dev),
            64: torch.linspace(0.0, float(y.max()), 64, device=dev)}
    print(f"thresholds: max y {y.max():.6f}, root tau {tau_root:.9e}")
    errs = {}
    for k, tk in taus.items():
        mass, cnt = masses(f, counts, eta_t, tk)
        rmass, rcnt = masses_ref(f, counts, eta_t, tk)
        need(bool(mass[0] > 0) and bool(cnt.gt(0).any()),
             f"mass K={k}: no mass or no interior item, the check would be vacuous")
        need(torch.equal(cnt, rcnt), f"mass K={k}: interior counts differ")
        err = float((mass.double() - rmass.double()).abs().max())
        need(err <= MASS_TOL, f"mass K={k}: |mass - plain| = {err} > {MASS_TOL}")
        errs[k] = err
        print(f"mass K={k}: counts exact (interior {int(cnt.max())} items at most), "
              f"max |mass - plain| = {err:.3e} (limit {MASS_TOL:.1e})")
    root_mass = float(masses(f, counts, eta_t, taus[1])[0][0])
    need(abs(root_mass - C) <= MASS_TOL, f"mass at the root tau is {root_mass}, not C = {C}")
    tau = taus[1][0]
    out = apply(f, counts, eta_t, tau)
    need(torch.equal(out, apply_ref(f, counts, eta_t, tau)), "apply differs from its plain version")
    kept, total = int(out.gt(0).sum()), float(out.double().sum())
    need(kept > 0 and abs(total - C) <= MASS_TOL, f"apply kept {kept} items, sum {total}, not C")
    print(f"apply: exact ({kept} items above 0, sum {total:.6f}; mass at root {root_mass:.6f})")

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    ids64 = ids.long()
    t1 = taus[1]
    jobs = {
        "histogram": (lambda: histogram(ids, N), lambda: histogram_ref(ids, N),
                      lambda: torch.bincount(ids64, minlength=N)),
        "mass": (lambda: masses(f, counts, eta_t, t1), lambda: masses_ref(f, counts, eta_t, t1),
                 None),
        "apply": (lambda: apply(f, counts, eta_t, tau), lambda: apply_ref(f, counts, eta_t, tau),
                  None),
    }
    bounds = {
        # ids read, the dense counts written; the B atomic adds are no bound
        "histogram": bound_ms(4 * W + 4 * N, W),
        # f and counts read, taus read, mass and cnt written; 2 + 7K ops per item
        "mass": bound_ms(8 * N + 12, N * (2 + 7 * 1)),
        # f and counts read, f' written; 5 ops per item
        "apply": bound_ms(12 * N + 8, 5 * N),
    }
    rows = {}
    for name, (kern, plain, lib) in jobs.items():
        ms = timed_ms(torch, kern, 50, flush)
        warm = timed_ms(torch, kern, 50)
        plain_ms = timed_ms(torch, plain, 20, flush)
        lib_ms = timed_ms(torch, lib, 20, flush) if lib else None
        b, by = bounds[name]
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": lib_ms, "max_abs_err": errs[1] if name == "mass" else 0.0}
        lib_s = f", library {lib_ms * 1e3:.2f} us" if lib else ""
        print(f"{name}: cold {ms * 1e3:.2f} us, warm in L2 {warm * 1e3:.2f} us "
              f"(plain {plain_ms * 1e3:.2f} us{lib_s}, bound {b * 1e3:.3f} us by {by})")
    t64 = taus[64]
    ms64 = timed_ms(torch, lambda: masses(f, counts, eta_t, t64), 50, flush)
    plain64 = timed_ms(torch, lambda: masses_ref(f, counts, eta_t, t64), 10, flush)
    b64, by64 = bound_ms(8 * N + 12 * 64, N * (2 + 7 * 64))
    print(f"mass K=64: cold {ms64 * 1e3:.2f} us (plain {plain64 * 1e3:.2f} us, "
          f"bound {b64 * 1e3:.3f} us by {by64}), max |mass - plain| = {errs[64]:.3e}")
    return rows


def check_main_path(torch, trace, eta):
    """Phase 4: the main path, every launch counted."""
    import numpy as np

    from repro_torch import policy_def, run
    from repro_torch.kernels import launch_counts, reset_launch_counts

    pd = policy_def("ogb")
    reset_launch_counts()
    res = run(pd, trace, N, C, window=W)
    launches = launch_counts()
    m = T // W
    want = {"histogram": m, "mass": 5 * m, "apply": m}
    f = res.final_f.astype(np.float64)
    print(f"main path: hit_ratio {res.hit_ratio}, frac_hit_ratio {res.frac_hit_ratio}, "
          f"regret {res.regret}, opt_hits {res.opt_hits}, us_per_request "
          f"{res.us_per_request}, wall {res.wall_seconds} s, sum f {f.sum()}, "
          f"eta {res.extras['eta']}, launches {launches}")
    need(res.extras["eta"] == eta, "main path resolved another eta")
    need(launches == want, f"launches {launches}, expected {want}")
    need(np.all(np.isfinite(res.reward)) and np.all(np.isfinite(res.aux)), "non-finite output")
    need(f.min() >= 0.0 and f.max() <= 1.0, "final f leaves [0, 1]")
    need(abs(f.sum() - C) <= 1e-4 * C, f"sum f = {f.sum()} is not C = {C}")
    need(0.0 < res.hit_ratio < 1.0, f"hit ratio {res.hit_ratio} out of range")
    return launches


def check_card_against_cpu(trace, eta):
    """Phase 5: the same chunks through the kernels and the plain versions."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb")
    part = trace[: CPU_CHUNKS * W]
    card = run(pd, part, N, C, window=W, eta=eta)
    cpu = run(pd, part, N, C, window=W, eta=eta, device="cpu")
    dtau = float(np.abs(card.aux - cpu.aux).max())
    drew = float(np.max(np.abs(card.reward - cpu.reward) / np.abs(cpu.reward)))
    dhits = abs(int(card.hits.sum()) - int(cpu.hits.sum()))
    print(f"card vs CPU, {CPU_CHUNKS} chunks: max |dtau| {dtau:.3e}, max reward rel "
          f"{drew:.3e}, hits {int(card.hits.sum())} vs {int(cpu.hits.sum())}")
    need(dtau <= 1e-6, f"card and CPU tau differ by {dtau}")
    need(drew <= 1e-5, f"card and CPU reward differ by {drew} relative")
    need(dhits <= len(part) // 10_000, f"card and CPU hits differ by {dhits}")


def check_resume(torch, trace, eta):
    """Phase 6: two calls equal one, bit for bit."""
    import numpy as np

    from repro_torch import policy_def, run

    pd = policy_def("ogb")
    part = trace[: RESUME_CHUNKS * W]
    half = len(part) // 2
    whole = run(pd, part, N, C, window=W, eta=eta)
    first = run(pd, part[:half], N, C, window=W, eta=eta)
    second = run(pd, part[half:], capacity=C, window=W, carry=first.carry)
    for name in ("reward", "hits", "aux", "occupancy"):
        joined = np.concatenate([getattr(first, name), getattr(second, name)])
        need(np.array_equal(joined, getattr(whole, name)), f"resume: {name} differs")
    need(all(torch.equal(a, b) for a, b in zip(second.carry, whole.carry)), "resume: carry differs")
    print(f"resume: {RESUME_CHUNKS} chunks in two calls == one call, bit for bit")


def breakdown(torch, trace, eta):
    """Phase 7: device busy share and kernel time by name over a short run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import policy_def, run

    pd = policy_def("ogb")
    part = trace[: PROFILE_CHUNKS * W]
    plain = run(pd, part, N, C, window=W, eta=eta)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = run(pd, part, N, C, window=W, eta=eta)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / PROFILE_CHUNKS
    launches = sum(e.count for e in rows) / PROFILE_CHUNKS
    wall_us = plain.wall_seconds * 1e6 / PROFILE_CHUNKS
    prof_wall_us = profiled.wall_seconds * 1e6 / PROFILE_CHUNKS
    need(busy_us > 0, "breakdown: the profiler saw no device time")
    print(f"breakdown, {PROFILE_CHUNKS} chunks: wall {wall_us:.1f} us/chunk "
          f"(profiled {prof_wall_us:.1f}), device busy {busy_us:.1f} us/chunk, "
          f"{launches:.1f} device kernels/chunk, device idle share "
          f"{1 - busy_us / wall_us:.3f} (profiled {1 - busy_us / prof_wall_us:.3f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / PROFILE_CHUNKS:8.2f} us/chunk "
              f"{e.count / PROFILE_CHUNKS:6.2f}/chunk  {e.key[:90]}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    card = nvidia_smi_line()
    print(f"python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    _libs, logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s, {sorted(_libs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    trace = zipf(N, T, alpha=ALPHA, seed=0)
    print(f"trace: zipf N={N} T={T} alpha={ALPHA}, {time.perf_counter() - t0:.2f} s")
    eta = theoretical_eta(C, N, T, 1)

    rows = check_kernels(torch, dev, trace, eta)
    launches = check_main_path(torch, trace, eta)
    check_card_against_cpu(trace, eta)
    check_resume(torch, trace, eta)
    breakdown(torch, trace, eta)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in ("histogram", "mass", "apply")
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
