#!/usr/bin/env python3
"""Microseconds a request of the dense and the lazy replay, for one source tree.

    python3 tools/time_replays.py [--src DIR]

Run from the root of a checkout on one NVIDIA card.  It imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so two
trees, such as a change and its parent unpacked with ``git archive``, can be
timed one after the other in one call on one card.  Each run replays
chip_smoke.py's trace (zipf(0.8), N = 1e6, T = 1e7, C = 50 000, window 1000,
the Theorem 3.1 eta) through ``run(policy_def("ogb"))`` and
``run(policy_def("ogb_tree"))``, after a 20-chunk run of each that builds
the kernels.  It prints the card and its power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the directory that holds the repro_torch package to time")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs an NVIDIA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch import policy_def, run
    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta

    print(f"card: {smoke.nvidia_smi_line()}")
    trace = zipf(smoke.N, smoke.T, alpha=smoke.ALPHA, seed=0)
    eta = theoretical_eta(smoke.C, smoke.N, smoke.T, 1)
    out = {"src": str(args.src), "package": repro_torch.__file__,
           "device": torch.cuda.get_device_name(0)}
    for kind in ("ogb", "ogb_tree"):
        pd = policy_def(kind)
        run(pd, trace[: 20 * smoke.W], smoke.N, smoke.C, window=smoke.W, eta=eta)
        res = run(pd, trace, smoke.N, smoke.C, window=smoke.W, eta=eta)
        out[kind] = {"us_per_request": res.us_per_request, "wall_s": res.wall_seconds,
                     "hit_ratio": res.hit_ratio}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
