"""Training launcher.

    python -m repro_torch.launch.train --arch <id> [--smoke | --full [--depth L]]
           [--steps N] [--seq-len S] [--global-batch B] [--microbatches K]
           [--lr LR] [--ckpt-dir DIR] [--ckpt-every N] [--device cuda|cpu]

The counterpart of ``python -m repro.launch.train``, with its flags: the
smoke configuration of ``--arch`` (or with ``--full`` its full one, cut to
``--depth`` layers, and as many encoder layers for an encoder-decoder),
random weights drawn from seed 0, ``SyntheticLM`` batches, AdamW with a
tenth of the steps as warm-up, an async checkpoint every ``--ckpt-every``
steps and a resume from the latest one in ``--ckpt-dir``, and a straggler
monitor.  It runs on the card unless ``--device cpu`` is given, and prints
the loss and the gradient norm every 10 steps and at the last, with the
step's seconds.  The attention families (dense, moe, vlm, encdec) and the
ssm family train: on the card ``--arch gemma-7b --full --depth 4
--microbatches 4`` (head_dim 256) and ``--arch rwkv6-1.6b --full`` (all 24
layers) with ``--seq-len 4096 --global-batch 4``.  jamba raises
``NotImplementedError`` (its scan kernel has no backward yet).
``--mesh-data`` and ``--mesh-model`` raise: distributed training is not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.dist.fault import StragglerMonitor
from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import create_train_state, make_train_step


def config(arch: str, smoke: bool, depth: int = 0):
    """The smoke configuration of ``arch``, or its full one with ``depth``
    layers (and encoder layers) kept where ``depth`` is given."""
    cfg = get_smoke(arch) if smoke else get_arch(arch)
    if depth and not smoke:
        cut = {"n_layers": depth}
        if cfg.family == "encdec":
            cut["n_encoder_layers"] = depth
        cfg = dataclasses.replace(cfg, **cut)
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--depth", type=int, default=0, help="layers kept of a --full configuration")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh_data or args.mesh_model:
        raise NotImplementedError("--mesh-data/--mesh-model: distributed training is not ported")

    dev = resolve_device(args.device)
    cfg = config(args.arch, args.smoke, args.depth)
    opt_cfg = OptimizerConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps
    )
    state = create_train_state(cfg, opt_cfg, seed=0, device=dev)
    data = SyntheticLM(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            global_batch=args.global_batch,
        )
    )
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StragglerMonitor()

    start = 0
    if ckpt and latest_step(args.ckpt_dir) is not None:
        state, start, extra = restore_checkpoint(args.ckpt_dir, state)
        data.load_state_dict(extra)
        print(f"[train] resumed at step {start}")

    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data.next_batch())
            loss = float(metrics["loss"])  # waits for the step
            seconds = time.perf_counter() - t0
            if not math.isfinite(loss):
                raise FloatingPointError(f"step {step}: the loss is {loss}")
            straggle = monitor.observe(step, seconds)
            if step % 10 == 0 or step == args.steps - 1:
                print(
                    f"[train] step {step:>5} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {seconds:.3f} s"
                    + (" STRAGGLER" if straggle else "")
                )
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, extra=data.state_dict())
    finally:
        if ckpt:
            ckpt.wait()
    if dev.type == "cuda":
        print(f"[train] peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB on "
              f"{torch.cuda.get_device_name(dev)}")
    print("[train] done")


if __name__ == "__main__":
    main()
