"""Serving launcher: batched generation with the OGB page pool.

    python -m repro_torch.launch.serve --arch <id> [--policy ogb|lru]
           [--steps N] [--batch B] [--prompt-len L] [--pool-pages C]
           [--device cuda|cpu]

The counterpart of ``python -m repro.launch.serve``, with its flags: the
smoke configuration of ``--arch`` (a dense model such as mistral-nemo, the
MoE granite-moe and kimi-k2, phi-3-vision on text-only prompts, the SSM
rwkv6-1.6b, whose prefill and decode steps run its recurrence through the
``wkv6`` kernel on the card, or the hybrid jamba-1.5-large-398b, whose
Mamba layers run their scan through the ``selective_scan`` kernel) with
random weights drawn from seed 0, half of each batch drawn from a few hot
prompts.  It runs on the card unless ``--device cpu`` is given.  whisper
needs audio frames, which a token prompt does not carry: its prefill
raises a ``ValueError`` naming them (serve it through ``prefill`` and
``decode_step``).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import make_policy
from repro_torch.models.model import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="ogb")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--hot-prompts", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    params = init_params(cfg, seed=0, device=args.device)
    touches = args.steps * args.batch * (args.prompt_len // args.page_size)
    kw = {}
    if args.policy == "ogb":
        kw = {"horizon": touches, "batch_size": args.batch * (args.prompt_len // args.page_size)}
    policy = make_policy(args.policy, 1 << 18, args.pool_pages, **kw)
    pool = PagedKVPool(policy, page_size=args.page_size)
    engine = ServeEngine(cfg, params, pool=pool, max_len=args.prompt_len + args.new_tokens,
                         device=args.device)

    rng = np.random.default_rng(0)
    hot = [rng.integers(1, cfg.vocab_size, args.prompt_len) for _ in range(args.hot_prompts)]
    for step in range(args.steps):
        prompts = []
        for b in range(args.batch):
            if b < args.batch // 2:
                prompts.append(hot[(step + b) % len(hot)])
            else:
                prompts.append(rng.integers(1, cfg.vocab_size, args.prompt_len))
        engine.generate(np.stack(prompts).astype(np.int32), args.new_tokens)
        if (step + 1) % 10 == 0:
            s, p = engine.stats, pool.stats
            print(
                f"[serve] step {step+1:>4} prefix-reuse {s.prefix_reuse:6.1%} "
                f"page-hits {p.page_hit_ratio:6.1%} occupancy {pool.occupancy():.0f}"
            )
    s = engine.stats
    print(
        f"[serve] done: {s.requests} requests, {s.decode_tokens} tokens decoded, "
        f"prefix reuse {s.prefix_reuse:.1%} with policy={args.policy} on {engine.device}"
    )


if __name__ == "__main__":
    main()
