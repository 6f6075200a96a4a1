"""The batched serving engine: prefix matching, prefill, greedy decode.

Counterpart of ``repro.serve.engine.ServeEngine``.  One ``generate`` call
serves a batch of requests in four steps:
  1. prefix-match each prompt against the page pool (tokens already cached
     count as reused; the pool is frozen during the step),
  2. prefill the prompts (``models.model.prefill``, through the flash-prefill
     kernel on the card),
  3. decode greedily for ``max_new_tokens`` (``decode_step``, through the
     flash-decode kernel),
  4. feed the page touches to the residency policy and call ``batch_end()``
     (the paper's Algorithm 3 cadence).

The weights are cast to the compute type once, when the engine is built.
Tokens stay on the device until the step ends; on the card each phase ends
in a synchronize, so ``EngineStats`` holds device-complete wall times.
``ContinuousServingLoop`` and ``ServingSLO`` are not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.model import cast_params_for_compute, decode_step, prefill

from .kvcache import PagedKVPool


@dataclass
class EngineStats:
    requests: int = 0
    prefill_tokens: int = 0
    prefill_tokens_skipped: int = 0
    decode_tokens: int = 0
    wall_prefill: float = 0.0
    wall_decode: float = 0.0

    @property
    def prefix_reuse(self) -> float:
        return self.prefill_tokens_skipped / max(self.prefill_tokens, 1)


class ServeEngine:
    def __init__(self, cfg, params, pool: Optional[PagedKVPool] = None, max_len: int = 256,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters are on {params['embed'].device}, not {self.device}")
        self.params = cast_params_for_compute(cfg, params)
        self.pool = pool
        self.max_len = max_len
        self.stats = EngineStats()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1)

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16) -> np.ndarray:
        """prompts: (B, S) int32. Greedy decode. Returns (B, max_new_tokens) int32."""
        B, S = prompts.shape
        self.stats.requests += B
        self.stats.prefill_tokens += B * S

        # 1) prefix-cache consultation (the page pool is frozen during the step)
        if self.pool is not None:
            for b in range(B):
                self.stats.prefill_tokens_skipped += int(self.pool.match_prefix(list(prompts[b])))

        # 2) prefill (whole prompts are recomputed; reuse is the telemetry)
        t0 = time.perf_counter()
        tokens = torch.from_numpy(np.ascontiguousarray(prompts)).to(self.device)
        logits, cache = prefill(self.cfg, self.params, {"tokens": tokens}, self.max_len,
                                self.device)
        self._sync()
        self.stats.wall_prefill += time.perf_counter() - t0

        # 3) greedy decode; the tokens come to the host once, at the end
        t0 = time.perf_counter()
        tok = self._greedy(logits)
        out = []
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(self.cfg, self.params, cache, tok, self.device)
            tok = self._greedy(logits)
        result = (torch.stack(out, dim=1) if out else tok.new_empty((B, 0)))
        result = result.to(torch.int32).cpu().numpy()
        self.stats.decode_tokens += B * max_new_tokens
        self.stats.wall_decode += time.perf_counter() - t0

        # 4) page-touch accounting + batched policy update
        if self.pool is not None:
            for b in range(B):
                self.pool.serve(list(prompts[b]))
            self.pool.batch_end()
        return result
