"""Serving engines: batched prefill/decode and the continuous open loop.

Counterpart of ``repro.serve.engine``.  :class:`ServeEngine`: one
``generate`` call serves a batch of requests in four steps:
  1. prefix-match each prompt against the page pool (tokens already cached
     count as reused; the pool is frozen during the step),
  2. prefill the prompts (``models.model.prefill``, through the flash-prefill
     kernel on the card),
  3. decode greedily for ``max_new_tokens`` (``decode_step``, through the
     flash-decode kernel),
  4. feed the page touches to the residency policy and call ``batch_end()``
     (the paper's Algorithm 3 cadence).

The engine passes only tokens, as ``repro``'s does: it serves the dense
and MoE models (mistral-nemo with its int8 KV cache), phi-3-vision on
text-only prompts, rwkv6 (its cache is the recurrent state, the steps
launch the ``wkv6`` kernel in place of the attention kernels) and jamba
(its Mamba layers' states beside its attention layers' K and V, a
``selective_scan`` launch a Mamba layer); whisper's prefill needs ``frames`` and raises a
``ValueError`` without them.  The weights are cast to the compute type
once, when the engine is built.
Tokens stay on the device until the step ends; on the card each phase ends
in a synchronize, so ``EngineStats`` holds device-complete wall times.

:class:`ContinuousServingLoop`: the continuous regime.  Requests arrive on
their own clock (open loop: arrivals do not wait for the server, so a slow
decision builds a backlog that adds to the next request's latency), the
loop batches whatever has arrived, makes one decision a batch (an
:class:`~repro_torch.serve.expert_cache.OGBExpertCache` step, a resumed
``run`` window) and records each request's latency from its arrival to the
end of the decision that covered it.  :class:`ServingSLO` holds p50/p99
latency and sustained requests a second.  Host code, copied from the
reference with its injectable ``clock`` and ``sleep``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.model import cast_params_for_compute, decode_step, prefill

from .kvcache import PagedKVPool


@dataclass
class ServingSLO:
    """The latency-SLO record of one continuous-serving run.

    ``latencies_ms`` holds one entry a request: the time from its open-loop
    arrival to the end of the decision that covered it, queueing included.
    ``req_per_sec`` is sustained throughput over the makespan (first
    arrival to last decision), not the offered rate."""

    requests: int
    steps: int  # decision batches dispatched
    seconds: float  # makespan: first arrival -> last decision complete
    req_per_sec: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    backlog_max: int  # deepest arrival backlog observed
    latencies_ms: np.ndarray = field(repr=False, default=None)

    @classmethod
    def from_latencies(cls, lat_s: np.ndarray, seconds: float, steps: int,
                       backlog_max: int) -> "ServingSLO":
        lat_ms = np.asarray(lat_s, np.float64) * 1e3
        return cls(
            requests=len(lat_ms),
            steps=steps,
            seconds=float(seconds),
            req_per_sec=len(lat_ms) / max(seconds, 1e-12),
            p50_ms=float(np.percentile(lat_ms, 50)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            mean_ms=float(np.mean(lat_ms)),
            max_ms=float(np.max(lat_ms)),
            backlog_max=int(backlog_max),
            latencies_ms=lat_ms,
        )


class ContinuousServingLoop:
    """Open-loop continuous serving: arrivals on a clock, decisions batched.

    ``decide(batch)`` is the cache decision a step, called with a list of
    up to ``batch_max`` arrived payloads.  The loop is host-driven and
    single-threaded: what it measures is how long a decision takes under
    sustained arrivals.  ``clock``/``sleep`` are injectable for
    deterministic tests."""

    def __init__(self, decide, *, batch_max: int = 1, clock=None, sleep=None):
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        self.decide = decide
        self.batch_max = int(batch_max)
        self.clock = clock or time.perf_counter
        self.sleep = sleep or time.sleep

    def run(self, payloads: Sequence, rate: float) -> ServingSLO:
        """Serve ``payloads`` arriving open-loop at ``rate`` requests/sec:
        request ``i`` arrives ``i / rate`` seconds after the start, whether
        or not the server has kept up, and its latency runs to the end of
        the decision batch that included it."""
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        n = len(payloads)
        arrivals = np.arange(n, dtype=np.float64) / float(rate)
        lat = np.empty(n, np.float64)
        t0 = self.clock()
        served = steps = backlog_max = 0
        while served < n:
            now = self.clock() - t0
            if arrivals[served] > now:  # open loop: idle until the next arrival
                self.sleep(min(arrivals[served] - now, 0.01))
                continue
            # everything that has arrived is backlog; take one batch of it
            arrived = int(np.searchsorted(arrivals, now, side="right"))
            backlog_max = max(backlog_max, arrived - served)
            take = min(arrived - served, self.batch_max)
            self.decide(list(payloads[served:served + take]))
            done = self.clock() - t0
            lat[served:served + take] = done - arrivals[served:served + take]
            served += take
            steps += 1
        makespan = self.clock() - t0
        return ServingSLO.from_latencies(lat, makespan, steps, backlog_max)


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
