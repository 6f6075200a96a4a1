"""Deterministic sharded synthetic data: ``repro.train.data``, numpy only.

Counterpart of ``repro.train.data``, the same code, so a batch is bit for
bit the reference's: reproducible token streams (a per-step generator
seeded by (run seed, step, shard)), a cursor (``state_dict``) that a
checkpoint saves beside the model, and a Zipf mixture with local n-gram
structure, so that the loss actually decreases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    zipf_alpha: float = 1.1


class SyntheticLM:
    """Markov-ish synthetic language: next token depends on current token."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse transition structure: each token has a few likely successors
        self._succ = rng.integers(0, v, size=(v, 4))
        w = 1.0 / np.power(np.arange(1, v + 1), cfg.zipf_alpha)
        self._base_p = w / w.sum()

    def state_dict(self) -> Dict:
        return {"step": self.step}

    def load_state_dict(self, d: Dict) -> None:
        self.step = int(d["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b_local = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + self.step) * 97 + cfg.shard_id
        )
        toks = np.empty((b_local, cfg.seq_len + 1), np.int32)
        cur = rng.choice(cfg.vocab_size, size=b_local, p=self._base_p)
        toks[:, 0] = cur
        for t in range(1, cfg.seq_len + 1):
            use_markov = rng.random(b_local) < 0.75
            succ_pick = self._succ[cur, rng.integers(0, 4, size=b_local)]
            fresh = rng.choice(cfg.vocab_size, size=b_local, p=self._base_p)
            cur = np.where(use_markov, succ_pick, fresh).astype(np.int32)
            toks[:, t] = cur
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
