"""OGB expert residency for MoE serving: which (layer, expert) pairs stay in HBM.

Counterpart of ``repro.serve.expert_cache``.  The catalog is the L * E
(layer, expert) pairs; a serving step's routed-token counts are the
gradient of the linear reward (an expert "hit" is the tokens it serves
from HBM instead of a fetch from the host).  The policy is the registered
``ogb_grad`` :class:`~repro_torch.cachesim.api.PolicyDef`, stepped one
serving step at a time through the carry: ``carry, out = step(carry,
counts)``.  Residency is the coordinated Poisson sample ``f >= p`` over the
carried permanent random numbers, so consecutive steps swap only
O(changed mass) experts (the paper's positive coordination).  By Theorem
3.1 the expert-fetch traffic is asymptotically no worse than the best
static placement in hindsight, for any routing pattern.

On the card a step is the policy's ``iters`` ``masses`` launches and one
``apply``, the residency masks and their diff stay on the device, and the
step's numbers come to the host in one read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.cachesim.api import OGBCarry, policy_def
from repro_torch.jaxcache.fractional import poisson_sample


@dataclass
class ExpertCacheConfig:
    n_layers: int
    n_experts: int
    resident_fraction: float = 0.25  # fraction of experts held in HBM
    eta: Optional[float] = None
    horizon_steps: int = 10_000
    bytes_per_expert: int = 0  # telemetry


class OGBExpertCache:
    """Streaming ``ogb_grad`` policy and Poisson residency over L * E experts.

    ``device`` is the card unless the caller asks for ``"cpu"``.  ``carry``,
    where given, is the :class:`~repro_torch.cachesim.api.OGBCarry` to start
    from (as :func:`~repro_torch.cachesim.api.carry_from_numpy` makes it
    from the reference's, with its permanent random numbers); its eta
    stands in for the configured one."""

    def __init__(self, cfg: ExpertCacheConfig, seed: int = 0, device: DeviceLike = None,
                 carry: Optional[OGBCarry] = None):
        self.cfg = cfg
        n = cfg.n_layers * cfg.n_experts
        self.N = n
        self.C = max(1, int(round(n * cfg.resident_fraction)))
        pd = policy_def("ogb_grad")
        if carry is not None:
            if carry.catalog_size != n:
                raise ValueError(f"the carry holds {carry.catalog_size} experts, not {n}")
            self.device = carry.device
            self.carry = carry
            self.eta = float(carry.eta)
        else:
            self.device = resolve_device(device)
            if cfg.eta is None:
                # Theorem 3.1 with B = 1 policy step per serving step
                self.eta = float(np.sqrt(self.C * (1 - self.C / n) / cfg.horizon_steps))
            else:
                self.eta = cfg.eta
            self.carry = pd.init(n, self.C, seed=seed, eta=self.eta, device=self.device)
        self._step = pd.step
        self._mask = poisson_sample(self.carry.f, self.carry.p)
        self._resident: Optional[np.ndarray] = None
        self.steps = 0
        self.swapped_in = 0
        self.swapped_out = 0
        self.hits_weighted = 0.0
        self.total_weighted = 0.0

    @property
    def resident(self) -> np.ndarray:
        """The current Poisson residency mask (L * E,) on the host: the one
        residency rule (``f >= p``) over the carried state, read from the
        device when first asked for after a step."""
        if self._resident is None:
            self._resident = poisson_sample(self.carry.f, self.carry.p).cpu().numpy()
        return self._resident

    def step(self, expert_counts) -> Dict[str, float]:
        """expert_counts: (L, E) routed-token counts from the router.

        ``swapped_in``/``swapped_out`` are the residency churn, the diff of
        consecutive Poisson masks (not the hit count); ``hits`` counts the
        requested experts resident before the step; ``bytes_per_expert``
        scales churn into ``swap_bytes`` and ``resident_bytes``."""
        counts = torch.as_tensor(np.asarray(expert_counts, np.float32).reshape(-1),
                                 device=self.device)
        prev = self._mask
        self.carry, out = self._step(self.carry, counts)
        new = poisson_sample(self.carry.f, self.carry.p)
        self._mask, self._resident = new, None
        stats = torch.stack([
            out.reward.double(), out.hits.double(), out.occupancy.double(),
            torch.sum(new & ~prev).double(), torch.sum(prev & ~new).double(),
            torch.sum(new).double(),
        ]).tolist()  # the step's one read
        reward, hits, occupancy, s_in, s_out, n_resident = stats
        s_in, s_out = int(s_in), int(s_out)
        self.steps += 1
        self.swapped_in += s_in
        self.swapped_out += s_out
        self.hits_weighted += reward
        self.total_weighted += 1.0
        bpe = int(self.cfg.bytes_per_expert)
        return {
            "resident_hit_ratio": reward,
            "hits": int(hits),
            "swapped_in": s_in,
            "swapped_out": s_out,
            "occupancy": int(occupancy),
            "swap_bytes": (s_in + s_out) * bpe,
            "resident_bytes": int(n_resident) * bpe,
        }

    def resident_mask(self) -> np.ndarray:
        return self.resident.reshape(self.cfg.n_layers, self.cfg.n_experts)

    @property
    def mean_hit_ratio(self) -> float:
        return self.hits_weighted / max(self.total_weighted, 1.0)
