"""OMD — no-regret caching via Online Mirror Descent (Si Salem et al. 2021).

Copied from ``repro.core.omd``: the learning rate only.  The device step
(log-weight ascent and the KL projection onto the capped simplex) is
:func:`repro_torch.cachesim.engines._make_omd_step`.
"""

from __future__ import annotations

import math


def theoretical_eta_omd(C: int, N: int, T: int, B: int = 1) -> float:
    """Learning rate balancing the neg-entropy Bregman diameter C log(N/C)
    against the summed local-norm gradient bound (M chunks of B unit
    rewards, sum_i c_i^2 f_i <= B^2):

        regret <= C log(N/C)/eta + eta M B^2 / 2
        eta*   =  sqrt(2 C log(N/C) / (T B))

    which recovers Si Salem et al.'s O(sqrt(T C log(N/C))) regret rate.
    """
    log_ratio = max(math.log(N / max(C, 1)), 1e-12)
    return math.sqrt(2.0 * C * log_ratio / (T * B))
