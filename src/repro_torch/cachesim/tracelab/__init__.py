"""Tracelab, copied from ``repro.cachesim.tracelab``: so far the
stats-matched workload synthesizer (:mod:`.synth`), which the ``real_like``
trace family draws from.  The on-disk loaders, the catalog remapper and the
out-of-core streaming replay wait for the stream slice.
"""

from repro_torch.cachesim.tracelab.synth import (
    TraceProfile,
    fit_profile,
    synthesize,
    synthesize_chunks,
    synthesize_sizes,
)

__all__ = [
    "TraceProfile",
    "fit_profile",
    "synthesize",
    "synthesize_chunks",
    "synthesize_sizes",
]
