"""Tracelab, counterpart of ``repro.cachesim.tracelab``: real-trace
ingestion and out-of-core streaming replay.

* :mod:`.loaders`: streaming readers for the on-disk trace formats (CSV/TSV
  key-value traces, whitespace ``timestamp id size`` CDN logs, raw binary
  uint32/uint64 id streams), chunk by chunk, the whole trace never in
  memory;
* :mod:`.catalog`: :class:`CatalogRemap`, sparse raw ids to a dense
  ``0..N-1`` catalog in first-seen order, streaming;
* :mod:`.synth`: the stats-matched workload synthesizer, which the
  ``real_like`` trace family draws from, and :func:`tenant_streams` for
  fleets;
* :mod:`.stream`: :func:`run_stream`, any
  :class:`~repro_torch.cachesim.api.PolicyDef` over any chunk iterator in
  memory independent of the trace length, bit for bit a one-shot ``run``,
  with a background ingest thread ahead of the card.
"""

from repro_torch.cachesim.tracelab.catalog import CatalogRemap, remap_trace
from repro_torch.cachesim.tracelab.loaders import (
    TRACE_FORMATS,
    load_trace,
    open_trace,
    sniff_format,
    write_trace,
)
from repro_torch.cachesim.tracelab.stream import StreamFault, run_stream
from repro_torch.cachesim.tracelab.synth import (
    TraceProfile,
    fit_profile,
    synthesize,
    synthesize_chunks,
    synthesize_sizes,
    tenant_streams,
)

__all__ = [
    "CatalogRemap",
    "TRACE_FORMATS",
    "TraceProfile",
    "fit_profile",
    "load_trace",
    "open_trace",
    "remap_trace",
    "run_stream",
    "StreamFault",
    "sniff_format",
    "synthesize",
    "synthesize_chunks",
    "synthesize_sizes",
    "tenant_streams",
    "write_trace",
]
