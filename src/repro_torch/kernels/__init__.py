"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Each wrapper counts its launches in a plain integer attribute
(``histogram.launches``, ``masses.launches``, ``project_warm_tau.launches``,
``project_warm.launches``, ``apply.launches``, ``block_segment_sums.launches``,
``tree_build.launches``, ``tree_update_.launches``,
``bucket_masses.launches``, ``solve_buckets.launches``,
``solve_sized.launches``, ``flash_prefill.launches``, ``flash_prefill_bwd.launches``,
``decode_attention.launches``, ``slot_automaton.launches``,
``fifo_queue.launches``, ``tree_lru.launches``,
``ring_compaction.launches``, ``minpair_automaton.launches``,
``wkv6.launches``, ``wkv6_bwd.launches``, ``selective_scan.launches``), so a run
can show that it went through the kernels.  :func:`launch_counts` reads them by
kernel source (the warm projection counts as ``mass``, the whole-tree
build as ``segsum``, the bucket and sized solves as ``bucket_mass``, a
stacked tree update as ``tree_update``, a ring compaction as ``tree_lru``,
a GDS chunk as ``minpair_automaton``); ``apply``
counts the clip's executions, so a
``project_warm`` launch, whose epilogue is the clip, counts once as ``mass``
and once as ``apply`` (design ``"projection epilogue"``).
:func:`design_counts` reads the launches by design of the wrappers that
keep them (a ``designs`` dict), summed over a kernel's wrappers, and
:func:`reset_launch_counts` sets both to 0.
"""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.capped_simplex.ops import (
        apply,
        masses,
        project_warm,
        project_warm_tau,
    )
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_prefill, flash_prefill_bwd
    from repro_torch.kernels.fifo_queue.ops import fifo_queue
    from repro_torch.kernels.prefix_tree.kernel import (
        block_segment_sums,
        bucket_masses,
        solve_buckets,
        solve_sized,
    )
    from repro_torch.kernels.prefix_tree.ops import tree_build, tree_update_
    from repro_torch.kernels.scatter_counts.ops import histogram
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.minpair_automaton.ops import minpair_automaton
    from repro_torch.kernels.slot_automaton.ops import slot_automaton
    from repro_torch.kernels.tree_lru.ops import ring_compaction, tree_lru
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_bwd

    return {
        "histogram": (histogram,),
        "mass": (masses, project_warm_tau, project_warm),
        "apply": (apply,),
        "segsum": (block_segment_sums, tree_build),
        "tree_update": (tree_update_,),
        "bucket_mass": (bucket_masses, solve_buckets, solve_sized),
        "flash_prefill": (flash_prefill,),
        "flash_prefill_bwd": (flash_prefill_bwd,),
        "decode_attention": (decode_attention,),
        "slot_automaton": (slot_automaton,),
        "fifo_queue": (fifo_queue,),
        "tree_lru": (tree_lru, ring_compaction),
        "minpair_automaton": (minpair_automaton,),
        "wkv6": (wkv6,),
        "selective_scan": (selective_scan,),
        "wkv6_bwd": (wkv6_bwd,),
    }


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return {name: sum(fn.launches for fn in fns) for name, fns in _wrappers().items()}


def design_counts() -> Dict[str, Dict[str, int]]:
    """Kernel name -> {design: launches since the last reset}, for the
    kernels whose wrappers count by design."""
    out: Dict[str, Dict[str, int]] = {}
    for name, fns in _wrappers().items():
        for fn in fns:
            for design, n in getattr(fn, "designs", {}).items():
                by_design = out.setdefault(name, {})
                by_design[design] = by_design.get(design, 0) + n
    return out


def reset_launch_counts() -> None:
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0
            if hasattr(fn, "designs"):
                fn.designs = {}
