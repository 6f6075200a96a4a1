"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Each wrapper counts its launches in a plain integer attribute
(``histogram.launches``, ``masses.launches``, ``apply.launches``,
``block_segment_sums.launches``, ``bucket_masses.launches``,
``flash_prefill.launches``, ``decode_attention.launches``), so a run
can show that it went through the kernels; :func:`launch_counts` reads them
and :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.capped_simplex.ops import apply, masses
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.prefix_tree.kernel import block_segment_sums, bucket_masses
    from repro_torch.kernels.scatter_counts.ops import histogram

    return {
        "histogram": histogram,
        "mass": masses,
        "apply": apply,
        "segsum": block_segment_sums,
        "bucket_mass": bucket_masses,
        "flash_prefill": flash_prefill,
        "decode_attention": decode_attention,
    }


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
