"""The attention kernels' designs and plans, as the wrappers compute them on
the host: which design a call takes, the shared memory a block asks for,
and how the decode design splits the cache.

On the card the kernels check the shared memory they are handed against
the same formulas (``wg::smem_bytes`` in ``flash_prefill.cu``,
``mma_smem_bytes`` and ``mma_q8_smem_bytes`` in ``decode_attention.cu``);
the plans' times are chip_smoke.py's (phases 13 and 25).  Everything here
runs on the CPU.
"""

import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels.decode_attention.kernel import TILE, decode_plan, mma_grid_plan
from repro_torch.kernels.flash_prefill import kernel as prefill_kernel

SMS = 132  # an H100 SXM's SMs
BLOCK_SHARED = 232_448  # shared memory one block can use on an H100
SM_SHARED = 233_472  # an SM's, of which each resident block reserves 1024 more


def test_phi3_vision_prefill_takes_the_wgmma_design():
    """bf16 at D = 96 runs the wgmma design; float32 at 96 and bf16 at the
    smoke configurations' 16 stay on the CUDA-core design."""
    D = get_arch("phi-3-vision-4.2b").head_dim
    assert D == 96
    assert prefill_kernel.design(torch.bfloat16, D) == prefill_kernel.WGMMA == "wgmma+tma"
    assert prefill_kernel.design(torch.float32, D) == prefill_kernel.CUDA_CORE == "cuda-core"
    assert prefill_kernel.design(torch.bfloat16, 16) == prefill_kernel.CUDA_CORE


@pytest.mark.parametrize("D", prefill_kernel.WGMMA_HEAD_DIMS)
def test_prefill_plan_is_the_sources_formula(D):
    """Q, a 2-stage K/V ring of 128-key tiles up to D = 128 (64 past it),
    128 bytes of mbarriers and 1024 of alignment: 124 032 bytes at D = 96,
    within a block's shared memory."""
    plan = prefill_kernel.prefill_plan(D)
    key_tile = 128 if D <= 128 else 64
    assert plan["key_tile"] == key_tile
    assert plan["smem_bytes"] == 1024 + 128 * D * 2 + 2 * 2 * key_tile * D * 2 + 128
    assert plan["smem_bytes"] <= BLOCK_SHARED
    if D == 96:
        assert plan["smem_bytes"] == 124_032


@pytest.mark.parametrize("D", [16, 64, 96, 128, 256])
def test_int8_decode_plan_fits_an_sm(D):
    """The int8 mma design's block: 4 warps, each a ring of 3 slices of 16
    rows of K and V codes (rows padded by 16 bytes) and their 32 scales;
    within an SM's shared memory with its 1024 reserved bytes, as many
    times as the plan says blocks share an SM."""
    plan = decode_plan(D, int8=True)
    assert plan["smem_bytes"] == 4 * 3 * (2 * 16 * (D + 16) + 2 * 16 * 4) <= BLOCK_SHARED
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SM_SHARED
    assert plan["blocks_per_sm"] == (3 if D <= 128 else 2)


def test_int8_split_at_mistral_nemo_serving():
    """mistral-nemo's served cache (B = 8, H = 32, Hkv = 8, D = 128, S = 2080)
    on 132 SMs: the int8 rule takes the fewest whole tiles a split whose
    grid fits the SMs' block slots in one wave, 3 blocks an SM: 6 splits of
    6 tiles, 384 blocks of 396 slots (the fastest of chip_smoke.py phase
    25's split sweep on an H100; the bf16 cache's rule would take 2 of 17:
    PERF.md, section 6, row 6)."""
    cfg = get_arch("mistral-nemo-12b")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_splits, split_len = mma_grid_plan(8, H, Hkv, 2080, D, SMS, int8=True)
    assert (n_splits, split_len) == (6, 6 * TILE)
    blocks = 8 * Hkv * n_splits
    slots = decode_plan(D, int8=True)["blocks_per_sm"] * SMS
    assert blocks <= slots
    # one tile fewer a split would need a second wave
    assert 8 * Hkv * -(-2080 // ((split_len // TILE - 1) * TILE)) > slots
    # no empty split
    assert (n_splits - 1) * split_len < 2080 <= n_splits * split_len


@pytest.mark.parametrize("arch,S,plan", [
    ("glm4-9b", 2080, (7, 5 * TILE)),
    ("glm4-9b", 32768, (16, 32 * TILE)),
    ("qwen3-14b", 2080, (2, 17 * TILE)),
    ("granite-moe-1b-a400m", 2080, (2, 17 * TILE)),
])
def test_bf16_decode_plan_is_unchanged(arch, S, plan):
    """The bf16 cache keeps its rule (the fewer tiles on the busiest SM of
    one wave at the ring's blocks an SM and one block an SM): glm4-9b's 7 x 5
    at serving and 16 x 32 at S = 32 768, qwen3-14b's and granite-moe's
    served shapes at 2 x 17."""
    cfg = get_arch(arch)
    assert mma_grid_plan(8, cfg.n_heads, cfg.n_kv_heads, S, cfg.head_dim, SMS) == plan
    assert decode_plan(cfg.head_dim)["smem_bytes"] == 3 * 2 * TILE * (cfg.head_dim + 8) * 2
