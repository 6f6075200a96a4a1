"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887; hf].

One attention layer per 8 (attn_period=8, the 1:7 interleave); MoE on every
other layer (moe_every=2) which reproduces the published ~398B total params.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    mlp_activation="swiglu", rope_theta=10_000.0,
    n_experts=16, experts_per_token=2, moe_d_ff=24576, moe_every=2, moe_offset=1,
    attn_period=8, ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    param_dtype="bfloat16",  # Perf: halves ZeRO-3 gather + grad-AR volume at the 0.4-1T scale
    source="arXiv:2403.19887; hf",
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="swiglu",
    n_experts=4, experts_per_token=2, moe_d_ff=128, moe_every=2, moe_offset=1,
    capacity_factor=4.0,  # drop-free at smoke scale
    attn_period=4, ssm_state_dim=8, ssm_conv_width=4, ssm_expand=2,
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
