"""kimi-k2-1t-a32b — trillion-param MoE 384e top-8 [arXiv:2501.kimi2; unverified].

Copied field for field from ``repro.configs.kimi_k2``: the paper table gives
d_model=7168 with 64 heads (head_dim 112), and the JAX package rounds
head_dim up to 128, so the projection widths are 64*128=8192 (vs 7168).
The port keeps those shapes, so both packages run the same model.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    mlp_activation="swiglu", rope_theta=50_000.0,
    n_experts=384, experts_per_token=8, moe_d_ff=2048, moe_every=1,
    capacity_factor=1.0,
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2 (paper-table); unverified",
)

SMOKE = ArchConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    mlp_activation="swiglu",
    n_experts=8, experts_per_token=2, moe_d_ff=64, moe_every=1,
    capacity_factor=8.0,  # drop-free at smoke scale
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
