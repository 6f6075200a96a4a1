"""granite-moe-1b-a400m — MoE 32e top-8, GQA kv=8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Copied field for field from ``repro.configs.granite_moe_1b_a400m``.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    mlp_activation="swiglu", rope_theta=10_000.0,
    n_experts=32, experts_per_token=8, moe_d_ff=512, moe_every=1,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    mlp_activation="swiglu",
    n_experts=4, experts_per_token=2, moe_d_ff=64, moe_every=1,
    capacity_factor=4.0,  # drop-free at smoke scale
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
