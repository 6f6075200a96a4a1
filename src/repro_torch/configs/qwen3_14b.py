"""qwen3-14b — dense, qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family; hf]."""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936,
    mlp_activation="swiglu", qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-14B; hf",
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256,
    mlp_activation="swiglu", qk_norm=True,
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
