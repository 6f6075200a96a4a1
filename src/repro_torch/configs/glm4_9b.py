"""glm4-9b — dense, RoPE, GQA kv=2 [hf:THUDM/glm-4-9b; hf]."""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552,
    mlp_activation="swiglu", rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b; hf",
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="swiglu",
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
