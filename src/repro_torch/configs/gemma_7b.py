"""gemma-7b — dense, GeGLU, head_dim=256, GQA kv=16 [arXiv:2403.08295; hf]."""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    mlp_activation="geglu", rope_theta=10_000.0,
    source="arXiv:2403.08295; hf",
)

SMOKE = ArchConfig(
    name="gemma-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="geglu",
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
