"""mistral-nemo-12b — dense, GQA kv=8, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf]."""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    mlp_activation="swiglu", rope_theta=1_000_000.0,  # 128k context
    kv_cache_dtype="int8",  # Perf H3: halves decode KV traffic (hillclimbed cell)
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
)

SMOKE = ArchConfig(
    name="mistral-nemo-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="swiglu",
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
