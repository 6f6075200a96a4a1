"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892; unverified",
)

SMOKE = ArchConfig(
    name="rwkv6-1.6b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=128, vocab_size=256,
    rwkv_head_dim=16,
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
