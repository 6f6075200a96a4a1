"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP frontend STUBBED
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

prefill takes precomputed patch embeddings (B, n_image_tokens, d_model) as
``image_embeds``; the CLIP tower is out of scope, as in the JAX package.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    mlp_activation="swiglu", rope_theta=10_000.0,
    n_image_tokens=256,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)

SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="swiglu",
    n_image_tokens=16,
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
