"""whisper-large-v3 — encoder-decoder, conv audio frontend STUBBED
[arXiv:2212.04356; unverified].

prefill takes precomputed frame embeddings (B, 1500, d_model) as ``frames`` —
the conv1d+GELU frontend is out of scope, as in the JAX package.  32 encoder + 32
decoder layers, MHA (kv=20 == heads).
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    mlp_activation="gelu", rope_theta=0.0,  # learned positions in whisper
    n_encoder_layers=32, n_audio_frames=1500,
    source="arXiv:2212.04356; unverified",
)

SMOKE = ArchConfig(
    name="whisper-large-v3-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_activation="gelu", rope_theta=0.0,
    n_encoder_layers=2, n_audio_frames=60,
    param_dtype="float32", compute_dtype="float32",
)

register(FULL, SMOKE)
