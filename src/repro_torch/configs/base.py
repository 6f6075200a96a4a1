"""Architecture and shape configurations, copied from ``repro.configs.base``.

An :class:`ArchConfig` holds a model's published dimensions; each
registered architecture also has a reduced smoke variant for CPU tests.
The port carries every architecture of the JAX package: the dense
glm4-9b, qwen3-14b, gemma-7b and mistral-nemo (its int8 KV cache), the
MoE granite-moe and kimi-k2, the VLM phi-3-vision, the encoder-decoder
whisper, the SSM rwkv6 and the hybrid jamba (Mamba and attention layers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention details ---
    mlp_activation: str = "swiglu"  # swiglu | geglu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden dim (0 -> use d_ff)
    moe_every: int = 1  # MoE on layers with index % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (jamba): one attention layer per `attn_period`, rest Mamba ---
    attn_period: int = 0  # 0 => pure attention (or pure ssm for family=ssm)
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- rwkv ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # stubbed conv frontend output length
    # --- vlm ---
    n_image_tokens: int = 0
    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # "full" recomputes everything in the backward (re-running the TP
    # all-reduces); "save_tp" checkpoints the post-collective block outputs
    # so recompute never re-issues collectives (§Perf H1b: -1/3 AR volume)
    remat_policy: str = "save_tp"
    # "compute" stores KV in compute_dtype; "int8" stores per-token-per-head
    # symmetric-quantized KV (halves decode HBM traffic — §Perf H3)
    kv_cache_dtype: str = "compute"
    # --- notes (provenance) ---
    source: str = ""

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k applies."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * 2  # in + out (untied)
        att = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        att += self.n_heads * self.head_dim * d
        dense_mlp = 3 * d * self.d_ff
        total = emb
        for layer in range(self.n_layers):
            if self.family == "ssm":
                d_in = self.ssm_expand * d
                total += 2 * d * d_in + d_in * d + 3 * d * self.d_ff
                continue
            is_attn = (
                self.attn_period == 0 or (layer % self.attn_period) == (self.attn_period - 1)
            )
            if is_attn:
                total += att
            else:  # mamba layer
                d_in = self.ssm_expand * d
                total += 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state_dim + 1)
            is_moe = (
                self.n_experts > 0 and (layer % self.moe_every) == self.moe_offset
            )
            if is_moe:
                total += self.n_experts * 3 * d * self.expert_ff + d * self.n_experts
            else:
                total += dense_mlp
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (att + dense_mlp)
            total += self.n_layers * att  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = len(
            [
                l
                for l in range(self.n_layers)
                if (l % self.moe_every) == self.moe_offset
            ]
        )
        all_e = n_moe_layers * self.n_experts * 3 * self.d_model * self.expert_ff
        act_e = n_moe_layers * self.experts_per_token * 3 * self.d_model * self.expert_ff
        return full - all_e + act_e


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}
_SMOKE: Dict[str, ArchConfig] = {}

#: architectures of the JAX package that the port does not carry yet
NOT_PORTED: Tuple[str, ...] = ()


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def _lookup(table: Dict[str, ArchConfig], name: str) -> ArchConfig:
    _ensure_loaded()
    if name in table:
        return table[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet; the port serves {sorted(_REGISTRY)}"
        )
    raise KeyError(name)


def get_arch(name: str) -> ArchConfig:
    return _lookup(_REGISTRY, name)


def get_smoke(name: str) -> ArchConfig:
    return _lookup(_SMOKE, name)


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        gemma_7b,
        glm4_9b,
        granite_moe_1b_a400m,
        jamba_1p5_large,
        kimi_k2,
        mistral_nemo_12b,
        phi3_vision,
        qwen3_14b,
        rwkv6_1b6,
        whisper_large_v3,
    )
