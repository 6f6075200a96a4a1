"""The decoder-only model: parameters, prefill and one decode step.

Counterpart of ``repro.models.model`` for ``family`` ``"dense"`` (glm4-9b,
qwen3-14b, gemma-7b) and ``"moe"`` (granite-moe, kimi-k2: a block's
``moe`` subtree, :mod:`.moe`, in place of its MLP on the layers
``_is_moe_layer`` picks) with a KV cache in the compute type; other
families and an int8 KV cache raise ``NotImplementedError``.  Parameters are plain
dictionaries of tensors in the JAX layout (``x @ w`` with ``w`` of shape
``(in, out)``), ``params["blocks"]`` a list with one dictionary a layer:
:func:`params_from_numpy` unstacks ``repro``'s ``init_params`` pytree into
it, so both packages run on the same weights.  The KV cache is stacked
``(L, B, max_len, Hkv, D)`` tensors; :func:`decode_step` writes the new
position in place instead of copying the cache.

Every entry point takes a ``device`` and resolves it through
:func:`repro_torch._device.resolve_device`: the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

from .attention import _project_qkv, attention_decode, causal_attention, init_attention
from .common import dtype_of, embed_init, rmsnorm, rmsnorm_init
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_output

VOCAB_PAD = 256
NEG_INF = -1e30

Params = Dict[str, Any]

#: leaves kept in float32 under a bf16 compute type (the router's logits)
F32_KEEP = ("router",)


def _require_ported(cfg) -> None:
    if cfg.family not in ("dense", "moe") or (cfg.family == "dense" and cfg.n_experts):
        raise NotImplementedError(f"the {cfg.family} family ({cfg.name}) is not ported")
    if cfg.kv_cache_dtype != "compute":
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported")


def _is_moe_layer(cfg, layer: int) -> bool:
    return cfg.n_experts > 0 and (layer % cfg.moe_every) == cfg.moe_offset


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, name) for v in tree]
    return fn(name, tree)


def cast_params_for_compute(cfg, params: Params) -> Params:
    """The float32 weights in the compute type, the router kept in float32
    (``repro``'s ``_F32_KEEP``).  A leaf already in the compute type is the
    same tensor, so the engine casts once and every later call costs
    nothing."""
    cdt = dtype_of(cfg.compute_dtype)

    def cast(name, leaf):
        keep = name in F32_KEEP or leaf.dtype != torch.float32
        return leaf if keep else leaf.to(cdt)

    return params if cdt == torch.float32 else _map(cast, params)


def _device_of(params: Params, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"parameters are on {params['embed'].device}, not on {dev}")
    return dev


def init_params(cfg, seed: int = 0, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights drawn tensor by tensor on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, at ``repro``'s scales, stored
    in ``dtype`` (default ``cfg.param_dtype``; the router stays float32).
    Drawing in the compute type on the card keeps the peak near one copy of
    the weights.  Layers are homogeneous, as in the reference: each block
    has an MLP, or a ``moe`` subtree where ``_is_moe_layer(cfg,
    cfg.moe_offset)``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pv, d = padded_vocab(cfg), cfg.d_model
    params: Params = {
        "embed": embed_init(gen, pv, d, dtype),
        "lm_head": embed_init(gen, d, pv, dtype),  # (d, pv): the transposed draw of repro
        "final_norm": rmsnorm_init(d, dtype, dev),
        "blocks": [],
    }
    moe = _is_moe_layer(cfg, cfg.moe_offset)
    for _ in range(cfg.n_layers):
        block = {"ln1": rmsnorm_init(d, dtype, dev), "ln2": rmsnorm_init(d, dtype, dev),
                 "attn": init_attention(gen, cfg, dtype)}
        if moe:
            block["moe"] = init_moe(gen, cfg, dtype)
        else:
            block["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_activation, dtype)
        params["blocks"].append(block)
    return params


def params_from_numpy(cfg, params_np: Dict[str, Any], device: DeviceLike,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """``repro``'s ``init_params`` pytree, as numpy arrays, in the port's
    layout: ``params["blocks"]`` unstacked along its leading L axis (a
    block's ``moe`` subtree with it), in ``dtype`` if given, the router
    left in float32."""
    _require_ported(cfg)
    dev = resolve_device(device)

    def conv(name, a):
        t = torch.from_numpy(np.array(a)).to(dev)  # a copy: JAX hands out read-only arrays
        return t if dtype is None or name in F32_KEEP else t.to(dtype)

    out = {k: _map(conv, v, k) for k, v in params_np.items() if k != "blocks"}
    stacked = params_np["blocks"]
    out["blocks"] = [
        _map(lambda name, a, i=i: conv(name, a[i]), stacked) for i in range(cfg.n_layers)
    ]
    return out


def init_cache(cfg, batch: int, max_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked (L, B, max_len, Hkv, D) K and V in the compute type, and the
    position of the next token."""
    _require_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=dev),
            "v": torch.zeros(shape, dtype=cdt, device=dev), "pos": 0}


def _logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"])
    logits = x @ params["lm_head"].to(x.dtype)
    pv, v = logits.shape[-1], cfg.vocab_size
    if pv != v:  # mask the vocab padding
        keep = torch.arange(pv, device=logits.device) < v
        logits = torch.where(keep, logits, torch.full((), NEG_INF, dtype=logits.dtype,
                                                      device=logits.device))
    return logits


def _ffn(cfg, p: Params, h: torch.Tensor) -> torch.Tensor:
    """A block's MoE layer or its MLP."""
    if "moe" in p:
        return moe_output(p["moe"], h, cfg)
    return mlp_forward(p["mlp"], h, cfg.mlp_activation)


def prefill(cfg, params: Params, batch: Dict[str, Any], max_len: int,
            device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run whole prompts, fill the decode cache, return last-token logits
    (B, padded vocab) and the cache."""
    _require_ported(cfg)
    dev = _device_of(params, device)
    params = cast_params_for_compute(cfg, params)
    cdt = dtype_of(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens does not fit max_len {max_len}")
    cache = init_cache(cfg, B, max_len, dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    x = params["embed"][tokens].to(cdt)
    hd = cfg.n_heads * cfg.head_dim
    for i, p in enumerate(params["blocks"]):
        h = rmsnorm(x, p["ln1"])
        q, k, v = _project_qkv(p["attn"], h, cfg, positions)
        x = x + causal_attention(q, k, v).reshape(B, S, hd) @ p["attn"]["wo"]
        x = x + _ffn(cfg, p, rmsnorm(x, p["ln2"]))
        cache["k"][i, :, :S] = k.to(cdt)
        cache["v"][i, :, :S] = v.to(cdt)
    cache["pos"] = S
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg, params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
                device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B,) -> logits (B, padded vocab).  Writes the
    tokens' K and V at ``cache["pos"]`` in place and advances it."""
    _require_ported(cfg)
    dev = _device_of(params, device)
    params = cast_params_for_compute(cfg, params)
    cdt = dtype_of(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = params["embed"][torch.as_tensor(tokens, device=dev).long()][:, None, :].to(cdt)
    for i, p in enumerate(params["blocks"]):
        h, _ = attention_decode(p["attn"], rmsnorm(x, p["ln1"]),
                                {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg)
        x = x + h
        x = x + _ffn(cfg, p, rmsnorm(x, p["ln2"]))
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache
