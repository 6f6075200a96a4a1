"""The models: parameters, prefill, one decode step and the training forward.

Counterpart of ``repro.models.model`` for the attention families,
``"dense"`` (glm4-9b, qwen3-14b, gemma-7b, mistral-nemo), ``"moe"``
(granite-moe, kimi-k2: a block's ``moe`` subtree, :mod:`.moe`, in place of
its MLP on the layers ``_is_moe_layer`` picks), ``"vlm"`` (phi-3-vision: a
prefix of image embeddings, normed by ``img_norm``, before the prompt's
tokens) and ``"encdec"`` (whisper: an encoder over frame embeddings with
learned positions, a decoder with causal self-attention and
cross-attention over the encoder's output), for ``"ssm"`` (rwkv6: a
stack of RWKV-6 blocks, :mod:`.rwkv`, whose cache is the recurrent state,
no KV), and for ``"hybrid"`` (jamba: super-blocks of ``attn_period``
layers, Mamba layers, :mod:`.mamba`, then one attention layer, a MoE
layer or an MLP after each as ``_is_moe_layer`` picks by the index within
the super-block).  The KV cache is in
the compute type or, for
``kv_cache_dtype="int8"``, int8 codes with float32 scales (an encdec
cache, as in ``repro``, is always in the compute type).  Parameters are
plain dictionaries of tensors in the JAX layout (``x @ w`` with ``w`` of
shape ``(in, out)``), ``params["blocks"]`` (and an encdec's
``params["encoder"]``) a list with one dictionary a layer:
:func:`params_from_numpy` unstacks ``repro``'s ``init_params`` pytree into
it, so both packages run on the same weights.  The KV cache is stacked
``(L, B, max_len, Hkv, D)`` tensors; :func:`decode_step` writes the new
position in place instead of copying the cache.  An ssm cache is the
stacked token-shift rows ``tm_x`` and ``cm_x`` (L, B, d_model) in the
compute type and the WKV state ``tm_s`` (L, B, H, n, n) in float32, which
prefill fills and each decode step updates in place, layer by layer.  A
hybrid cache is ``repro``'s: K and V (nb, B, max_len, Hkv, D) for the nb
super-blocks' attention layers, in the compute type, and for their Mamba
layers the convolution's last inputs ``conv`` (nb, period - 1, B, W - 1,
d_in) in the compute type and the scan's state ``ssm`` (nb, period - 1, B,
d_in, n) in float32, which the ``selective_scan`` kernel updates in place.

Every entry point takes a ``device`` and resolves it through
:func:`repro_torch._device.resolve_device`: the card unless the caller
asks for the CPU.

:func:`forward_train` is ``repro``'s training forward for the dense, moe,
vlm, encdec and ssm families (the loss and its metrics, each layer
checkpointed under ``cfg.remat``); its whole-sequence attention runs
through ``attention.FlashAttention`` and rwkv6's recurrence through
``kernels.wkv6.ops.WKV6``, whose backwards are kernels.  The hybrid family
raises: its scan kernel has no backward yet.
:func:`train_state_from_numpy` and :func:`params_to_numpy` carry a
``repro`` train state across and back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill.kernel import BWD_MAX_HEAD_DIM

from .attention import (
    _project_qkv,
    attention_decode,
    attention_forward,
    cross_attention_decode,
    flash_attention,
    init_attention,
    init_kv_cache,
    project_cross_kv,
    write_kv,
)
from .common import dtype_of, embed_init, rmsnorm, rmsnorm_init, softmax_cross_entropy
from .mamba import init_mamba, mamba_forward
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_forward, moe_output
from .rwkv import init_rwkv_block, rwkv_block_fwd

VOCAB_PAD = 256
NEG_INF = -1e30

Params = Dict[str, Any]

#: leaves kept in float32 under a bf16 compute type (the router's logits,
#: RWKV's decay base and bonus, Mamba's dynamics)
F32_KEEP = ("router", "w0", "u", "A_log", "dt_bias", "D")


#: the families the port serves
FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
#: a decoder block's KV cache entries, stacked over the layers
KV_NAMES = ("k", "v", "k_scale", "v_scale")
#: rows of an encdec model's learned decoder positions (``repro`` sizes them
#: for its largest decoder shape)
DEC_POSITIONS = 32_768


def _require_ported(cfg) -> None:
    if cfg.family not in FAMILIES or (cfg.family == "dense" and cfg.n_experts):
        raise NotImplementedError(f"the {cfg.family} family ({cfg.name}) is not ported")
    if cfg.kv_cache_dtype not in ("compute", "int8"):
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported")
    if cfg.family == "hybrid" and (cfg.attn_period < 1 or cfg.n_layers % cfg.attn_period):
        raise ValueError(f"a hybrid model's {cfg.n_layers} layers are super-blocks of "
                         f"attn_period layers; attn_period={cfg.attn_period}")


def _is_moe_layer(cfg, layer: int) -> bool:
    return cfg.n_experts > 0 and (layer % cfg.moe_every) == cfg.moe_offset


def _is_attn_layer(cfg, layer: int) -> bool:
    """A hybrid model's attention layer: the last of each super-block."""
    return (layer % cfg.attn_period) == (cfg.attn_period - 1)


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, name) for v in tree]
    return fn(name, tree)


def cast_params_for_compute(cfg, params: Params) -> Params:
    """The float32 weights in the compute type, the router, RWKV's ``w0``
    and ``u`` and Mamba's ``A_log``, ``dt_bias`` and ``D`` kept in float32
    (``repro``'s ``_F32_KEEP``).  A leaf already
    in the compute type is the same tensor, so the engine casts once and
    every later call costs nothing."""
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
    in ``dtype`` (default ``cfg.param_dtype``; the leaves of :data:`F32_KEEP`
    stay float32).
    Drawing in the compute type on the card keeps the peak near one copy of
    the weights.  Layers are homogeneous, as in the reference: each block
    has an MLP, or a ``moe`` subtree where ``_is_moe_layer(cfg,
    cfg.moe_offset)``; a vlm model adds ``img_norm``; an encdec model has
    ``encoder`` blocks, decoder blocks with ``cross`` attention and ``ln3``,
    and ``enc_pos``, ``dec_pos`` and ``enc_final_norm``; an ssm model's
    blocks are RWKV-6 blocks (:func:`.rwkv.init_rwkv_block`); a hybrid
    model's are heterogeneous, as ``repro``'s ``_init_decoder_layer``
    keys them by the index within the super-block: ``attn`` or ``mamba``,
    then ``moe`` or ``mlp``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pv, d = padded_vocab(cfg), cfg.d_model

    def norms(*names):
        return {name: rmsnorm_init(d, dtype, dev) for name in names}

    def mlp():
        return init_mlp(gen, d, cfg.d_ff, cfg.mlp_activation, dtype)

    params: Params = {
        "embed": embed_init(gen, pv, d, dtype),
        "lm_head": embed_init(gen, d, pv, dtype),  # (d, pv): the transposed draw of repro
        "final_norm": rmsnorm_init(d, dtype, dev),
        "blocks": [],
    }
    if cfg.family == "ssm":
        params["blocks"] = [init_rwkv_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]
        return params
    if cfg.family == "encdec":
        params["encoder"] = [{**norms("ln1", "ln2"), "attn": init_attention(gen, cfg, dtype),
                              "mlp": mlp()} for _ in range(cfg.n_encoder_layers)]
        params["blocks"] = [{**norms("ln1", "ln2", "ln3"), "attn": init_attention(gen, cfg, dtype),
                             "cross": init_attention(gen, cfg, dtype), "mlp": mlp()}
                            for _ in range(cfg.n_layers)]
        params["enc_pos"] = embed_init(gen, cfg.n_audio_frames, d, dtype)
        params["dec_pos"] = embed_init(gen, DEC_POSITIONS, d, dtype)
        params["enc_final_norm"] = rmsnorm_init(d, dtype, dev)
        return params
    if cfg.family == "hybrid":
        for layer in range(cfg.n_layers):
            j = layer % cfg.attn_period  # the index within its super-block
            block = {**norms("ln1", "ln2")}
            if _is_attn_layer(cfg, j):
                block["attn"] = init_attention(gen, cfg, dtype)
            else:
                block["mamba"] = init_mamba(gen, cfg, dtype)
            if _is_moe_layer(cfg, j):
                block["moe"] = init_moe(gen, cfg, dtype)
            else:
                block["mlp"] = mlp()
            params["blocks"].append(block)
        return params
    moe = _is_moe_layer(cfg, cfg.moe_offset)
    for _ in range(cfg.n_layers):
        block = {**norms("ln1", "ln2"), "attn": init_attention(gen, cfg, dtype)}
        if moe:
            block["moe"] = init_moe(gen, cfg, dtype)
        else:
            block["mlp"] = mlp()
        params["blocks"].append(block)
    if cfg.family == "vlm":
        params["img_norm"] = rmsnorm_init(d, dtype, dev)
    return params


def tensor_from_numpy(a) -> torch.Tensor:
    """A copy of numpy array ``a`` as a CPU tensor; a bfloat16 array (the
    ``ml_dtypes`` type in which JAX hands bf16 out) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: JAX hands out read-only arrays


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; bfloat16, which numpy has no type for,
    widened to float32 (exactly)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_from_numpy(cfg, params_np: Dict[str, Any], device: DeviceLike,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """``repro``'s ``init_params`` pytree, as numpy arrays, in the port's
    layout: ``params["blocks"]`` unstacked along its leading L axis (a
    block's ``moe`` or ``cross`` subtree with it) and an encdec model's
    ``params["encoder"]`` along ``n_encoder_layers``; ``enc_pos``,
    ``dec_pos``, ``enc_final_norm`` and ``img_norm`` as they are; in
    ``dtype`` if given, the leaves of :data:`F32_KEEP` left in float32.  A
    hybrid model's ``blocks`` is a list of ``attn_period`` layers, each leaf
    stacked over the super-blocks: layer ``sb * attn_period + i`` of the
    port is ``blocks[i][...][sb]``."""
    _require_ported(cfg)
    dev = resolve_device(device)

    def conv(name, a):
        t = tensor_from_numpy(a).to(dev)
        return t if dtype is None or name in F32_KEEP else t.to(dtype)

    layers = {"blocks": cfg.n_layers, "encoder": cfg.n_encoder_layers}
    out = {k: _map(conv, v, k) for k, v in params_np.items() if k not in layers}
    for key, n in layers.items():
        if key in params_np and not (key == "blocks" and cfg.family == "hybrid"):
            out[key] = [_map(lambda name, a, i=i: conv(name, a[i]), params_np[key])
                        for i in range(n)]
    if cfg.family == "hybrid":
        period = cfg.attn_period
        out["blocks"] = [_map(lambda name, a, sb=sb: conv(name, a[sb]), params_np["blocks"][i])
                         for sb in range(cfg.n_layers // period) for i in range(period)]
    return out


def _stack(trees):
    """One tree of numpy arrays stacked along a new leading axis from
    ``trees``, a list of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([tensor_to_numpy(t) for t in trees])


def params_to_numpy(cfg, params: Params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the port's parameters (or a
    tree of their shape, such as AdamW's moments) in ``repro``'s
    ``init_params`` layout as numpy arrays, ``blocks`` and ``encoder``
    stacked along their leading layer axis (a hybrid model's as ``repro``'s
    list of ``attn_period`` layers, each stacked over the super-blocks);
    bfloat16 leaves widened to float32."""
    out = {k: _map(lambda name, t: tensor_to_numpy(t), v, k) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    if "encoder" in params:
        out["encoder"] = _stack(params["encoder"])
    if cfg.family == "hybrid":
        period = cfg.attn_period
        out["blocks"] = [_stack(params["blocks"][i::period]) for i in range(period)]
    else:
        out["blocks"] = _stack(params["blocks"])
    return out


def train_state_from_numpy(cfg, params_np: Dict[str, Any], opt_np, device: DeviceLike):
    """``repro``'s ``TrainState`` pieces, as numpy arrays, in the port's
    layout: parameters that require grad, and an ``AdamWState`` whose step is
    ``opt_np.step`` and whose m and v keep their dtype (float32 or
    bfloat16)."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    params = _map(lambda name, t: t.requires_grad_(True), params_from_numpy(cfg, params_np, device))
    opt = AdamWState(step=int(np.asarray(opt_np.step)),
                     m=params_from_numpy(cfg, opt_np.m, device),
                     v=params_from_numpy(cfg, opt_np.v, device))
    return TrainState(params=params, opt=opt)


def init_cache(cfg, batch: int, max_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked (L, B, max_len, Hkv, D) K and V in the compute type (for an
    int8 cache int8 codes and (L, B, max_len, Hkv) float32 ``k_scale`` and
    ``v_scale``), and the position of the next token; an encdec cache also
    holds the encoder's cross-attention ``cross_k`` and ``cross_v``,
    (L, B, n_audio_frames, Hkv, D) in the compute type, which
    :func:`prefill` fills.  An ssm cache, whatever ``max_len``: ``tm_x`` and
    ``cm_x`` (L, B, d_model) in the compute type, ``tm_s`` (L, B, H, n, n)
    in float32, all zero.  A hybrid cache, in ``repro``'s layout over its nb
    super-blocks of ``period`` layers: ``k`` and ``v`` (nb, B, max_len, Hkv,
    D) and ``conv`` (nb, period - 1, B, W - 1, d_in) in the compute type,
    ``ssm`` (nb, period - 1, B, d_in, n) in float32."""
    _require_ported(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    L = cfg.n_layers
    if cfg.family == "ssm":
        n = cfg.rwkv_head_dim
        rows = torch.zeros((L, batch, cfg.d_model), dtype=cdt, device=dev)
        return {"tm_x": rows, "tm_s": torch.zeros((L, batch, cfg.d_model // n, n, n),
                                                  dtype=torch.float32, device=dev),
                "cm_x": rows.clone(), "pos": 0}
    if cfg.family == "hybrid":  # in the compute type whatever the dtype, as repro's
        nb, mamba = cfg.n_layers // cfg.attn_period, cfg.attn_period - 1
        d_in = cfg.ssm_expand * cfg.d_model
        kv = (nb, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=cdt, device=dev),
                "v": torch.zeros(kv, dtype=cdt, device=dev),
                "conv": torch.zeros((nb, mamba, batch, cfg.ssm_conv_width - 1, d_in), dtype=cdt,
                                    device=dev),
                "ssm": torch.zeros((nb, mamba, batch, d_in, cfg.ssm_state_dim),
                                   dtype=torch.float32, device=dev),
                "pos": 0}
    if cfg.family == "encdec":  # repro's encdec cache is in the compute type whatever the dtype
        cfg = dataclasses.replace(cfg, kv_cache_dtype="compute")
    layer = init_kv_cache(cfg, batch, max_len, cdt, dev)
    cache: Dict[str, Any] = {name: t.new_zeros((L, *t.shape)) for name, t in layer.items()}
    if cfg.family == "encdec":
        shape = (L, batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=cdt, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=cdt, device=dev)
    cache["pos"] = 0
    return cache


def _layer_cache(cache: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s K and V (and scales), views of the stacked cache."""
    return {name: cache[name][i] for name in KV_NAMES if name in cache}


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


def _rwkv_stack(cfg, params: Params, x: torch.Tensor, cache: Dict[str, Any]) -> torch.Tensor:
    """Every RWKV-6 block over x (B, S, d_model), from the cache's state and
    into it: the kernel writes each layer's ``tm_s`` in place, the last rows
    go into ``tm_x`` and ``cm_x``.  A zero cache is the reference's
    stateless prefill (its token shift pads with zero)."""
    for i, p in enumerate(params["blocks"]):
        x, (tm_x, _, cm_x) = rwkv_block_fwd(
            p, x, cfg, state=(cache["tm_x"][i], cache["tm_s"][i], cache["cm_x"][i]))
        cache["tm_x"][i].copy_(tm_x)
        cache["cm_x"][i].copy_(cm_x)
    return x


def _hybrid_stack(cfg, params: Params, x: torch.Tensor, cache: Dict[str, Any],
                  positions: Optional[torch.Tensor] = None,
                  pos: Optional[int] = None) -> torch.Tensor:
    """Every layer of a hybrid model over x (B, S, d_model), from the
    cache's state and into it.  Super-block ``sb``'s attention layer (its
    last) is, in a prefill (``positions`` given), :func:`_decoder_block`
    into the views of ``k`` and ``v``; in a decode step (``pos`` given)
    ``attention_decode`` at ``pos``.  Its ``j``-th Mamba layer runs the scan
    from ``ssm[sb, j]``, which the kernel updates in place (a zero cache is
    the reference's stateless prefill), and stores its convolution state in
    ``conv[sb, j]``.  Each layer ends in its MoE layer or MLP."""
    for i, p in enumerate(params["blocks"]):
        sb, j = divmod(i, cfg.attn_period)
        if "attn" in p:
            kv = {"k": cache["k"][sb], "v": cache["v"][sb]}
            if pos is None:
                x = _decoder_block(cfg, p, x, positions, kv)
                continue
            h, _ = attention_decode(p["attn"], rmsnorm(x, p["ln1"]), kv, pos, cfg)
        else:
            conv = cache["conv"][sb, j]
            h, (new_conv, _) = mamba_forward(p["mamba"], rmsnorm(x, p["ln1"]), cfg,
                                             state=(conv, cache["ssm"][sb, j]))
            conv.copy_(new_conv)
        x = x + h
        x = x + _ffn(cfg, p, rmsnorm(x, p["ln2"]))
    return x


def _encoder_forward(cfg, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings (B, T, d_model), learned positions
    added, non-causal self-attention; (B, T, d_model) after its final norm."""
    cdt = dtype_of(cfg.compute_dtype)
    B, T, _ = frames.shape
    if T > cfg.n_audio_frames:
        raise ValueError(f"{T} frames exceed the encoder's {cfg.n_audio_frames} positions")
    x = frames.to(cdt) + params["enc_pos"][:T].to(cdt)
    positions = torch.arange(T, device=x.device).expand(B, T)
    for p in params["encoder"]:
        x = x + attention_forward(p["attn"], rmsnorm(x, p["ln1"]), cfg, positions, causal=False)
        x = x + mlp_forward(p["mlp"], rmsnorm(x, p["ln2"]), cfg.mlp_activation)
    return rmsnorm(x, params["enc_final_norm"])


def _decoder_block(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   layer_cache: Dict[str, torch.Tensor],
                   cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """A decoder block over a whole prompt: causal self-attention, whose K
    and V it writes into ``layer_cache`` from position 0 (the attention
    runs on them unquantized, as in ``repro``), an encdec block's
    cross-attention over the encoder's ``cross`` K and V, then the block's
    MoE layer or MLP."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p["attn"], rmsnorm(x, p["ln1"]), cfg, positions)
    attn = flash_attention(q, k, v, causal=True)
    x = x + attn.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
    write_kv(layer_cache, k, v, 0)
    if cross is None:
        return x + _ffn(cfg, p, rmsnorm(x, p["ln2"]))
    x = x + attention_forward(p["cross"], rmsnorm(x, p["ln2"]), cfg, positions, causal=False,
                              kv=cross)
    return x + mlp_forward(p["mlp"], rmsnorm(x, p["ln3"]), cfg.mlp_activation)


def _decoder_encdec_forward_with_cache(cfg, params: Params, tokens: torch.Tensor,
                                       cache: Dict[str, Any]) -> torch.Tensor:
    """The encdec decoder over whole prompts, learned positions added, its
    self-attention K and V written into the cache, its cross-attention over
    the cache's encoder K and V; last-token logits."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    x = params["embed"][tokens].to(cdt) + params["dec_pos"][:S].to(cdt)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, p in enumerate(params["blocks"]):
        x = _decoder_block(cfg, p, x, positions, _layer_cache(cache, i),
                           (cache["cross_k"][i], cache["cross_v"][i]))
    return _logits(cfg, params, x[:, -1:])[:, 0]


def prefill(cfg, params: Params, batch: Dict[str, Any], max_len: int,
            device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run whole prompts, fill the decode cache, return last-token logits
    (B, padded vocab) and the cache.  ``batch`` holds ``tokens`` (B, S);
    a vlm model takes optional ``image_embeds`` (B, n_image, d_model),
    normed and put before the tokens; an encdec model needs ``frames``
    (B, T, d_model), whose encoder K and V it caches for cross-attention.
    An ssm model runs its blocks from a zero state into the cache (a
    ``wkv6`` launch a layer) and, as the reference, checks no ``max_len``;
    a hybrid model runs its Mamba layers from a zero state into the cache
    (a ``selective_scan`` launch a layer) and its attention layers through
    ``flash_prefill``."""
    _require_ported(cfg)
    dev = _device_of(params, device)
    params = cast_params_for_compute(cfg, params)
    cdt = dtype_of(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    B, S = tokens.shape
    if cfg.family == "ssm":
        cache = init_cache(cfg, B, max_len, dev)
        x = _rwkv_stack(cfg, params, params["embed"][tokens].to(cdt), cache)
        cache["pos"] = S
        return _logits(cfg, params, x[:, -1:])[:, 0], cache
    if cfg.family == "encdec":
        if "frames" not in batch:
            raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs the audio "
                             f"'frames' (B, T, d_model) beside the tokens")
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens does not fit max_len {max_len}")
        enc = _encoder_forward(cfg, params, torch.as_tensor(batch["frames"], device=dev))
        cache = init_cache(cfg, B, max_len, dev)
        if enc.shape[1] != cfg.n_audio_frames:  # fewer frames: the cache holds as many rows
            for name in ("cross_k", "cross_v"):
                cache[name] = cache[name][:, :, :enc.shape[1]].contiguous()
        for i, p in enumerate(params["blocks"]):
            cache["cross_k"][i], cache["cross_v"][i] = project_cross_kv(p["cross"], enc, cfg)
        logits = _decoder_encdec_forward_with_cache(cfg, params, tokens, cache)
        cache["pos"] = S
        return logits, cache
    x = params["embed"][tokens].to(cdt)
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = torch.as_tensor(batch["image_embeds"], device=dev).to(cdt)
        x = torch.cat([rmsnorm(img, params["img_norm"]), x], dim=1)
        S = x.shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} positions does not fit max_len {max_len}")
    cache = init_cache(cfg, B, max_len, dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    if cfg.family == "hybrid":
        x = _hybrid_stack(cfg, params, x, cache, positions=positions)
    else:
        for i, p in enumerate(params["blocks"]):
            x = _decoder_block(cfg, p, x, positions, _layer_cache(cache, i))
    cache["pos"] = S
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg, params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
                device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B,) -> logits (B, padded vocab).  Writes the
    tokens' K and V at ``cache["pos"]`` in place (quantized for an int8
    cache) and advances it; an encdec step also attends over the cached
    encoder rows; an ssm step updates each layer's state in place (a
    ``wkv6`` launch a layer), a hybrid step each Mamba layer's (a
    ``selective_scan`` launch a layer) beside its attention layers' K and
    V."""
    _require_ported(cfg)
    dev = _device_of(params, device)
    params = cast_params_for_compute(cfg, params)
    cdt = dtype_of(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = params["embed"][torch.as_tensor(tokens, device=dev).long()][:, None, :].to(cdt)
    if cfg.family in ("ssm", "hybrid"):
        x = (_rwkv_stack(cfg, params, x, cache) if cfg.family == "ssm"
             else _hybrid_stack(cfg, params, x, cache, pos=pos))
        cache["pos"] = pos + 1
        return _logits(cfg, params, x)[:, 0], cache
    encdec = cfg.family == "encdec"
    if encdec:
        x = x + params["dec_pos"][pos:pos + 1].to(cdt)
    for i, p in enumerate(params["blocks"]):
        h, _ = attention_decode(p["attn"], rmsnorm(x, p["ln1"]), _layer_cache(cache, i), pos, cfg)
        x = x + h
        if encdec:
            x = x + cross_attention_decode(p["cross"], rmsnorm(x, p["ln2"]), cache["cross_k"][i],
                                           cache["cross_v"][i], cfg, pos)
            x = x + mlp_forward(p["mlp"], rmsnorm(x, p["ln3"]), cfg.mlp_activation)
        else:
            x = x + _ffn(cfg, p, rmsnorm(x, p["ln2"]))
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# training

#: the families that train: the attention families, whose attention has a
#: backward kernel, and the ssm family (rwkv6), whose recurrence has one
TRAINED_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm")
#: the kernel whose backward a family's training waits for
MISSING_BACKWARD = {"hybrid": "selective_scan"}


def _require_trainable(cfg, dev: torch.device) -> None:
    """Raise before the first step for a configuration whose training has no
    kernel: a family in :data:`MISSING_BACKWARD`, or on the card an
    attention head dim that the backward kernel does not take (every
    registered one does)."""
    _require_ported(cfg)
    if cfg.family in MISSING_BACKWARD:
        kernel = MISSING_BACKWARD[cfg.family]
        raise NotImplementedError(
            f"training the {cfg.family} family ({cfg.name}) needs a backward of the {kernel} "
            f"kernel, which is not written yet: forward_train runs the families "
            f"{TRAINED_FAMILIES}")
    if dev.type == "cuda" and cfg.family != "ssm" and (
            cfg.head_dim % 8 or cfg.head_dim > BWD_MAX_HEAD_DIM):
        raise NotImplementedError(
            f"{cfg.name}: head_dim {cfg.head_dim} is outside the attention backward kernel's "
            f"range on the card (a multiple of 8 up to {BWD_MAX_HEAD_DIM})")


def _layer(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat`` checkpointed, as ``repro``'s
    ``_remat`` checkpoints a layer: its activations are recomputed in the
    backward (the attention kernel runs twice)."""
    if cfg.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_block(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """A decoder layer of the dense, moe and vlm families: x, and the MoE
    layer's load-balance and router z-losses (None for an MLP)."""
    x = x + attention_forward(p["attn"], rmsnorm(x, p["ln1"]), cfg, positions, causal=True)
    h = rmsnorm(x, p["ln2"])
    if "moe" in p:
        h, aux = moe_forward(p["moe"], h, cfg)
        return x + h, aux["load_balance_loss"], aux["router_z_loss"]
    return x + mlp_forward(p["mlp"], h, cfg.mlp_activation), None, None


def _rwkv_train_block(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """An RWKV-6 block from a zero state, its final state dropped."""
    return rwkv_block_fwd(p, x, cfg)[0]


def _encoder_block(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = x + attention_forward(p["attn"], rmsnorm(x, p["ln1"]), cfg, positions, causal=False)
    return x + mlp_forward(p["mlp"], rmsnorm(x, p["ln2"]), cfg.mlp_activation)


def _encdec_block(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
    """An encdec decoder layer: causal self-attention, cross-attention over
    the encoder's output (its K and V projected in the layer), the MLP."""
    x = x + attention_forward(p["attn"], rmsnorm(x, p["ln1"]), cfg, positions, causal=True)
    x = x + attention_forward(p["cross"], rmsnorm(x, p["ln2"]), cfg, positions, causal=False,
                              kv=project_cross_kv(p["cross"], enc, cfg))
    return x + mlp_forward(p["mlp"], rmsnorm(x, p["ln3"]), cfg.mlp_activation)


def forward_train(cfg, params: Params, batch: Dict[str, Any],
                  device: DeviceLike = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``repro``'s ``forward_train``: the mean next-token loss (z-loss 1e-4)
    of ``batch`` (``tokens`` and ``labels`` (B, S); a vlm model's
    ``image_embeds``, normed and put before the tokens and masked out of
    the loss; an encdec model's ``frames``, through the encoder, whose
    output the decoder's cross-attention reads), and its metrics ``nll``
    and ``lse``; a MoE model adds 0.01 of the load-balance loss and 1e-3 of
    the router z-loss, summed over the layers, and reports both.  Whole-
    sequence attention is ``models.attention.FlashAttention`` under
    autograd: the prefill kernel forward, the ``flash_prefill_bwd`` kernel
    backward.  An ssm model (rwkv6) runs its blocks from a zero state and
    drops the final one, as ``repro``'s ``_stack_forward`` does, each
    layer's recurrence through ``kernels.wkv6.ops.WKV6``: the ``wkv6``
    kernel forward, the ``wkv6_bwd`` kernel backward; it has no aux loss.
    Under ``cfg.remat`` each layer is checkpointed.  It runs where the
    parameters are unless ``device`` says otherwise.  The hybrid family
    raises ``NotImplementedError``: its scan kernel has no backward yet, as
    does, on the card, an attention head dim that the backward kernel does
    not take."""
    dev = _device_of(params, params["embed"].device if device is None else device)
    _require_trainable(cfg, dev)
    params = cast_params_for_compute(cfg, params)
    cdt = dtype_of(cfg.compute_dtype)
    need = {"encdec": "frames", "vlm": "image_embeds"}.get(cfg.family)
    if need is not None and need not in batch:
        raise ValueError(f"{cfg.name} ({cfg.family}) trains on '{need}' beside the tokens")
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    B, S = tokens.shape

    if cfg.family == "encdec":
        frames = torch.as_tensor(batch["frames"], device=dev)
        T = frames.shape[1]
        x = frames.to(cdt) + params["enc_pos"][:T].to(cdt)
        enc_positions = torch.arange(T, device=dev).expand(B, T)
        for p in params["encoder"]:
            x = _layer(cfg, _encoder_block, cfg, p, x, enc_positions)
        enc = rmsnorm(x, params["enc_final_norm"])
        x = params["embed"][tokens].to(cdt) + params["dec_pos"][:S].to(cdt)
        positions = torch.arange(S, device=dev).expand(B, S)
        for p in params["blocks"]:
            x = _layer(cfg, _encdec_block, cfg, p, x, positions, enc)
        loss, lse = softmax_cross_entropy(_logits(cfg, params, x), labels)
        return loss, {"nll": loss, "lse": lse}

    x = params["embed"][tokens].to(cdt)
    if cfg.family == "ssm":
        for p in params["blocks"]:
            x = _layer(cfg, _rwkv_train_block, cfg, p, x)
        loss, lse = softmax_cross_entropy(_logits(cfg, params, x), labels)
        return loss, {"nll": loss, "lse": lse}

    mask = None
    if cfg.family == "vlm":
        img = rmsnorm(torch.as_tensor(batch["image_embeds"], device=dev).to(cdt),
                      params["img_norm"])
        x = torch.cat([img, x], dim=1)
        n_img = img.shape[1]
        mask = torch.cat([torch.zeros(B, n_img, device=dev), torch.ones(B, S, device=dev)], dim=1)
        labels = torch.cat([labels.new_zeros((B, n_img)), labels], dim=1)
    positions = torch.arange(x.shape[1], device=dev).expand(B, x.shape[1])
    lb = z = torch.zeros((), dtype=torch.float32, device=dev)
    for p in params["blocks"]:
        x, lb_l, z_l = _layer(cfg, _train_block, cfg, p, x, positions)
        if lb_l is not None:
            lb, z = lb + lb_l, z + z_l
    loss, lse = softmax_cross_entropy(_logits(cfg, params, x), labels, mask=mask)
    metrics = {"nll": loss, "lse": lse}
    if cfg.n_experts:
        loss = loss + 0.01 * lb + 1e-3 * z
        metrics.update({"load_balance_loss": lb, "router_z_loss": z})
    return loss, metrics
