"""The port's remaining attention families against the JAX package's.

mistral-nemo with its int8 KV cache, phi-3-vision with its image prefix and
whisper as an encoder-decoder, at their smoke configurations in float32 on
``repro``'s own weights (``init_params(cfg, jax.random.key(0))``, carried
across by ``params_from_numpy``), inputs from numpy seeds, on the CPU,
where the attention kernels' wrappers run their plain versions.  Logits
and caches agree with ``repro``'s within 1e-4 (float32 sums in another
order through two layers, as in tests/test_torch_serve.py).  The int8
cache's codes are ``repro``'s; its scales agree within 1e-5 relative,
because the K and V they quantize come from float32 projections summed in
another order (``_quantize_kv`` itself is bit for bit ``repro``'s on equal
inputs).  The kernels' new modes' plain versions (non-causal and
cross-attention prefill, decode over an int8 cache) are held against
``repro``'s ``flash_attention``, its Pallas decode kernel in interpret mode
and the jnp branch of its ``attention_decode`` at 2e-5, the kernel tests'
float32 tolerance.  The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_arch as jax_arch
from repro.configs.base import get_smoke as jax_smoke
from repro.core.ogb import OGB as JaxOGB
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.ogb import OGB
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import dequantize
from repro_torch.kernels.flash_prefill.kernel import mode
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.launch import serve as launcher
from repro_torch.models import attention, model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

FAMILIES = ["mistral-nemo-12b", "phi-3-vision-4.2b", "whisper-large-v3"]
TOL = 1e-4  # logits and caches against repro (tests/test_torch_serve.py's)
KERNEL_TOL = 2e-5  # the plain versions against repro's, float32
B, S, MAX_LEN, STEPS = 2, 12, 40, 8


def _int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


def _both(arch, int8=False):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    if int8:
        jcfg, cfg = _int8(jcfg), _int8(cfg)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _same_cache(cache, jcache):
    """The port's flat cache against repro's: K and V (int8 codes equal,
    scales within 1e-5 relative) and an encdec's cross K and V."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in cache:
            assert name not in jcache["kv"]
            continue
        got, want = cache[name].numpy(), np.asarray(jcache["kv"][name])
        assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for name in ("cross_k", "cross_v"):
        if name in cache:
            _close(cache[name], jcache[name])
    assert cache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_are_the_reference_configs(arch):
    for get, jget in ((get_arch, jax_arch), (get_smoke, jax_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    assert get_arch("mistral-nemo-12b").kv_cache_dtype == "int8"


@pytest.mark.parametrize("arch", FAMILIES)
def test_weights_carry_across(arch):
    jcfg, jparams, cfg, params = _both(arch)
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == n
    assert len(params["blocks"]) == cfg.n_layers
    if cfg.family == "encdec":
        assert len(params["encoder"]) == cfg.n_encoder_layers
        np.testing.assert_array_equal(params["encoder"][1]["attn"]["wk"].numpy(),
                                      np.asarray(jparams["encoder"]["attn"]["wk"][1]))
        np.testing.assert_array_equal(params["blocks"][1]["cross"]["wq"].numpy(),
                                      np.asarray(jparams["blocks"]["cross"]["wq"][1]))
        for name in ("enc_pos", "dec_pos", "enc_final_norm"):
            np.testing.assert_array_equal(params[name].numpy(), np.asarray(jparams[name]))
    if cfg.family == "vlm":
        np.testing.assert_array_equal(params["img_norm"].numpy(), np.asarray(jparams["img_norm"]))
    # the port's own draw has the same tree, shapes and types
    own = model.init_params(cfg, seed=0, device="cpu")
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


# -- mistral-nemo: the int8 KV cache ---------------------------------------------

def test_quantize_kv_is_the_reference_bit_for_bit():
    """Codes and scales of equal inputs, bit for bit: values at exact halves
    of a code (round half to even in both), zeros (the 1e-8 floor) and a
    normal draw."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16) - 7.5  # max 7.5: scale 7.5 / 127, codes at k + 0.5 steps
    x[0, 1, 1] = 0.0
    x[1, 2, 0, :4] = [127.0, -63.5, 0.5, 1.5]
    codes, scale = attention._quantize_kv(torch.from_numpy(x))
    jcodes, jscale = jattn._quantize_kv(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32), np.asarray(jscale).view(np.uint32))


def test_int8_prefill_and_decode_match_reference():
    jcfg, jparams, cfg, params = _both("mistral-nemo-12b", int8=True)
    batch = _batch(cfg)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(batch["tokens"])}, MAX_LEN)
    logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(batch["tokens"])},
                                  MAX_LEN, device="cpu")
    _close(logits, jl)
    _same_cache(cache, jc)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(STEPS):
        jl, jc = step(jparams, jc, jnp.asarray(tok))
        logits, same = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        assert same is cache
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(cache, jc)


def test_int8_cache_layout_halves_kv_bytes():
    """tests/models/test_int8_kv.py::test_cache_layout_halves_kv_bytes on the
    port's cache: int8 codes and float32 scales, 0.53x a bf16 cache's bytes
    at head_dim 16, and repro's shapes."""
    cfg = _int8(get_smoke("mistral-nemo-12b"))
    cache = model.init_cache(cfg, 2, 32, "cpu")
    jcache = jmodel.init_cache(_int8(jax_smoke("mistral-nemo-12b")), 2, 32)
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
    for name in ("k", "v", "k_scale", "v_scale"):
        assert cache[name].shape == jcache["kv"][name].shape
    kv_bytes = sum(cache[n].numel() * cache[n].element_size() for n in ("k", "v", "k_scale",
                                                                          "v_scale"))
    bf16_bytes = 2 * 32 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * 2 * 2
    assert kv_bytes == (2 * 32 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * 2
                        + 2 * 32 * cfg.n_kv_heads * cfg.n_layers * 2 * 4)
    assert kv_bytes < 0.66 * bf16_bytes


def test_int8_decode_close_to_the_float_cache():
    """tests/models/test_int8_kv.py::test_int8_decode_close_to_fp on the port:
    8 decode steps over an int8 cache within 0.08 of the largest |logit| of
    the same steps over a float cache, the reference's own bound."""
    _, _, cfg, params = _both("mistral-nemo-12b")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, 8)).astype(np.int32)

    def run(c):
        cache = model.init_cache(c, 1, 16, "cpu")
        for t in range(8):
            logits, cache = model.decode_step(c, params, cache, torch.from_numpy(toks[:, t]),
                                              device="cpu")
        return logits.numpy()

    lq, lf = run(_int8(cfg)), run(cfg)
    assert np.abs(lq - lf).max() / max(np.abs(lf).max(), 1e-6) < 0.08


def test_int8_attention_decode_matches_the_jnp_branch():
    """One layer's decode over an int8 cache holding earlier tokens: the
    output and the cache written in place against repro's quantized branch
    of attention_decode (quantize the new K/V, dequantize, attend in jnp)."""
    cfg = _int8(get_smoke("mistral-nemo-12b"))
    jcfg = _int8(jax_smoke("mistral-nemo-12b"))
    rng = np.random.default_rng(4)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, h * hd)) / np.sqrt(d),
         "wk": rng.normal(size=(d, kvh * hd)) / np.sqrt(d),
         "wv": rng.normal(size=(d, kvh * hd)) / np.sqrt(d),
         "wo": rng.normal(size=(h * hd, d)) / np.sqrt(h * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    Bd, Sd, pos = 3, 24, 9
    x = rng.normal(size=(Bd, 1, d)).astype(np.float32)
    codes, scale = attention._quantize_kv(torch.from_numpy(
        rng.normal(size=(2, Bd, Sd, kvh, hd)).astype(np.float32)))
    arrays = {"k": codes[0].numpy(), "v": codes[1].numpy(), "k_scale": scale[0].numpy(),
              "v_scale": scale[1].numpy()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    out, _ = attention.attention_decode({k: torch.from_numpy(v) for k, v in p.items()},
                                        torch.from_numpy(x), cache, pos, cfg)
    jout, jcache = jattn.attention_decode({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                           arrays.items()}, jnp.int32(pos), jcfg)
    _close(out, jout, KERNEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]))
        np.testing.assert_allclose(cache[name + "_scale"].numpy(),
                                   np.asarray(jcache[name + "_scale"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("D,S,lengths", [(16, 24, [1, 9, 24]), (64, 256, [1, 130, 256]),
                                         (128, 130, [65, 64, 130])])
def test_int8_decode_plain_matches_pallas_on_the_dequantized_cache(D, S, lengths):
    """The plain version over int8 codes and scales against repro's Pallas
    decode kernel (interpret mode) over repro's dequantized cache."""
    rng = np.random.default_rng(D + S)
    Bd, H, Hkv = len(lengths), 8, 2
    q = rng.normal(size=(Bd, H, D)).astype(np.float32)
    codes, scale = attention._quantize_kv(torch.from_numpy(
        rng.normal(size=(2, Bd, S, Hkv, D)).astype(np.float32)))
    lens = np.asarray(lengths, np.int32)
    got = decode_attention(torch.from_numpy(q), codes[0], codes[1], torch.from_numpy(lens),
                           scale[0], scale[1])
    kd, vd = (jnp.asarray(codes[i].numpy()).astype(jnp.float32)
              * jnp.asarray(scale[i].numpy())[..., None] for i in (0, 1))
    want = jax_decode(jnp.asarray(q), kd, vd, jnp.asarray(lens), s_block=128, interpret=True)
    _close(got, want, KERNEL_TOL)
    # the port's dequantization is repro's, and the bf16 rounding is q's type
    np.testing.assert_array_equal(dequantize(codes[0], scale[0], torch.float32).numpy(),
                                  np.asarray(kd))
    assert dequantize(codes[0], scale[0], torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="scale"):
        decode_attention(torch.from_numpy(q), codes[0], codes[1], torch.from_numpy(lens))


@pytest.mark.parametrize("D,blocks", [(16, 3), (64, 3), (96, 3), (128, 3), (256, 2)])
def test_int8_decode_plan_fits_shared_memory(D, blocks):
    """The mma design over an int8 cache: each of the 4 warps' ring of 3
    slices of 16 rows of codes (rows padded by 16 bytes) and their scales;
    the warps' merge (64 D + 128 floats) fits in it; 3 blocks an SM by the
    kernel's launch bounds up to D = 128, 2 past it."""
    from repro_torch.kernels.decode_attention.kernel import TILE, decode_plan, mma_grid_plan

    plan = decode_plan(D, int8=True)
    ring = 4 * 3 * (2 * 16 * (D + 16) + 2 * 16 * 4)
    assert plan["smem_bytes"] == ring <= 232_448
    assert plan["smem_bytes"] >= (64 * D + 128) * 4
    assert plan["blocks_per_sm"] == blocks
    # mistral-nemo's served cache on 132 SMs: its own split, not the bf16
    # cache's 2 of 17 tiles
    assert mma_grid_plan(8, 32, 8, 2080, 128, 132, int8=True) == (6, 6 * TILE)
    assert mma_grid_plan(8, 32, 8, 2080, 128, 132) == (2, 17 * TILE)


# -- phi-3-vision: the image prefix ------------------------------------------------

def test_vlm_prefill_with_image_embeds_and_decode_match_reference():
    jcfg, jparams, cfg, params = _both("phi-3-vision-4.2b")
    batch = _batch(cfg)
    jl, jc = jmodel.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                            MAX_LEN)
    logits, cache = model.prefill(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  MAX_LEN, device="cpu")
    assert cache["pos"] == cfg.n_image_tokens + S
    _close(logits, jl)
    _same_cache(cache, jc)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(STEPS):
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok))
        logits, cache = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(cache, jc)
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                      cfg.n_image_tokens + S - 1, device="cpu")


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "mistral-nemo-12b"])
def test_engine_matches_reference_engine(arch):
    """Text-only prompts through both packages' ServeEngine (repro's passes
    only tokens), mistral-nemo with its int8 cache: equal tokens and pool
    statistics over the six calls of test_engine_generates_and_reuses."""
    jcfg, jparams, cfg, params = _both(arch, int8=arch.startswith("mistral"))

    def pool(ogb, pool_cls):
        return pool_cls(ogb(catalog_size=1 << 16, capacity=16, eta=0.3, batch_size=8),
                        page_size=4)

    jpool, tpool = pool(JaxOGB, JaxPool), pool(OGB, PagedKVPool)
    jeng = JaxEngine(jcfg, jparams, pool=jpool, max_len=48)
    teng = ServeEngine(cfg, params, pool=tpool, max_len=48, device="cpu")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    for _ in range(6):
        np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=4),
                                      jeng.generate(prompt, max_new_tokens=4))
        assert dataclasses.asdict(tpool.stats) == dataclasses.asdict(jpool.stats)
    assert teng.stats.prefix_reuse == jeng.stats.prefix_reuse > 0


def test_launcher_serves_the_vlm_on_the_cpu(capsys):
    launcher.main(["--arch", "phi-3-vision-4.2b", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "8 requests" in out and "prefix reuse" in out and "cpu" in out


# -- whisper: the encoder-decoder -------------------------------------------------

def test_encoder_matches_reference():
    jcfg, jparams, cfg, params = _both("whisper-large-v3")
    frames = _batch(cfg)["frames"]
    got = model._encoder_forward(cfg, params, torch.from_numpy(frames))
    _close(got, jmodel._encoder_forward(jcfg, jparams, jnp.asarray(frames)))


def test_encdec_prefill_and_decode_match_reference():
    jcfg, jparams, cfg, params = _both("whisper-large-v3")
    batch = _batch(cfg)
    jl, jc = jmodel.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                            MAX_LEN)
    logits, cache = model.prefill(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  MAX_LEN, device="cpu")
    assert cache["cross_k"].shape == (cfg.n_layers, B, cfg.n_audio_frames, cfg.n_kv_heads,
                                      cfg.head_dim)
    _close(logits, jl)
    _same_cache(cache, jc)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(STEPS):
        jl, jc = step(jparams, jc, jnp.asarray(tok))
        logits, cache = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(cache, jc)


def test_encdec_prefill_matches_token_by_token_decode():
    """tests/models/test_arch_smoke.py::test_prefill_matches_decode on the
    port: prefill of 6 tokens against 6 decode steps from an empty cache
    whose cross K/V are the encoder's, within its 2e-3."""
    _, _, cfg, params = _both("whisper-large-v3")
    batch = _batch(cfg, seed=3, b=1, s=6)
    frames = torch.from_numpy(batch["frames"])
    logits_pre, _ = model.prefill(cfg, params, {"tokens": batch["tokens"], "frames": frames}, 16,
                                  device="cpu")
    cache = model.init_cache(cfg, 1, 16, "cpu")
    enc = model._encoder_forward(cfg, params, frames)
    for i, p in enumerate(params["blocks"]):
        cache["cross_k"][i], cache["cross_v"][i] = attention.project_cross_kv(p["cross"], enc, cfg)
    for t in range(6):
        logits_dec, cache = model.decode_step(cfg, params, cache,
                                              torch.from_numpy(batch["tokens"][:, t]),
                                              device="cpu")
    np.testing.assert_allclose(logits_pre.numpy(), logits_dec.numpy(), atol=2e-3, rtol=2e-3)


def test_encdec_without_frames_raises():
    """repro raises a KeyError for the missing frames; the port a ValueError
    that names them (ROADMAP §3)."""
    jcfg, jparams, cfg, params = _both("whisper-large-v3")
    toks = _batch(cfg)["tokens"]
    with pytest.raises(ValueError, match="frames"):
        model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, MAX_LEN, device="cpu")
    with pytest.raises(KeyError):
        jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        engine.generate(toks, max_new_tokens=2)


def test_cross_attention_decode_matches_reference_forward():
    """A decoded token's cross-attention through the decode wrapper (lengths
    T) against repro's attention_forward(causal=False, kv=...) at S = 1."""
    _, jparams, cfg, params = _both("whisper-large-v3")
    jcfg = jax_smoke("whisper-large-v3")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    T = cfg.n_audio_frames
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    p = params["blocks"][0]["cross"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["cross"])
    got = attention.cross_attention_decode(p, torch.from_numpy(x), torch.from_numpy(ck),
                                           torch.from_numpy(cv), cfg, 5)
    want = jattn.attention_forward(jp, jnp.asarray(x), jcfg, jnp.full((B, 1), 5), causal=False,
                                   kv=(jnp.asarray(ck), jnp.asarray(cv)))
    _close(got, want, KERNEL_TOL)


# -- flash_prefill's non-causal and cross modes ---------------------------------------

@pytest.mark.parametrize("S,T", [(60, 60), (130, 130), (1, 60), (12, 60), (224, 150), (65, 1),
                                 (64, 129), (100, 63)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_non_causal_prefill_plain_matches_reference(S, T, H, Hkv):
    """The plain version at causal=False against repro's jnp flash_attention
    (small chunks: several q and kv chunks, both padded), T != S for
    cross-attention and T no multiple of 64."""
    rng = np.random.default_rng(S * T + H)
    D = 16
    q = rng.normal(size=(2, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(2, T, Hkv, D)).astype(np.float32) for _ in range(2))
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=False)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                 q_chunk=16, kv_chunk=24)
    _close(got, want, KERNEL_TOL)
    assert mode(torch.from_numpy(q), torch.from_numpy(k), False) == (
        "non-causal" if S == T else "cross")


def test_prefill_modes_check_their_shapes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 9, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        flash_prefill(q, k, k)  # causal needs T == S
    assert flash_prefill(q, k, k, causal=False).shape == q.shape
    assert mode(q, q, True) == "causal"
