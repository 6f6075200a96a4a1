"""The port's attention kernels' plain versions and attention module against
the JAX package's.

On a CPU tensor ``decode_attention`` and ``flash_prefill`` run their plain
PyTorch versions, so these tests hold that arithmetic against the Pallas
kernels in interpret mode (as the JAX package's own tests run them) and
against their jnp oracles, at the shapes of
``tests/kernels/test_decode_attention.py`` and
``tests/kernels/test_flash_prefill.py``, with their float32 tolerance of
2e-5.  The attention module is held against ``repro.models.attention``'s
jnp paths (``use_pallas`` off, the chunked ``flash_attention``) at 1e-5.
The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import get_smoke as jax_smoke
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_prefill.ops import flash_prefill as jax_prefill
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_prefill_ref
from repro.models import attention as jattn
from repro_torch.configs.base import get_smoke
from repro_torch.kernels import launch_counts
from repro_torch.configs.base import get_arch
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.kernel import TILE, mma_grid_plan, split_plan
from repro_torch.kernels.flash_prefill import kernel as prefill_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.models import attention


def _decode_inputs(B, H, Hkv, D, S, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, size=B)
    return q, k, v, np.asarray(lengths, np.int32)


def _prefill_inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize(
    "B,H,Hkv,D,S",
    [
        (2, 8, 8, 64, 256),  # MHA
        (2, 8, 2, 64, 256),  # GQA 4:1
        (1, 16, 1, 128, 512),  # MQA
        (3, 4, 4, 128, 130),  # ragged S
    ],
)
def test_decode_plain_matches_pallas_and_oracle(B, H, Hkv, D, S):
    arrays = _decode_inputs(B, H, Hkv, D, S, 0)
    before = launch_counts()
    got = decode_attention(*_t(*arrays)).numpy()
    j = tuple(map(jnp.asarray, arrays))
    np.testing.assert_allclose(got, np.asarray(jax_decode(*j, s_block=128, interpret=True)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*j)), atol=2e-5, rtol=2e-5)
    assert launch_counts() == before  # the plain version is no launch


def test_decode_plain_short_lengths():
    """Lengths 1 and 3: only the first block holds data."""
    arrays = _decode_inputs(2, 4, 2, 64, 512, 9, lengths=[1, 3])
    got = decode_attention(*_t(*arrays)).numpy()
    j = tuple(map(jnp.asarray, arrays))
    np.testing.assert_allclose(got, np.asarray(jax_decode(*j, s_block=128, interpret=True)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*j)), atol=2e-5, rtol=2e-5)
    assert np.isfinite(got).all()


def test_decode_plain_bf16():
    q, k, v, lengths = _decode_inputs(2, 8, 4, 64, 256, 3)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = decode_attention(*bf, torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jax_decode(jq, jk, jv, jnp.asarray(lengths), s_block=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize(
    "B,S,H,Hkv,D",
    [
        (1, 256, 4, 4, 64),  # MHA
        (2, 256, 8, 2, 64),  # GQA 4:1
        (1, 512, 4, 1, 128),  # MQA
        (1, 200, 4, 4, 64),  # ragged S
    ],
)
def test_prefill_plain_matches_pallas_and_oracle(B, S, H, Hkv, D):
    arrays = _prefill_inputs(B, S, H, Hkv, D, 0 if S != 200 else 2)
    before = launch_counts()
    got = flash_prefill(*_t(*arrays)).numpy()
    j = tuple(map(jnp.asarray, arrays))
    np.testing.assert_allclose(
        got, np.asarray(jax_prefill(*j, block_q=128, block_k=128, interpret=True)),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_prefill_ref(*j)), atol=2e-5, rtol=2e-5)
    assert launch_counts() == before


def test_prefill_plain_bf16():
    q, k, v = _prefill_inputs(1, 256, 4, 2, 64, 3)
    got = flash_prefill(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = jax_prefill_ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("bad", ["rank", "group", "lengths"])
def test_wrappers_reject_bad_shapes(bad):
    q, k, v, lengths = _t(*_decode_inputs(2, 8, 2, 16, 64, 1))
    if bad == "rank":
        with pytest.raises(ValueError):
            flash_prefill(q, k, v)
    elif bad == "group":
        with pytest.raises(ValueError, match="multiple"):
            decode_attention(q[:, :7], k, v, lengths)
    else:
        with pytest.raises(ValueError, match="lengths"):
            decode_attention(q, k, v, lengths[:1])


@pytest.mark.parametrize("B,Hkv,S", [(8, 2, 32768), (8, 2, 2080), (8, 16, 4096), (1, 1, 1),
                                     (4, 8, 130), (128, 8, 64)])
def test_decode_split_covers_the_cache_once(B, Hkv, S):
    """Both designs' splits: whole tiles, no empty split, and one wave of
    the split pass where the cache allows it (the CUDA-core design at 2
    blocks an SM; the mma design at most as many as its ring lets an SM
    hold, with a block a 16-query row tile of the group: glm4-9b's 16,
    qwen3-14b's 5, gemma-7b's 1 and a group of 40 that takes 3 row tiles)."""
    n_splits, split_len = split_plan(B, Hkv, S, 132)
    assert split_len % TILE == 0
    assert (n_splits - 1) * split_len < S <= n_splits * split_len  # no empty split
    assert B * Hkv * n_splits <= 2 * 132 or n_splits == 1  # one wave where it can
    for g, D in ((16, 128), (5, 128), (1, 256), (40, 64)):
        n_splits, split_len = mma_grid_plan(B, g * Hkv, Hkv, S, D, 132)
        blocks = B * Hkv * -(-g // 16) * n_splits
        assert split_len % TILE == 0
        assert (n_splits - 1) * split_len < S <= n_splits * split_len
        assert blocks <= decode_kernel.decode_plan(D)["blocks_per_sm"] * 132 or n_splits == 1
        assert mma_grid_plan(B, g * Hkv, Hkv, S, D, 132) == (n_splits, split_len)


def test_decode_split_of_the_served_caches():
    """glm4-9b at B=8 on 132 SMs: the serving cache (S = 2080) in 7 splits
    of 5 tiles, 112 blocks, one an SM (11 splits of 3 would put 6 tiles on
    44 SMs), and S = 32 768 in 16 splits of 32 tiles, 256 blocks, two an SM
    (8 of 64 put as many tiles on an SM); the CUDA-core design keeps its
    fewest-tiles rule (11 of 3 at S = 2080)."""
    assert decode_kernel.decode_plan(128)["blocks_per_sm"] == 2
    assert mma_grid_plan(8, 32, 2, 2080, 128, 132) == (7, 5 * TILE)
    assert mma_grid_plan(8, 32, 2, 32768, 128, 132) == (16, 32 * TILE)
    assert split_plan(8, 2, 2080, 132) == (11, 3 * TILE)


SERVED = ["glm4-9b", "qwen3-14b", "gemma-7b"]


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_attention_design_by_dtype_and_head_dim(arch, smoke):
    """The served configurations' bf16 shapes take the tensor-core designs,
    float32 the CUDA-core ones; the smoke configurations' head_dim 16 is no
    multiple of 64, so their prefill takes the CUDA-core design in both."""
    D = (get_smoke if smoke else get_arch)(arch).head_dim
    assert D == (16 if smoke else (256 if arch == "gemma-7b" else 128))
    bf, f32 = torch.bfloat16, torch.float32
    assert prefill_kernel.design(bf, D) == (prefill_kernel.CUDA_CORE if smoke else "wgmma+tma")
    assert decode_kernel.design(bf, D) == "mma.sync+cp.async"
    assert prefill_kernel.design(f32, D) == prefill_kernel.CUDA_CORE == "cuda-core"
    assert decode_kernel.design(f32, D) == decode_kernel.CUDA_CORE == "cuda-core"


@pytest.mark.parametrize("D", [8, 16, 24, 48, 64, 96, 128, 192, 200, 256, 320])
def test_design_edges(D):
    """bf16 prefill takes the wgmma design at the multiples of 64 up to 256
    and at phi-3-vision's 96; decode the mma design at multiples of 16."""
    bf = torch.bfloat16
    assert (prefill_kernel.design(bf, D) == "wgmma+tma") == (
        (D % 64 == 0 or D == 96) and D <= 256)
    assert (decode_kernel.design(bf, D) == "mma.sync+cp.async") == (D % 16 == 0 and D <= 256)


@pytest.mark.parametrize("D,key_tile", [(64, 128), (128, 128), (192, 64), (256, 64)])
def test_prefill_plan_fits_shared_memory(D, key_tile):
    """Two warpgroups of 64 query rows, a 2-stage K/V ring, and the shared
    memory the wrapper hands to the launch within an H100 block's 232 448
    bytes: Q, two stages of K and V, the ring's mbarriers (128 bytes), 1024
    bytes of alignment."""
    plan = prefill_kernel.prefill_plan(D)
    assert (plan["tile_rows"], plan["key_tile"], plan["stages"]) == (128, key_tile, 2)
    ring = 2 * plan["stages"] * key_tile * D * 2
    assert plan["smem_bytes"] == 1024 + 128 * D * 2 + ring + 128
    assert plan["smem_bytes"] <= 232_448


@pytest.mark.parametrize("D,blocks", [(16, 12), (64, 4), (128, 2), (256, 1)])
def test_decode_plan_fits_shared_memory(D, blocks):
    """A ring of 3 tiles of 64 positions of K and V, rows padded by 16 bytes."""
    plan = decode_kernel.decode_plan(D)
    assert (plan["tile"], plan["stages"]) == (TILE, 3)
    assert plan["smem_bytes"] == 3 * 2 * TILE * (D + 8) * 2 <= 232_448
    assert plan["blocks_per_sm"] == blocks


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": rng.normal(size=(d, h * hd)) / np.sqrt(d),
        "wk": rng.normal(size=(d, kv * hd)) / np.sqrt(d),
        "wv": rng.normal(size=(d, kv * hd)) / np.sqrt(d),
        "wo": rng.normal(size=(h * hd, d)) / np.sqrt(h * hd),
    }
    if cfg.qk_norm:
        p["q_norm"] = 1.0 + 0.1 * rng.normal(size=hd)
        p["k_norm"] = 1.0 + 0.1 * rng.normal(size=hd)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, {k: torch.from_numpy(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}


ARCHS = SERVED


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_attention_matches_chunked_flash(arch):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    _, tp, jp = _attn_params(cfg, 5)
    B, S = 2, 40
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    q, k, v = attention._project_qkv(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()))
    jq, jk, jv = jattn._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for a, b in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    got = attention.flash_attention(q, k, v, causal=True).numpy()
    # small chunks, so the chunked jnp path runs several q and kv chunks and pads both
    want = jattn.flash_attention(jq, jk, jv, causal=True, q_chunk=16, kv_chunk=24)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_kv_cache_matches_reference(arch):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    cache = attention.init_kv_cache(cfg, 3, 24, torch.float32, "cpu")
    jcache = jattn.init_kv_cache(jcfg, 3, 24, jnp.float32)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape and not cache[name].any()
    # an int8 cache: int8 codes and float32 scales a (position, KV head), repro's layout
    cache = attention.init_kv_cache(dataclasses.replace(cfg, kv_cache_dtype="int8"), 3, 24,
                                    torch.float32, "cpu")
    jcache = jattn.init_kv_cache(dataclasses.replace(jcfg, kv_cache_dtype="int8"), 3, 24,
                                 jnp.float32)
    assert sorted(cache) == sorted(jcache) == ["k", "k_scale", "v", "v_scale"]
    for name in cache:
        assert cache[name].shape == jcache[name].shape and not cache[name].any()
        assert str(cache[name].dtype).split(".")[-1] == str(jcache[name].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_matches_jnp_path(arch):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    _, tp, jp = _attn_params(cfg, 7)
    B, S, pos = 3, 24, 9
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    out, same = attention.attention_decode(tp, torch.from_numpy(x), cache, pos, cfg)
    assert same is cache
    jout, jcache = jattn.attention_decode(jp, jnp.asarray(x), {"k": jnp.asarray(ck),
                                          "v": jnp.asarray(cv)}, jnp.int32(pos), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):  # the new token written in place, the rest untouched
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        attention.attention_decode(tp, torch.from_numpy(x), cache, S, cfg)
