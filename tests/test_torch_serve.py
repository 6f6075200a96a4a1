"""The port's dense serving slice against the JAX package's, per model.

For the smoke configurations of glm4-9b, qwen3-14b and gemma-7b, the port
runs on ``repro``'s own weights (``init_params(cfg, jax.random.key(0))``,
carried across with ``params_from_numpy``) on the CPU, where the attention
kernels' wrappers run their plain versions.  Prefill logits and KV cache and
four decode steps agree with ``repro``'s within 1e-4 (float32 sums in
another order through two layers); the engine gives the same tokens as
``repro``'s ``ServeEngine`` over the calls of
``tests/serve/test_serve.py::test_engine_generates_and_reuses``, with an
OGB page pool on each side whose statistics are equal field by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke as jax_smoke
from repro.core.ogb import OGB as JaxOGB
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs.base import get_smoke
from repro_torch.core.ogb import OGB
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCHS = ["glm4-9b", "qwen3-14b", "gemma-7b"]


def _both(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_across(arch):
    jcfg, jparams, cfg, params = _both(arch)
    assert len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(params["blocks"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["blocks"]["attn"]["wq"][1]))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == n
    # the port's own draw has the same shapes, types and scales
    own = model.init_params(cfg, seed=0, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(float(own["embed"].std()) - 0.02) < 0.002
    wd = own["blocks"][0]["mlp"]["w_down"]
    assert abs(float(wd.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jparams, cfg, params = _both(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 48)
    logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, 48,
                                  device="cpu")
    assert logits.shape == (2, model.padded_vocab(cfg)) and cache["pos"] == 16
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        assert cache[name].shape == jc["kv"][name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc["kv"][name]),
                                   atol=1e-4, rtol=1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok))
        logits, same = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        assert same is cache
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert cache["pos"] == 20 == int(jc["pos"])
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jc["kv"]["v"]), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """The calls of test_engine_generates_and_reuses, on both packages."""
    jcfg, jparams, cfg, params = _both(arch)

    def pool(ogb, pool_cls):
        return pool_cls(ogb(catalog_size=1 << 16, capacity=16, eta=0.3, batch_size=8),
                        page_size=4)

    jpool, tpool = pool(JaxOGB, JaxPool), pool(OGB, PagedKVPool)
    jeng = JaxEngine(jcfg, jparams, pool=jpool, max_len=48)
    teng = ServeEngine(cfg, params, pool=tpool, max_len=48, device="cpu")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    outs = []
    for _ in range(6):
        want = jeng.generate(prompt, max_new_tokens=4)
        got = teng.generate(prompt, max_new_tokens=4)
        assert got.shape == (2, 4) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(tpool.stats) == dataclasses.asdict(jpool.stats)
        outs.append(got)
    assert teng.stats.prefix_reuse == jeng.stats.prefix_reuse > 0.2
    assert (teng.stats.requests, teng.stats.prefill_tokens, teng.stats.prefill_tokens_skipped,
            teng.stats.decode_tokens) == (jeng.stats.requests, jeng.stats.prefill_tokens,
                                          jeng.stats.prefill_tokens_skipped,
                                          jeng.stats.decode_tokens)
    np.testing.assert_array_equal(outs[0], outs[-1])  # greedy decode repeats


def test_engine_casts_weights_once():
    cfg = dataclasses.replace(get_smoke("glm4-9b"), compute_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device="cpu")
    assert params["embed"].dtype == torch.float32
    engine = ServeEngine(cfg, params, max_len=24, device="cpu")
    assert engine.params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    again = model.cast_params_for_compute(cfg, engine.params)
    assert again["blocks"][0]["attn"]["wq"] is engine.params["blocks"][0]["attn"]["wq"]
    out = engine.generate(np.ones((2, 8), np.int32), max_new_tokens=3)
    assert out.shape == (2, 3) and (out >= 0).all() and (out < cfg.vocab_size).all()
