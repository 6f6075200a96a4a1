"""The port's MoE family against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_forward`` on ``repro``'s own expert weights
(``init_moe``, carried across as numpy) and the same seeded input: the
dense mixture at the granite-moe and kimi-k2 smoke configurations, and
capacity dispatch at a small configuration with E * F > 32 768 and
capacity factors that drop tokens (held within 1e-5 in float32, aux losses
too).  The whole smoke models from ``repro``'s ``init_params``: prefill
and four decode steps within 1e-4, and the serving engine's tokens equal
to ``repro``'s engine's over repeated calls with an OGB page pool.
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
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.ogb import OGB
from repro_torch.models import model, moe
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
TOL = 1e-5


def _dispatch_cfgs(factor):
    """kimi-k2's smoke configuration widened past the dense-mixture limit
    (E * F = 65 536), at capacity ``factor``."""
    kw = dict(n_experts=64, moe_d_ff=1024, capacity_factor=factor)
    return (dataclasses.replace(jax_smoke("kimi-k2-1t-a32b"), **kw),
            dataclasses.replace(get_smoke("kimi-k2-1t-a32b"), **kw))


def _layer(jcfg, seed):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _held(jcfg, cfg, seed, shape):
    jp, p = _layer(jcfg, seed)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=TOL, rtol=TOL)
    return p, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 16), (3, 1)], ids=["prefill", "decode"])
def test_dense_mixture_matches_reference(arch, shape):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    assert cfg.n_experts * cfg.expert_ff <= moe.DENSE_MIXTURE_MAX
    _held(jcfg, cfg, 1, shape + (cfg.d_model,))


@pytest.mark.parametrize("factor", [1.0, 0.5, 8.0])
def test_capacity_dispatch_matches_reference(factor):
    jcfg, cfg = _dispatch_cfgs(factor)
    assert cfg.n_experts * cfg.expert_ff > moe.DENSE_MIXTURE_MAX
    p, x = _held(jcfg, cfg, 2, (2, 16, cfg.d_model))
    # the tokens past an expert's capacity were dropped (none at factor 8)
    r = moe.route(p, torch.from_numpy(x).reshape(32, -1), cfg.experts_per_token)
    cap = moe.capacity(32, cfg)
    dropped = int((moe.dispatch(r, cfg.n_experts, cap) == cfg.n_experts * cap).sum())
    per_expert = torch.bincount(r.eidx.reshape(-1), minlength=cfg.n_experts)
    assert dropped == int((per_expert - cap).clamp_min(0).sum())
    assert (dropped > 0) == (factor < 8.0)


def test_dispatch_keeps_the_first_assignments_of_an_expert():
    """A stable sort: within an expert the lowest (token, k) assignments
    take the slots, in order; the rest are dropped."""
    eidx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1], [2, 0]])
    r = moe.Routing(None, torch.zeros(5, 3), torch.ones(5, 2) / 2, eidx)
    spare = 6
    assert moe.dispatch(r, 3, 2).tolist() == [0, 2, 1, 4, 3, spare, spare, spare, 5, spare]


@pytest.mark.parametrize("tokens,factor", [(1, 1.0), (2, 1.0), (33, 1.25), (96, 1.0),
                                           (512, 1.0), (40, 1.5)])
def test_capacity_rounds_as_the_reference(tokens, factor):
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b"), capacity_factor=factor)
    want = int(max(1, round(tokens * cfg.experts_per_token / cfg.n_experts * factor)))
    assert moe.capacity(tokens, cfg) == want


def _both(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_weights_carry_across(arch):
    jcfg, jparams, cfg, params = _both(arch)
    assert all("moe" in b and "mlp" not in b for b in params["blocks"])
    np.testing.assert_array_equal(params["blocks"][1]["moe"]["w_down"].numpy(),
                                  np.asarray(jparams["blocks"]["moe"]["w_down"][1]))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == n
    bf = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu",
                                 dtype=torch.bfloat16)
    assert bf["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert bf["blocks"][0]["moe"]["w_gate"].dtype == torch.bfloat16
    # the port's own draw: the reference's shapes, types and scales
    own = model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(bf)):
        assert a.shape == b.shape and a.dtype == b.dtype
    wg = own["blocks"][0]["moe"]["w_gate"].float()
    assert abs(float(wg.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(own["blocks"][0]["moe"]["router"].std()) * np.sqrt(cfg.d_model) - 1) < 0.1
    cast = model.cast_params_for_compute(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                                         params)
    assert cast["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert cast["blocks"][0]["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_reference(arch):
    jcfg, jparams, cfg, params = _both(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 24)
    logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, 24,
                                  device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jc["kv"]["k"]), atol=1e-4,
                               rtol=1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok))
        logits, cache = model.decode_step(cfg, params, cache, torch.from_numpy(tok),
                                          device="cpu")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jc["kv"]["v"]), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_matches_reference_engine(arch):
    jcfg, jparams, cfg, params = _both(arch)

    def pool(ogb, pool_cls):
        return pool_cls(ogb(catalog_size=1 << 16, capacity=16, eta=0.3, batch_size=8),
                        page_size=4)

    jpool, tpool = pool(JaxOGB, JaxPool), pool(OGB, PagedKVPool)
    jeng = JaxEngine(jcfg, jparams, pool=jpool, max_len=40)
    teng = ServeEngine(cfg, params, pool=tpool, max_len=40, device="cpu")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    for _ in range(4):
        np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=4),
                                      jeng.generate(prompt, max_new_tokens=4))
        assert dataclasses.asdict(tpool.stats) == dataclasses.asdict(jpool.stats)
    assert teng.stats.prefix_reuse == jeng.stats.prefix_reuse > 0.1


def test_launcher_serves_granite_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "granite-moe-1b-a400m", "--steps", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] step   10" in out and "40 requests" in out and "on cpu" in out
