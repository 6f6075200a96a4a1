"""The port's RWKV-6 (the ssm family, rwkv6-1.6b) against the JAX package's.

The smoke configuration in float32 on ``repro``'s own weights
(``init_params(cfg, jax.random.key(0))``, carried across by
``params_from_numpy``), inputs from numpy seeds, on the CPU, where the
``wkv6`` wrapper runs its plain version.  Tolerances:

* the plain recurrence against ``repro``'s ``_wkv_scan``: 1e-5 of the
  largest magnitude of y and of the state (float32 on both sides; XLA's
  einsum sums over i in its own order);
* the layers, logits and every cache entry: 1e-4 (float32 products summed
  in another order through two layers, as in tests/test_torch_serve.py);
* prefill of S tokens against prefill of S - 1 and one decode step: 1e-5,
  the same arithmetic in the same order on one side, the recurrence split
  at the last step on the other.

The CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py phase 26).
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
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.ogb import OGB
from repro_torch.kernels import launch_counts
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import common, model, rwkv
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCH = "rwkv6-1.6b"
TOL = 1e-4
SCAN_TOL = 1e-5
B, S, STEPS = 2, 12, 8
CACHE = ("tm_x", "tm_s", "cm_x")


def _both(cfg=None, jcfg=None):
    jcfg, cfg = jcfg or jax_smoke(ARCH), cfg or get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _close_to_largest(got, want, tol=SCAN_TOL):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def _same_cache(cache, jcache, tol=TOL):
    for name in CACHE:
        assert cache[name].dtype == {"float32": torch.float32}[str(jcache[name].dtype)]
        _close(cache[name], jcache[name], tol)
    assert cache["pos"] == int(jcache["pos"])


def _block(params, jparams, i=0):
    return params["blocks"][i], jax.tree_util.tree_map(lambda a: a[i], jparams["blocks"])


def test_configs_are_the_reference_configs():
    for get, jget in ((get_arch, jax_arch), (get_smoke, jax_smoke)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size) == (24, 2048, 7168, 65536)
    assert full.d_model // full.rwkv_head_dim == 32


def test_weights_carry_across_and_the_block_count_is_exact():
    jcfg, jparams, cfg, params = _both()
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == n
    assert len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(params["blocks"][1]["w_k"].numpy(),
                                  np.asarray(jparams["blocks"]["w_k"][1]))
    # the port's own draw has the same tree, shapes and types; w0 and u float32
    own = model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    for block in own["blocks"]:
        assert block["w0"].dtype == block["u"].dtype == torch.float32
        assert block["w_k"].dtype == torch.bfloat16
        assert abs(float(block["w0"].mean()) + 6.0) < 0.1 and float(block["u"].std()) < 0.2
    assert sum(t.numel() for t in own["blocks"][0].values()) == rwkv.block_params(cfg)
    # at full width, from the reference's shapes alone (nothing is allocated)
    full = jax_arch(ARCH)
    shapes = jax.eval_shape(lambda: jmodel.init_params(full, jax.random.key(0)))
    n_full = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    pv = model.padded_vocab(full)
    assert n_full == 2 * pv * full.d_model + full.d_model + full.n_layers * rwkv.block_params(full)
    assert n_full == 1_583_941_632


def test_shift_tokens_is_the_reference():
    x = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    from repro.models.common import shift_tokens as jshift

    np.testing.assert_array_equal(common.shift_tokens(torch.from_numpy(x)).numpy(),
                                  np.asarray(jshift(jnp.asarray(x))))


def _scan_inputs(b=2, s=33, h=4, n=16, seed=0, zero_state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(-6.0 + rng.normal(size=(b, s, h, n)) * 2.0)).astype(np.float32)
    u = (rng.normal(size=(h, n)) * 0.1).astype(np.float32)
    state = (np.zeros((b, h, n, n)) if zero_state else rng.normal(size=(b, h, n, n)) * 3.0)
    return r, k, v, w, u, state.astype(np.float32)


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero state", "random state"])
def test_plain_recurrence_matches_the_reference_scan(zero_state):
    arrays = _scan_inputs(zero_state=zero_state)
    y, final = wkv6_ref(*(torch.from_numpy(a) for a in arrays))
    jy, jfinal = jrwkv._wkv_scan(*(jnp.asarray(a) for a in arrays))
    assert y.shape == (2, 33, 4, 16) and final.shape == (2, 4, 16, 16)
    _close_to_largest(y, jy)
    _close_to_largest(final, jfinal)
    # the wrapper on CPU tensors: the plain version, the state written in place
    state = torch.from_numpy(arrays[-1].copy())
    before = launch_counts()["wkv6"]
    wy, same = wkv6(*(torch.from_numpy(a) for a in arrays[:-1]), state)
    assert same is state and launch_counts()["wkv6"] == before
    assert torch.equal(wy, y) and torch.equal(state, final)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    r, k, v, w, u, state = (torch.from_numpy(a) for a in _scan_inputs(s=3))
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:, :8], state)
    with pytest.raises(ValueError, match="state must be"):
        wkv6(r, k, v, w, u, state[:1])
    with pytest.raises(ValueError, match="one"):
        wkv6(r, k[:, :2], v, w, u, state)
    meta = [t.to("meta") for t in (r, k, v, w, u, state)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6(*meta)
    odd = [torch.zeros(1, 2, 1, 8, device="meta")] * 4
    with pytest.raises(ValueError, match="head dim 8"):
        wkv6(*odd, torch.zeros(1, 8, device="meta"), torch.zeros(1, 1, 8, 8, device="meta"))


def _layer_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    state = (rng.normal(size=(B, d)).astype(np.float32),
             rng.normal(size=(B, d // hd, hd, hd)).astype(np.float32),
             rng.normal(size=(B, d)).astype(np.float32))
    return x, state


@pytest.mark.parametrize("with_state", [False, True], ids=["no state", "state"])
def test_layers_match_the_reference(with_state):
    _, jparams, cfg, params = _both()
    p, jp = _block(params, jparams, 1)
    x, state = _layer_inputs(cfg)
    tx = torch.from_numpy(x)
    _close(rwkv._decay(p, tx), jrwkv._decay(jp, jnp.asarray(x)))

    def ours(i):
        return None if not with_state else torch.from_numpy(state[i].copy())

    def theirs(i):
        return None if not with_state else jnp.asarray(state[i])

    tm = None if not with_state else (ours(0), ours(1))
    out, (last, s_final) = rwkv.rwkv_time_mix(p, tx, cfg, tm)
    jout, (jlast, js) = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), cfg,
                                            None if not with_state else (theirs(0), theirs(1)))
    _close(out, jout)
    _close(last, jlast)
    _close(s_final, js)
    if with_state:  # the kernel's wrapper wrote the final state into the one given
        assert s_final is tm[1]
    out, last = rwkv.rwkv_channel_mix(p, tx, ours(2))
    jout, jlast = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x), theirs(2))
    _close(out, jout)
    _close(last, jlast)
    st = None if not with_state else tuple(ours(i) for i in range(3))
    out, new = rwkv.rwkv_block_fwd(p, tx, cfg, st)
    jout, jnew = jrwkv.rwkv_block_fwd(jp, jnp.asarray(x), cfg,
                                      None if not with_state else tuple(theirs(i)
                                                                        for i in range(3)))
    _close(out, jout)
    for a, b in zip(new, jnew):
        _close(a, b)


def test_prefill_and_decode_match_reference():
    jcfg, jparams, cfg, params = _both()
    toks = _tokens(cfg)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 4)
    logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, 4,
                                  device="cpu")  # max_len 4 < S: an ssm prefill checks none
    _close(logits, jl)
    _same_cache(cache, jc)
    state_at = cache["tm_s"].data_ptr()
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(STEPS):
        jl, jc = step(jparams, jc, jnp.asarray(tok))
        logits, same = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        assert same is cache and cache["tm_s"].data_ptr() == state_at  # in place, no copy
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(cache, jc)
    jempty = jmodel.init_cache(jcfg, B, 16)
    empty = model.init_cache(cfg, B, 16, "cpu")
    assert set(empty) == set(jempty)
    for name in CACHE:
        assert tuple(empty[name].shape) == jempty[name].shape


def test_bf16_compute_keeps_w0_and_u_in_float32():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="bfloat16")
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    arrays = jax.tree_util.tree_map(np.asarray, jparams)
    jcast = jmodel.cast_params_for_compute(jcfg, jparams)
    for params in (model.cast_params_for_compute(cfg, model.params_from_numpy(cfg, arrays, "cpu")),
                   model.params_from_numpy(cfg, arrays, "cpu", dtype=torch.bfloat16)):
        for i, block in enumerate(params["blocks"]):
            for name, leaf in block.items():
                want = torch.float32 if name in ("w0", "u") else torch.bfloat16
                assert leaf.dtype == want, name
                assert str(jcast["blocks"][name].dtype) == str(want).split(".")[1], name
            np.testing.assert_array_equal(block["w0"].numpy(), arrays["blocks"]["w0"][i])
        logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(_tokens(cfg))},
                                      16, device="cpu")
        assert cache["tm_x"].dtype == torch.bfloat16 and cache["tm_s"].dtype == torch.float32
        logits, cache = model.decode_step(cfg, params, cache, torch.tensor([3, 4]), device="cpu")
        assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


def test_prefill_equals_shorter_prefill_then_one_decode_step():
    _, _, cfg, params = _both()
    toks = torch.from_numpy(_tokens(cfg, seed=5))
    long_logits, long_cache = model.prefill(cfg, params, {"tokens": toks}, 0, device="cpu")
    logits, cache = model.prefill(cfg, params, {"tokens": toks[:, :-1]}, 0, device="cpu")
    logits, cache = model.decode_step(cfg, params, cache, toks[:, -1], device="cpu")
    _close(logits, long_logits.numpy(), SCAN_TOL)
    for name in CACHE:
        _close(cache[name], long_cache[name].numpy(), SCAN_TOL)
    assert cache["pos"] == long_cache["pos"] == S


def test_engine_matches_reference_engine():
    """Both packages' ServeEngine over the same pool: equal tokens and pool
    statistics over six calls."""
    jcfg, jparams, cfg, params = _both()

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


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    launcher.main(["--arch", ARCH, "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "8 requests" in out and "prefix reuse" in out and "cpu" in out
