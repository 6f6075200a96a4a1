"""The port's jamba (the hybrid family) against the JAX package's.

The smoke configuration in float32 on ``repro``'s own weights
(``init_params(cfg, jax.random.key(0))``, carried across by
``params_from_numpy``), inputs from numpy seeds, on the CPU, where the
``selective_scan`` wrapper runs its plain version.  Tolerances:

* the convolution against ``repro``'s ``_causal_conv``: 1e-6 (the same four
  float32 products and adds in the same order);
* the plain scan against a float64 numpy loop of the same recurrence: 1e-5
  of the largest magnitude of y and of the state (float32 rounding over
  13 steps, and einsum's own order of the sum over n);
* ``mamba_forward`` against ``repro``'s: 1e-5 of the largest magnitude of
  y, the convolution state and h (float32 products summed in another
  order);
* the layers, logits and every cache entry: 1e-4 (float32 products summed
  in another order through four layers, as in tests/test_torch_serve.py);
* prefill of S tokens against prefill of S - 1 and one decode step: 1e-5,
  the same arithmetic on both sides but the last token's products, run in
  a batch of S rows on one side and of one row on the other.

The CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py phase 27).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from repro.configs.base import get_arch as jax_arch
from repro.configs.base import get_smoke as jax_smoke
from repro.core.ogb import OGB as JaxOGB
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import base
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.ogb import OGB
from repro_torch.kernels import launch_counts
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import mamba, model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4
SCAN_TOL = 1e-5
CONV_TOL = 1e-6
B, S, MAX_LEN, STEPS = 2, 12, 24, 8
CACHE = ("k", "v", "conv", "ssm")
F32_LEAVES = ("A_log", "dt_bias", "D", "router")
#: the depth cut that chip_smoke.py serves: one super-block of 4 layers at
#: full width, its parameters counted from repro's init_params by eval_shape
CUT_PARAMS = 23_776_305_152


def _both(cfg=None, jcfg=None):
    jcfg, cfg = jcfg or jax_smoke(ARCH), cfg or get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _close_to_largest(got, want, tol=SCAN_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def _ref_cache(jcache):
    """repro's hybrid cache in the port's names (its K and V under ``kv``)."""
    return {"k": jcache["kv"]["k"], "v": jcache["kv"]["v"], "conv": jcache["conv"],
            "ssm": jcache["ssm"], "pos": jcache["pos"]}


def _same_cache(cache, jcache, tol=TOL):
    want = _ref_cache(jcache)
    for name in CACHE:
        assert str(cache[name].dtype) == f"torch.{want[name].dtype}", name
        assert tuple(cache[name].shape) == want[name].shape, name
        _close(cache[name], want[name], tol)
    assert cache["pos"] == int(want["pos"])


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_names(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_configs_are_the_reference_configs():
    assert base.NOT_PORTED == ()
    for get, jget in ((get_arch, jax_arch), (get_smoke, jax_smoke)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    full = get_arch(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.attn_period) == ("hybrid", 72, 8192, 8)
    assert (full.ssm_expand * full.d_model, full.ssm_state_dim, full.n_experts) == (16384, 16, 16)
    assert ARCH in base.list_archs()


def test_weights_carry_across_with_each_layer_kind():
    jcfg, jparams, cfg, params = _both()
    period = cfg.attn_period
    kinds = [("attn" if "attn" in b else "mamba", "moe" if "moe" in b else "mlp")
             for b in params["blocks"]]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("attn", "moe")]
    for i, block in enumerate(params["blocks"]):
        sb, j = divmod(i, period)
        want = jax.tree_util.tree_map(lambda a: np.asarray(a[sb]), jparams["blocks"][j])
        got, ref = dict(_leaf_names(block)), dict(_leaf_names(want))
        assert got.keys() == ref.keys()
        for name, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(), ref[name])
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sum(t.numel() for _, t in _leaf_names(params)) == n
    # the port's own draw: the same leaves and shapes, the dynamics and the
    # router float32 under a bf16 param_dtype, repro's scales and values
    own = model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    got, ref = dict(_leaf_names(own)), dict(_leaf_names(params))
    assert got.keys() == ref.keys()
    for name, leaf in got.items():
        assert leaf.shape == ref[name].shape, name
        want = torch.float32 if name.split("/")[-1] in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, name
    p = own["blocks"][0]["mamba"]
    torch.testing.assert_close(p["A_log"], torch.log(torch.arange(1.0, 9.0)).expand(128, 8))
    assert float(p["dt_bias"].abs().max()) == 0 and bool((p["D"] == 1).all())
    assert 0.09 < float(p["conv_w"].float().std()) < 0.11
    assert 0.009 < float(p["w_dt"].float().std()) < 0.011
    assert sum(t.numel() for t in p.values()) == mamba.mamba_params(cfg)


def test_parameter_counts_are_exact_leaf_by_leaf():
    """ArchConfig.param_count leaves out w_dt's d_in^2 a Mamba layer (and its
    convolution and A_log): chip_smoke.py's expected_params counts the
    hybrid leaf by leaf, here held to repro's own init_params, at smoke and
    at the cut served on the card (nothing is allocated: eval_shape)."""
    _, jparams, cfg, _ = _both()
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert chip_smoke.expected_params(cfg) == n
    cut = dataclasses.replace(jax_arch(ARCH), n_layers=4, attn_period=4)
    shapes = jax.eval_shape(lambda: jmodel.init_params(cut, jax.random.key(0)))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert sum(int(np.prod(x.shape)) for x in leaves) == CUT_PARAMS
    assert chip_smoke.expected_params(chip_smoke.jamba_cut()) == CUT_PARAMS
    f32 = sum(int(np.prod(x.shape)) for x in leaves if x.dtype == jnp.float32)
    assert f32 == 1_146_880  # A_log, dt_bias, D of 3 Mamba layers, 2 routers
    assert chip_smoke.jamba_cut().param_count() < CUT_PARAMS


def test_bf16_compute_keeps_the_ssm_dynamics_in_float32():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="bfloat16")
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    arrays = jax.tree_util.tree_map(np.asarray, jparams)
    jcast = dict(_leaf_names(jax.tree_util.tree_map(
        lambda a: str(a.dtype), jmodel.cast_params_for_compute(jcfg, jparams))))
    for params in (model.cast_params_for_compute(cfg, model.params_from_numpy(cfg, arrays, "cpu")),
                   model.params_from_numpy(cfg, arrays, "cpu", dtype=torch.bfloat16)):
        for i, block in enumerate(params["blocks"]):
            sb, j = divmod(i, cfg.attn_period)
            for name, leaf in _leaf_names(block):
                want = torch.float32 if name.split("/")[-1] in F32_LEAVES else torch.bfloat16
                assert leaf.dtype == want, name
                assert jcast[f"/blocks/{j}{name}"] == str(want).split(".")[1], name
        logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(_tokens(cfg))},
                                      MAX_LEN, device="cpu")
        assert cache["conv"].dtype == cache["k"].dtype == torch.bfloat16
        assert cache["ssm"].dtype == torch.float32
        logits, cache = model.decode_step(cfg, params, cache, torch.tensor([3, 4]), device="cpu")
        assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    # no other leaf of any served model is named like a Mamba dynamics leaf
    for arch in base.list_archs():
        smoke = get_smoke(arch)
        for name, _ in _leaf_names(model.init_params(smoke, device="cpu")):
            if name.split("/")[-1] in ("A_log", "dt_bias", "D"):
                assert "/mamba/" in name, (arch, name)


def test_chip_smoke_names_the_kernel():
    """chip_smoke.py's tables name the kernel's source, the loop it replaces
    and the design its wrapper counts."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import kernel

    assert chip_smoke.DESIGNS["selective_scan"] == kernel.DESIGN
    assert chip_smoke.SCAN_STEP_DESIGN == kernel.DESIGN_STEP
    assert chip_smoke.SOURCES["selective_scan"].endswith(
        str(_build.sources()["selective_scan"].relative_to(chip_smoke.ROOT)))
    path, line = chip_smoke.REPLACES["selective_scan"].split(":")  # the scan's step, then the scan
    lines = (chip_smoke.ROOT / path).read_text().splitlines()[int(line) - 1:int(line) + 9]
    assert lines[0].strip().startswith("def step") and "jax.lax.scan(step" in lines[-1]
    assert "selective_scan" in chip_smoke.KERNELS and chip_smoke.OFF_PATH["selective_scan"] == 0


@pytest.mark.parametrize("with_state", [False, True], ids=["no state", "state"])
def test_causal_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7)).astype(np.float32)
    w = rng.normal(size=(4, 7)).astype(np.float32)
    state = rng.normal(size=(2, 3, 7)).astype(np.float32) if with_state else None
    y, new = mamba.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if state is None else torch.from_numpy(state))
    jy, jnew = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=CONV_TOL, rtol=0)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=CONV_TOL, rtol=0)


def _scan_inputs(b=2, s=13, d_in=24, n=8, seed=0, zero_state=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, d_in)) - 2.0)).astype(np.float32)
    A = (-np.arange(1, n + 1)[None, :] * np.exp(0.3 * rng.normal(size=(d_in, n))))
    Bm, Cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    D = (1.0 + 0.1 * rng.normal(size=(d_in,))).astype(np.float32)
    state = np.zeros((b, d_in, n)) if zero_state else rng.normal(size=(b, d_in, n)) * 3.0
    return x, dt, A.astype(np.float32), Bm, Cm, D, state.astype(np.float32)


def _scan_f64(x, dt, A, Bm, Cm, D, state):
    x, dt, A, Bm, Cm, D, h = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm, D, state))
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[:, :, None] * Bm[:, t, None]
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]))
    return np.stack(ys, axis=1) + D * x, h


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero state", "random state"])
@pytest.mark.parametrize("s", [1, 13])
@pytest.mark.parametrize("n", [8, 16])
def test_plain_scan_matches_a_float64_loop(n, s, zero_state):
    arrays = _scan_inputs(s=s, n=n, zero_state=zero_state)
    y, final = selective_scan_ref(*(torch.from_numpy(a) for a in arrays))
    want_y, want_h = _scan_f64(*arrays)
    assert y.shape == (2, s, 24) and final.shape == (2, 24, n)
    assert y.dtype == final.dtype == torch.float32
    _close_to_largest(y, want_y)
    _close_to_largest(final, want_h)
    # the wrapper on CPU tensors: the plain version, the state written in place
    state = torch.from_numpy(arrays[-1].copy())
    before = launch_counts()["selective_scan"]
    wy = selective_scan(*(torch.from_numpy(a) for a in arrays[:-1]), state)
    assert launch_counts()["selective_scan"] == before
    assert torch.equal(wy, y) and torch.equal(state, final)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x, dt, A, Bm, Cm, D, state = (torch.from_numpy(a) for a in _scan_inputs(s=3))
    with pytest.raises(ValueError, match="one"):
        selective_scan(x, dt[:, :2], A, Bm, Cm, D, state)
    with pytest.raises(ValueError, match="A must be"):
        selective_scan(x, dt, A[:5], Bm, Cm, D, state)
    with pytest.raises(ValueError, match="Cm must be"):
        selective_scan(x, dt, A, Bm, Cm[:, :, :4], D, state)
    with pytest.raises(ValueError, match="D must be"):
        selective_scan(x, dt, A, Bm, Cm, D[:3], state)
    with pytest.raises(ValueError, match="state must be"):
        selective_scan(x, dt, A, Bm, Cm, D, state[:1])
    with pytest.raises(ValueError, match="empty"):
        selective_scan(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], D, state)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm, D, state)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan(*meta)
    b, s, d_in, n = 1, 2, 8, 32
    with pytest.raises(ValueError, match="state dim 32"):
        selective_scan(torch.zeros(b, s, d_in, device="meta"),
                       torch.zeros(b, s, d_in, device="meta"),
                       torch.zeros(d_in, n, device="meta"), torch.zeros(b, s, n, device="meta"),
                       torch.zeros(b, s, n, device="meta"), torch.zeros(d_in, device="meta"),
                       torch.zeros(b, d_in, n, device="meta"))


def _mamba_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    d_in = cfg.ssm_expand * cfg.d_model
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    state = (rng.normal(size=(B, cfg.ssm_conv_width - 1, d_in)).astype(np.float32),
             rng.normal(size=(B, d_in, cfg.ssm_state_dim)).astype(np.float32))
    return x, state


@pytest.mark.parametrize("with_state", [False, True], ids=["no state", "state"])
def test_mamba_forward_matches_the_reference(with_state):
    _, jparams, cfg, params = _both()
    p, jp = params["blocks"][0]["mamba"], jax.tree_util.tree_map(
        lambda a: a[0], jparams["blocks"][0]["mamba"])
    x, state = _mamba_inputs(cfg)
    ours = None if not with_state else tuple(torch.from_numpy(a.copy()) for a in state)
    out, (conv, h) = mamba.mamba_forward(p, torch.from_numpy(x), cfg, ours)
    jout, (jconv, jh) = jmamba.mamba_forward(
        jp, jnp.asarray(x), cfg, None if not with_state else tuple(map(jnp.asarray, state)))
    for got, want in ((out, jout), (conv, jconv), (h, jh)):
        _close_to_largest(got, want)
    if with_state:  # the wrapper wrote the final state into the one given
        assert h is ours[1]
    # softplus is jax.nn.softplus, also where PyTorch's F.softplus turns linear
    v = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(mamba.softplus(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(v))))


@pytest.mark.parametrize("layer", [0, 1, 3], ids=["mamba+mlp", "mamba+moe", "attention+moe"])
def test_layers_match_the_reference(layer):
    jcfg, jparams, cfg, params = _both()
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][layer])
    jout, _, _ = jmodel._decoder_layer_fwd(jcfg, layer, jp, jnp.asarray(x), jnp.asarray(positions),
                                           jmodel._zero_aux())
    cache = model.init_cache(cfg, B, MAX_LEN, "cpu")
    out = model._hybrid_stack(cfg, {"blocks": [params["blocks"][layer]]}, torch.from_numpy(x),
                              cache, positions=torch.from_numpy(positions.copy()))
    _close(out, jout)


def test_prefill_and_decode_match_reference():
    jcfg, jparams, cfg, params = _both()
    toks = _tokens(cfg)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    logits, cache = model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                                  device="cpu")
    _close(logits, jl)
    _same_cache(cache, jc)
    at = {name: cache[name].data_ptr() for name in CACHE}
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(STEPS):
        jl, jc = step(jparams, jc, jnp.asarray(tok))
        logits, same = model.decode_step(cfg, params, cache, torch.from_numpy(tok), device="cpu")
        assert same is cache and {name: cache[name].data_ptr() for name in CACHE} == at
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(cache, jc)
    jempty = _ref_cache(jmodel.init_cache(jcfg, B, 16))
    empty = model.init_cache(cfg, B, 16, "cpu")
    assert set(empty) == set(jempty)
    for name in CACHE:
        assert tuple(empty[name].shape) == jempty[name].shape
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, S - 1, device="cpu")


def test_prefill_equals_shorter_prefill_then_one_decode_step():
    _, _, cfg, params = _both()
    toks = torch.from_numpy(_tokens(cfg, seed=5))
    long_logits, long_cache = model.prefill(cfg, params, {"tokens": toks}, MAX_LEN, device="cpu")
    logits, cache = model.prefill(cfg, params, {"tokens": toks[:, :-1]}, MAX_LEN, device="cpu")
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


def test_launcher_serves_jamba_on_the_cpu(capsys):
    launcher.main(["--arch", ARCH, "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "8 requests" in out and "prefix reuse" in out and "cpu" in out
