"""Training's attention gradient and ``forward_train`` against the JAX package.

``kernels/flash_prefill/ref.py``'s ``flash_prefill_bwd_ref`` (the plain
version of the backward kernel) is held against ``torch.autograd`` of the
plain forward ``flash_prefill_ref`` and against ``jax.grad`` of ``repro``'s
jnp ``flash_attention`` (chunked, so a ragged S pads its last chunk), in
the three modes (causal, non-causal with T == S, cross with T != S) with
GQA (g = 4 query heads a KV head), within 1e-5 of each gradient's largest
(float32 sums in another order).  ``forward_train``'s loss and every
parameter's gradient are held against ``jax.value_and_grad`` of
``repro``'s for the smoke configurations of glm4-9b, granite-moe,
phi-3-vision, whisper, gemma-7b and rwkv6 (whose recurrence trains through
``kernels.wkv6.ops.WKV6``, on the CPU the plain forward and backward of
``kernels/wkv6/ref.py``) in float32 on ``repro``'s own weights (carried
across by ``params_from_numpy``), inputs from numpy seeds: the loss within
1e-5 relative, each gradient within 1e-4 of its largest (two layers of
float32 products summed in another order).  The plain backward is also
held at gemma-7b's head dim, D = 256, which the backward kernel takes in
32-key tiles on the card.  On the CPU the attention function's forward and
backward are the kernels' plain versions; the kernels are held against the
same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py phases 28 and 29).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs.base import get_smoke
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.flash_prefill.ops import flash_prefill_bwd, flash_prefill_lse
from repro_torch.kernels.flash_prefill.ref import (
    flash_prefill_bwd_ref,
    flash_prefill_lse_ref,
    flash_prefill_ref,
)
from repro_torch.models import model
from repro_torch.models.attention import FlashAttention, flash_attention

GRAD_TOL = 1e-5  # the plain backward against autograd and jax.grad, of each largest
LOSS_TOL = 1e-5  # forward_train's loss, relative
PARAM_GRAD_TOL = 1e-4  # every parameter's gradient, of each tensor's largest
ARCHS = ["glm4-9b", "granite-moe-1b-a400m", "phi-3-vision-4.2b", "whisper-large-v3", "gemma-7b",
         "rwkv6-1.6b"]
#: (causal, S, T): causal, non-causal over T == S, cross over T != S; S ragged
MODES = [(True, 37, 37), (False, 37, 37), (False, 21, 45)]
B, H, HKV, D = 2, 8, 2, 16


def _inputs(S, T, seed, b=B, h=H, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, S, h, d), (b, T, hkv, d), (b, T, hkv, d), (b, S, h, d))]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


#: (causal, S, T, B, H, Hkv, D): the three modes at D = 16, and causal at
#: gemma-7b's head dim
GRAD_CASES = [(*mode, B, H, HKV, D) for mode in MODES] + [(True, 37, 37, 1, 2, 1, 256)]


@pytest.mark.parametrize("causal,S,T,b,h,hkv,d", GRAD_CASES,
                         ids=["causal", "non-causal", "cross", "causal-d256"])
def test_backward_plain_version_matches_autograd_and_jax(causal, S, T, b, h, hkv, d):
    qn, kn, vn, don = _inputs(S, T, S + T + (d if d != D else 0), b, h, hkv, d)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    out = flash_prefill_ref(q, k, v, causal)
    out.backward(torch.from_numpy(don))
    out_lse, lse = flash_prefill_lse_ref(q.detach(), k.detach(), v.detach(), causal)
    got = flash_prefill_bwd_ref(q.detach(), k.detach(), v.detach(), out_lse,
                                torch.from_numpy(don), lse, causal)

    def jax_out(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, q_chunk=16, kv_chunk=16)
        return jnp.sum(o * don)

    want = jax.jit(jax.grad(jax_out, argnums=(0, 1, 2)))(qn, kn, vn)
    for g, auto, ref in zip(got, (q.grad, k.grad, v.grad), want):
        assert g.shape == auto.shape
        _close(g.numpy(), auto.numpy(), GRAD_TOL)
        _close(g.numpy(), ref, GRAD_TOL)


@pytest.mark.parametrize("causal,S,T", MODES, ids=["causal", "non-causal", "cross"])
def test_lse_forward_is_the_serving_output_and_each_rows_logsumexp(causal, S, T):
    qn, kn, vn, _ = _inputs(S, T, seed=3)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    out, lse = flash_prefill_lse_ref(q, k, v, causal)
    torch.testing.assert_close(out, flash_prefill_ref(q, k, v, causal), rtol=0, atol=1e-6)
    s = np.einsum("bqhd,bkhd->bhqk", qn.astype(np.float64),
                  np.repeat(kn, H // HKV, axis=2).astype(np.float64)) / np.sqrt(D)
    if causal:
        s = np.where(np.triu(np.ones((S, T), bool), 1), -np.inf, s)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    assert flash_prefill_lse(q, k, v, causal)[1].equal(lse)  # the wrapper's CPU path


def test_attention_function_runs_the_plain_versions_on_the_cpu():
    qn, kn, vn, don = _inputs(37, 37, seed=5)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    before = launch_counts()
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(don))
    assert launch_counts() == before
    o, lse = flash_prefill_lse_ref(q.detach(), k.detach(), v.detach(), True)
    want = flash_prefill_bwd(q.detach(), k.detach(), v.detach(), o, torch.from_numpy(don), lse)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.equal(w)
    with torch.no_grad():  # no autograd: the serving call, no function recorded
        assert flash_attention(q, k, v, causal=True).grad_fn is None
    assert issubclass(FlashAttention, torch.autograd.Function)


def test_refuse_grad_raises_only_where_autograd_would_record():
    x, w = torch.zeros(3), torch.zeros(3, requires_grad=True)
    _build.refuse_grad("k", x, None)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", x, w)
    with torch.no_grad():
        _build.refuse_grad("k", x, w)


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(size=(b, cfg.n_image_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.n_audio_frames, cfg.d_model)).astype(
            np.float32)
    return batch


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key] if hasattr(key, "key") else tree[key.idx]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_every_gradient_match_repro(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    batch = _batch(cfg, seed=len(arch))
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.forward_train(jcfg, p, b), has_aux=True))
    (jloss, jmetrics), jgrads = fn(jparams, batch)

    params = model._map(lambda _, t: t.requires_grad_(True), model.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    loss, metrics = model.forward_train(cfg, params, batch, device="cpu")
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for name in jmetrics:
        assert abs(float(metrics[name].detach()) - float(jmetrics[name])) <= LOSS_TOL * max(
            abs(float(jmetrics[name])), 1e-6), name
    grads = model.params_to_numpy(cfg, model._map(
        lambda _, p: p.grad if p.grad is not None else torch.zeros_like(p), params))
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(leaves) == len(jax.tree_util.tree_leaves(grads))
    for path, want in leaves:
        _close(_leaf(grads, path), want, PARAM_GRAD_TOL)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_forward_train_raises_for_the_recurrent_families(arch):
    cfg = get_smoke(arch)
    params = model.init_params(cfg, device="cpu")
    kernel = model.MISSING_BACKWARD[cfg.family]
    with pytest.raises(NotImplementedError, match=kernel):
        model.forward_train(cfg, params, _batch(cfg), device="cpu")
