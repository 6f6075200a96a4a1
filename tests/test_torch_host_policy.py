"""The port's copies of the host policy, the page pool and the serving
launcher, and what the serving entry points do without a card.

``repro_torch.core.ogb.OGB``, ``core.policies.LRU`` and
``serve.kvcache.PagedKVPool`` are plain copies of ``repro``'s: over the scan
mix of ``tests/serve/test_serve.py::test_ogb_pool_beats_lru_on_scan_mix``
they must match hit for hit.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.ogb import OGB as JaxOGB
from repro.core.policies import LRU as JaxLRU
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.kvcache import page_keys as jax_page_keys
from repro_torch._device import resolve_device
from repro_torch.configs.base import get_arch, get_smoke, list_archs
from repro_torch.core.ogb import OGB, theoretical_eta
from repro_torch.core.ogb_classic import OGBClassic
from repro_torch.core.omd import OMDClassic
from repro_torch.core.policies import LRU, make_policy
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool, page_keys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _scan_mix(pool, steps=160):
    """The serving scan mix; yields the pool's stats after every step."""
    rng = np.random.default_rng(0)
    hot_prompts = [list(rng.integers(0, 50, 32)) for _ in range(8)]
    for step in range(steps):
        pool.serve(hot_prompts[step % len(hot_prompts)])
        pool.serve(list(1000 + 64 * step + np.arange(64)))  # one-shot scan pages
        pool.batch_end()
        yield dataclasses.asdict(pool.stats), pool.occupancy()


@pytest.mark.parametrize("kind", ["ogb", "lru"])
def test_pool_matches_reference_hit_for_hit(kind):
    C, horizon = 48, 160 * 24
    if kind == "ogb":
        ours = OGB(catalog_size=1 << 18, capacity=C, horizon=horizon, batch_size=24)
        ref = JaxOGB(catalog_size=1 << 18, capacity=C, horizon=horizon, batch_size=24)
    else:
        ours, ref = LRU(1 << 18, C), JaxLRU(1 << 18, C)
    pools = PagedKVPool(ours, page_size=4), JaxPool(ref, page_size=4)
    for (a, occ_a), (b, occ_b) in zip(_scan_mix(pools[0]), _scan_mix(pools[1])):
        assert a == b and occ_a == occ_b
    if kind == "ogb":  # LRU thrashes on this mix: no hit at all, on both sides
        assert pools[0].stats.hits > 0
        assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref.stats)
        assert ours.rho == ref.rho and ours.cached == ref.cached
        np.testing.assert_array_equal(ours.fractional_vector()[:4096],
                                      ref.fractional_vector()[:4096])


def test_make_policy_and_page_keys():
    pol = make_policy("ogb", 1 << 12, 8, horizon=100, batch_size=4)
    assert isinstance(pol, OGB) and pol.eta == theoretical_eta(8, 1 << 12, 100, 4)
    assert isinstance(make_policy("LRU", 10, 2), LRU)
    for kind, cls in (("ogb_cl", OGBClassic), ("omd_cl", OMDClassic)):  # the classic baselines
        assert isinstance(make_policy(kind, 10, 2, eta=0.1), cls)
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("nope", 10, 2)
    toks = list(np.random.default_rng(3).integers(0, 1000, 37).astype(np.int32))
    assert page_keys(toks, 8) == jax_page_keys(toks, 8)


def test_unported_architectures_raise():
    assert list_archs() == ["gemma-7b", "glm4-9b", "granite-moe-1b-a400m",
                            "jamba-1.5-large-398b", "kimi-k2-1t-a32b", "mistral-nemo-12b",
                            "phi-3-vision-4.2b", "qwen3-14b", "rwkv6-1.6b", "whisper-large-v3"]
    assert get_arch("glm4-9b").param_count() == 9_399_435_264
    for get in (get_arch, get_smoke):  # the hybrid family is ported: nothing is left out
        assert get("jamba-1.5-large-398b").family == "hybrid"
    with pytest.raises(KeyError):
        get_smoke("no-such-model")
    cfg = get_smoke("glm4-9b")
    # a MoE smoke configuration initializes: a moe subtree in place of each MLP
    moe = model.init_params(get_smoke("granite-moe-1b-a400m"), device="cpu")
    assert all("moe" in b and "mlp" not in b for b in moe["blocks"])
    # an int8 KV cache is served (mistral-nemo's), in the MoE family as in the dense one
    for int8 in (dataclasses.replace(get_smoke("granite-moe-1b-a400m"), kv_cache_dtype="int8"),
                 dataclasses.replace(cfg, kv_cache_dtype="int8")):
        assert model.init_cache(int8, 1, 4, "cpu")["k"].dtype == torch.int8
    # the ssm family initializes: RWKV-6 blocks, w0 and u in float32
    ssm = model.init_params(dataclasses.replace(cfg, family="ssm"), device="cpu",
                            dtype=torch.bfloat16)
    assert all(b["w0"].dtype == torch.float32 and "attn" not in b for b in ssm["blocks"])
    with pytest.raises(NotImplementedError):
        model.init_params(dataclasses.replace(cfg, kv_cache_dtype="fp8"), device="cpu")
    # a hybrid model is super-blocks of attn_period layers: none, or a ragged last one, raises
    for bad in (dataclasses.replace(cfg, family="hybrid"),
                dataclasses.replace(get_smoke("jamba-1.5-large-398b"), n_layers=6)):
        with pytest.raises(ValueError, match="attn_period"):
            model.init_params(bad, device="cpu")


def test_launcher_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "glm4-9b", "--steps", "2",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "prefix reuse" in out.stdout and "8 requests" in out.stdout and "cpu" in out.stdout


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    cfg = get_smoke("glm4-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    params = model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(cfg, params, {"tokens": torch.ones((1, 4), dtype=torch.int32)}, 8)
    cache = model.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.decode_step(cfg, params, cache, torch.ones(1, dtype=torch.int32))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "glm4-9b",
                          "--steps", "1"], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
