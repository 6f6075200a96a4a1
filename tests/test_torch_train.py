"""The port's training stack against the JAX package's, on the CPU.

One ``make_train_step`` step of the glm4-9b smoke configuration in float32
from ``repro``'s own state (``create_train_state``, carried across by
``train_state_from_numpy``) on a ``SyntheticLM`` batch, at 1 and 2
microbatches and with bfloat16 moments, against ``repro``'s jitted step:
the loss and ``grad_norm`` within 1e-5 relative (float32 sums in another
order), ``lr`` bit for bit, m and v within 1e-5 of each tensor's largest
(bfloat16 moments: one bf16 ulp of the largest, where a float32 value
rounds the other way), and the weights within a tenth of the step size
``lr``: Adam's first step is g / (|g| + eps), so where |g| is within a
few eps of zero a float32 rounding of g moves that element's step by up to
its error over eps.  ``lr_at``, the clip's scale from a given norm and
``SyntheticLM``'s batches are bit for bit the reference's; a checkpoint
round trip restores every leaf bit for bit, and 2 steps, a checkpoint, a
restore and 2 more steps equal 4 steps bit for bit; ``OGBShardCache``'s
hits equal ``repro``'s on one touch stream; ``StragglerMonitor`` flags the
steps ``repro``'s flags; and ``python -m repro_torch.launch.train``
trains the smoke glm4-9b on the CPU and prints a finite loss.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke as jax_smoke
from repro.dist.fault import FaultConfig as JaxFaultConfig
from repro.dist.fault import StragglerMonitor as JaxStragglerMonitor
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro.train.shard_cache import OGBShardCache as JaxShardCache
from repro.train.train_step import create_train_state as jax_create
from repro.train.train_step import make_train_step as jax_make
from repro_torch.configs.base import get_smoke
from repro_torch.dist.fault import FaultConfig, StragglerMonitor
from repro_torch.launch import train as launcher
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.shard_cache import OGBShardCache
from repro_torch.train.train_step import create_train_state, make_train_step

ARCH = "glm4-9b"
REL_TOL = 1e-5  # loss, grad_norm, and float32 moments of each tensor's largest
BF16_ULP = 2.0 ** -7  # one bf16 ulp of a tensor's largest, relative
STEP_FRACTION = 0.1  # weights: a tenth of the step size lr
OPT_KW = dict(lr=3e-3, warmup_steps=2, total_steps=10)
ROOT = Path(__file__).resolve().parents[1]


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key] if hasattr(key, "key") else tree[key.idx]
    return tree


def _each_leaf(cfg, port_tree, jax_tree, check):
    got = model.params_to_numpy(cfg, port_tree)
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, want in leaves:
        check(_leaf(got, path), np.asarray(want).astype(np.float32))


def _batch(cfg, seed=0):
    return SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=seed)).next_batch()


@pytest.mark.parametrize("n_micro,moments", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_one_step_matches_repro(n_micro, moments):
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    kw = dict(OPT_KW, moment_dtype=moments)
    jstate = jax_create(jcfg, jopt.OptimizerConfig(**kw), jax.random.key(0))
    batch = _batch(cfg)
    jnext, jmetrics = jax.jit(jax_make(jcfg, jopt.OptimizerConfig(**kw), n_micro))(jstate, batch)

    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = model.train_state_from_numpy(cfg, as_np(jstate.params), as_np(jstate.opt), "cpu")
    state, metrics = make_train_step(cfg, opt.OptimizerConfig(**kw), n_micro)(state, batch)

    assert state.opt.step == int(jnext.opt.step) == 1
    for name in ("loss", "grad_norm"):
        want = float(jmetrics[name])
        assert abs(float(metrics[name]) - want) <= REL_TOL * abs(want), name
    assert metrics["lr"] == float(jmetrics["lr"])
    lr = metrics["lr"]

    def weights(got, want):
        assert float(np.abs(got - want).max()) <= STEP_FRACTION * lr

    def moment(got, want):
        tol = BF16_ULP if moments == "bfloat16" else REL_TOL
        assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1e-30)

    _each_leaf(cfg, state.params, jnext.params, weights)
    _each_leaf(cfg, state.opt.m, jnext.opt.m, moment)
    _each_leaf(cfg, state.opt.v, jnext.opt.v, moment)
    mdt = opt.MOMENT_DTYPES[moments]
    assert all(t.dtype == mdt for _, t in opt.tree_leaves(state.opt.m))


def test_lr_schedule_is_bit_for_bit_repros():
    for kw in (dict(warmup_steps=10, total_steps=1000), dict(warmup_steps=1, total_steps=100),
               dict(lr=3e-3, warmup_steps=0, total_steps=7, min_lr_frac=0.0)):
        jcfg, cfg = jopt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
        steps = jnp.arange(0, cfg.total_steps + 20, dtype=jnp.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jcfg, s))(steps))
        got = np.array([opt.lr_at(cfg, int(s)) for s in steps], np.float32)
        assert np.array_equal(got, want)


def test_clipping_matches_repro():
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) * 3 for s in ((7, 5), (300,), (2, 3, 4))]
    tree = {"a": [torch.from_numpy(leaves[0]), torch.from_numpy(leaves[1])],
            "b": torch.from_numpy(leaves[2])}
    gnorm = opt.global_norm(tree)
    jnorm = jopt.global_norm(leaves)
    assert abs(float(gnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    cfg = opt.OptimizerConfig()
    for norm in (float(jnorm), 0.5, 1.0, 0.0, 1e-12, 3.7e4):
        n32 = np.float32(norm)
        want = jnp.minimum(1.0, cfg.clip_norm / jnp.maximum(jnp.float32(n32), 1e-9))
        got = opt.clip_scale(cfg, torch.tensor(n32))
        assert np.float32(got) == np.asarray(want)  # bit for bit from the same norm


def test_synthetic_batches_are_bit_for_bit_repros():
    for kw in (dict(vocab_size=256, seq_len=64, global_batch=4),
               dict(vocab_size=1000, seq_len=9, global_batch=6, seed=3, n_shards=2, shard_id=1)):
        ours, ref = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(JaxDataConfig(**kw))
        for _ in range(3):
            a, b = ours.next_batch(), ref.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert ours.state_dict() == ref.state_dict()


def _state(moments="float32"):
    cfg = get_smoke(ARCH)
    opt_cfg = opt.OptimizerConfig(**OPT_KW, moment_dtype=moments)
    return cfg, opt_cfg, create_train_state(cfg, opt_cfg, seed=1, device="cpu")


def _same(a, b):
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    cfg, opt_cfg, state = _state("bfloat16")
    state, _ = make_train_step(cfg, opt_cfg)(state, _batch(cfg))
    save_checkpoint(str(tmp_path), 1, state, extra={"step": 1})
    assert latest_step(str(tmp_path)) == 1
    _, _, fresh = _state("bfloat16")
    back, step, extra = restore_checkpoint(str(tmp_path), fresh)
    assert step == 1 and extra == {"step": 1} and back.opt.step == 1
    _same(back.params, state.params)
    _same(back.opt.m, state.opt.m)
    _same(back.opt.v, state.opt.v)
    assert all(t.requires_grad for _, t in opt.tree_leaves(back.params))


def test_resume_from_a_checkpoint_is_bit_for_bit(tmp_path):
    cfg, opt_cfg, state = _state()
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=2)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2))
    for _ in range(4):
        state, metrics = step_fn(state, data.next_batch())

    _, _, resumed = _state()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2))
    for _ in range(2):
        resumed, _ = step_fn(resumed, data.next_batch())
    ckpt = AsyncCheckpointer(str(tmp_path), keep_last=1)
    ckpt.save(2, resumed, extra=data.state_dict())
    ckpt.wait()
    _, _, fresh = _state()
    resumed, step, extra = restore_checkpoint(str(tmp_path), fresh)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2))
    data.load_state_dict(extra)
    assert step == 2 and resumed.opt.step == 2
    for _ in range(2):
        resumed, again = step_fn(resumed, data.next_batch())
    assert float(again["loss"]) == float(metrics["loss"])
    _same(resumed.params, state.params)
    _same(resumed.opt.m, state.opt.m)
    _same(resumed.opt.v, state.opt.v)


def test_shard_cache_hits_equal_repros():
    rng = np.random.default_rng(4)
    touches = rng.zipf(1.3, 3000) % 200
    ours, ref = OGBShardCache(200, 40, horizon_touches=3000), JaxShardCache(
        200, 40, horizon_touches=3000)
    got = [ours.touch(int(s)) for s in touches]
    want = [ref.touch(int(s)) for s in touches]
    assert got == want and sum(got) > 0
    assert ours.stats.local_hits == ref.stats.local_hits
    assert [ours.is_local(i) for i in range(200)] == [ref.is_local(i) for i in range(200)]


def test_straggler_monitor_flags_repros_steps():
    durations = [5.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.1, 0.9, 3.0, 1.0, 2.6, 2.4, 9.0, 1.0]
    ours, ref = StragglerMonitor(FaultConfig()), JaxStragglerMonitor(JaxFaultConfig())
    assert [ours.observe(i, d) for i, d in enumerate(durations)] == [
        ref.observe(i, d) for i, d in enumerate(durations)]
    assert (ours.n_stragglers, ours.excess_s, ours.baseline_s) == (
        ref.n_stragglers, ref.excess_s, ref.baseline_s)
    with pytest.raises(ValueError):
        FaultConfig(straggler_factor=1.0)


def test_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu",
         "--steps", "3", "--seq-len", "16", "--global-batch", "4"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert losses and all(np.isfinite(losses)) and "[train] done" in proc.stdout
    with pytest.raises(NotImplementedError, match="distributed"):
        launcher.main(["--arch", ARCH, "--device", "cpu", "--mesh-data", "2", "--mesh-model", "2"])
    assert launcher.config(ARCH, smoke=False, depth=4).n_layers == 4
