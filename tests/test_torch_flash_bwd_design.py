"""The card's wgmma attention backward, its partition and order of sums modelled in float32, on the CPU.

``csrc/flash_prefill_bwd_wgmma.cu`` computes the gradient of GQA flash
attention in three launches.  ``design_model`` below follows it:

  1. dQ a 128-row query tile at a time, the key tiles of ``BWD_DQ_KEYS``
     keys up to the diagonal in order: S = Q K^T and dP = dO V^T in
     float32, P = 2^(S log2(e)/sqrt(D) - lse log2(e)) (0 where masked),
     dS = P (dP - delta) rounded to bf16 for dQ += dS K, delta_i = sum_d
     dO_id O_id; dq = bf16(dQ / sqrt(D));
  2. dK and dV a 128-key tile and a group of hg query heads at a time: each
     head of the group in order, each 64-row query tile from the diagonal
     on in order, P^T and dS^T rounded to bf16 for dV += P^T dO and
     dK += dS^T Q; a float32 partial a group;
  3. each KV head's g / hg partials summed in head order, dk = bf16(sum /
     sqrt(D)), dv = bf16(sum).

The model is held against the port's plain version ``ref.py::
flash_prefill_bwd_ref`` (bf16 in, float32 sums) and against ``jax.grad``
of ``repro.models.attention.flash_attention`` (float32, on the same
bf16-valued inputs), causal, non-causal and cross, at ragged S and T
around the 64- and 128-row tiles, D 64, 96 and 128, g = 4 query heads a KV
head in one, two and four partials, within 8 bf16 ulps of each output's
largest: the limit the kernel is held to on the card (chip_smoke.py's
BWD_ULPS, tests/test_torch_cuda.py).  The rest checks what the card cannot
be asked here: the plans' shared memory and registers, the grids' longest
work first, the source's constants against ``kernel.py``'s, no
floating-point atomics, and the wrapper counting three launches under the
design's name (phase 28's exact counts).
"""

import math
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_prefill import kernel, ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref, flash_prefill_lse_ref

CSRC = pathlib.Path(kernel.__file__).resolve().parent / "csrc"
SOURCE = (CSRC / "flash_prefill_bwd_wgmma.cu").read_text()
FORWARD = (CSRC / "flash_prefill.cu").read_text()
HEADER = (CSRC.parents[1] / "csrc" / "hopper.cuh").read_text()
ROOT = CSRC.parents[4]
sys.path.insert(0, str(ROOT))  # tools/ and chip_smoke.py
LOG2E = np.float32(math.log2(math.e))
ULPS = 8  # of each output's largest, in bf16 ulps (chip_smoke.py's BWD_ULPS)
SMEM_LIMIT = 232448  # dynamic shared memory a block can ask for on an H100
B, H, HKV = 2, 8, 2
#: (causal, S, T): ragged S around the 64- and 128-row tiles
MODES = [(True, 200, 200), (False, 150, 150), (False, 37, 150)]
MODE_IDS = ["causal", "non-causal", "cross"]


def bf16(x):
    return x.to(torch.bfloat16).float()


def design_model(q, k, v, o, dout, lse, causal, hg, dq_keys=kernel.BWD_DQ_KEYS):
    """(dq, dk, dv) as float32 tensors holding bf16 values, in the wgmma
    design's partition and order (module docstring)."""
    Bn, S, Hn, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hn // Hkv
    scale = np.float32(1.0 / math.sqrt(D))
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    lse2 = lse * torch.tensor(LOG2E)  # (B, H, S)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, S)
    rows_a, steps = kernel.BWD_ROWS, kernel.BWD_STEP_ROWS

    def p_ds(s, dp, l2, dl, off):
        p = torch.exp2(s * scale_log2 - l2)
        if causal:
            p = p.masked_fill(off, 0.0)
        return p, p * (dp - dl)

    # launch 1: dQ a 128-row query tile at a time, key tiles in order
    dq = torch.zeros(Bn, S, Hn, D)
    kg, vg = kf.repeat_interleave(g, dim=2), vf.repeat_interleave(g, dim=2)
    for q0 in range(0, S, rows_a):
        rows = torch.arange(q0, min(q0 + rows_a, S))
        n_kv = -(-min(q0 + rows_a, S) // dq_keys) if causal else -(-T // dq_keys)
        qt, dot = qf[:, rows].transpose(1, 2), dof[:, rows].transpose(1, 2)  # (B, H, r, D)
        acc = torch.zeros(Bn, Hn, len(rows), D)
        for j in range(n_kv):
            keys = torch.arange(j * dq_keys, min((j + 1) * dq_keys, T))
            kt, vt = kg[:, keys].transpose(1, 2), vg[:, keys].transpose(1, 2)
            _, ds = p_ds(qt @ kt.transpose(-1, -2), dot @ vt.transpose(-1, -2),
                         lse2[:, :, rows, None], delta[:, :, rows, None],
                         keys[None, :] > rows[:, None])
            acc = acc + bf16(ds) @ kt
        dq[:, rows] = bf16(acc * scale).transpose(1, 2)

    # launch 2: float32 partials a (128-key tile, group of hg heads), query tiles in order
    n_groups = Hn // hg
    parts_k = torch.zeros(n_groups, Bn, T, D)
    parts_v = torch.zeros(n_groups, Bn, T, D)
    for k0 in range(0, T, rows_a):
        keys = torch.arange(k0, min(k0 + rows_a, T))
        for grp in range(n_groups):
            kvh = grp * hg // g
            kt, vt = kf[:, keys, kvh], vf[:, keys, kvh]  # (B, c, D)
            acc_k, acc_v = torch.zeros(Bn, len(keys), D), torch.zeros(Bn, len(keys), D)
            for h in range(grp * hg, (grp + 1) * hg):
                for q0 in range(k0 if causal else 0, S, steps):
                    rows = torch.arange(q0, min(q0 + steps, S))
                    qt, dot = qf[:, rows, h], dof[:, rows, h]  # (B, r, D)
                    pt, dst = p_ds(kt @ qt.transpose(-1, -2), vt @ dot.transpose(-1, -2),
                                   lse2[:, h, None, rows], delta[:, h, None, rows],
                                   keys[:, None] > rows[None, :])
                    acc_v = acc_v + bf16(pt) @ dot
                    acc_k = acc_k + bf16(dst) @ qt
            parts_k[grp, :, keys], parts_v[grp, :, keys] = acc_k, acc_v

    # launch 3: each KV head's partials in head order
    per = g // hg
    dk, dv = torch.zeros(Bn, T, Hkv, D), torch.zeros(Bn, T, Hkv, D)
    for kvh in range(Hkv):
        sk, sv = parts_k[kvh * per], parts_v[kvh * per]
        for p in range(1, per):
            sk, sv = sk + parts_k[kvh * per + p], sv + parts_v[kvh * per + p]
        dk[:, :, kvh], dv[:, :, kvh] = bf16(sk * scale), bf16(sv)
    return dq, dk, dv


def _inputs(S, T, D, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, T, HKV, D), (B, T, HKV, D), (B, S, H, D))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
            for s in shapes]


def _limit(want):
    top = float(want.abs().max())
    return ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("causal,S,T", MODES, ids=MODE_IDS)
def test_design_model_matches_the_plain_version_and_jax(causal, S, T, D):
    q, k, v, do = _inputs(S, T, D, seed=S + T + D)
    o, lse = flash_prefill_lse_ref(q, k, v, causal)
    plain = [x.float() for x in flash_prefill_bwd_ref(q, k, v, o, do, lse, causal)]
    qn, kn, vn, don = (x.float().numpy() for x in (q, k, v, do))

    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal=causal, q_chunk=64, kv_chunk=64)
                       * don)

    autodiff = [torch.from_numpy(np.array(x))
                for x in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(qn, kn, vn)]
    for hg in (1, 2, 4):  # four, two and one partials a KV head (g = 4)
        got = design_model(q, k, v, o, do, lse, causal, hg)
        for name, g_, p_, a_ in zip(("dq", "dk", "dv"), got, plain, autodiff):
            assert g_.shape == p_.shape and bool(torch.isfinite(g_).all())
            err_p = float((g_ - p_).abs().max())
            err_a = float((g_ - a_).abs().max())
            assert err_p <= _limit(p_), (hg, name, err_p, _limit(p_))
            assert err_a <= _limit(a_), (hg, name, err_a, _limit(a_))


def test_design_model_at_one_row_and_one_key():
    """S = T = 1, causal: one key, so P = 1 and dS = 0 (dq = dk = 0, dv = dO
    summed over the group's heads)."""
    q, k, v, do = _inputs(1, 1, 128, seed=9)
    o, lse = flash_prefill_lse_ref(q, k, v, True)
    dq, dk, dv = design_model(q, k, v, o, do, lse, True, hg=2)
    assert float(dq.abs().max()) < 1e-5 and float(dk.abs().max()) < 1e-5
    want = flash_prefill_bwd_ref(q, k, v, o, do, lse, True)[2].float()
    assert float((dv - want).abs().max()) <= _limit(want)


@pytest.mark.parametrize("D", kernel.BWD_WGMMA_HEAD_DIMS)
def test_every_plan_fits_one_block_on_an_sm(D):
    """Shared memory within the card's 227 KB for the chosen plan and every
    plan the sweep builds; the producer's and consumers' registers within
    the SM's 65 536; tiles that wgmma and TMA take."""
    from tools.time_flash_bwd_designs import HEAD_GROUPS, SWEEP

    regs = re.search(r"kProducerRegs = (\d+), kConsumerRegs = (\d+)", SOURCE).groups()
    assert 128 * int(regs[0]) + 256 * int(regs[1]) <= 65536
    chosen = (kernel.BWD_DQ_KEYS, kernel.BWD_DQ_STAGES, kernel.BWD_DKV_STAGES)
    assert chosen in SWEEP and kernel.BWD_HEAD_GROUP in HEAD_GROUPS
    for plan in SWEEP:
        p = kernel.bwd_plan(D, *plan)
        assert p["dq_smem_bytes"] <= SMEM_LIMIT and p["dkv_smem_bytes"] <= SMEM_LIMIT, plan
        assert p["dq_keys"] % 16 == 0 and p["dq_keys"] <= 256  # wgmma N and k-steps
        assert max(p["dq_rows"], p["dkv_keys"], p["dq_keys"], p["dkv_rows"]) <= 256  # TMA box
    assert kernel.BWD_ROWS == 128 and kernel.BWD_STEP_ROWS == 64  # two warpgroups of 64
    # the float32 accumulators a consumer thread holds at once: dQ (D / 2), S and
    # dP (dq_keys / 2 each) and dS's bf16 fragments; dK and dV (D / 2 each) and
    # S^T and dP^T (32 each): under setmaxnreg's 240 with room for addresses
    assert D // 2 + kernel.BWD_DQ_KEYS + kernel.BWD_DQ_KEYS // 4 <= 200
    assert D + kernel.BWD_STEP_ROWS <= 200


def _dq_block(i, n_q, Hn, Bn):
    """The source's dq_kernel: block i -> (query tile, head, batch)."""
    return n_q - 1 - i // (Hn * Bn), i % Hn, i // Hn % Bn


def _dkv_block(i, n_groups, Bn):
    """The source's dkv_kernel: block i -> (key tile, head group, batch)."""
    return i // (n_groups * Bn), i % n_groups, i // n_groups % Bn


@pytest.mark.parametrize("shape", [(2, 4096, 4096, 32, 2), (2, 2048, 2048, 16, 8),
                                   (2, 224, 1500, 20, 20), (1, 1, 1, 16, 1)])
def test_grids_cover_every_tile_once_longest_first(shape):
    Bn, S, T, Hn, Hkv = shape
    hg = kernel.bwd_heads_per_block(Hn, Hkv)
    assert (Hn // Hkv) % hg == 0 and hg <= kernel.BWD_HEAD_GROUP
    n_q, n_k, n_groups = -(-S // 128), -(-T // 128), Hn // hg
    n1, n2 = n_q * Hn * Bn, n_k * n_groups * Bn  # the source's launch()
    dq = [_dq_block(i, n_q, Hn, Bn) for i in range(n1)]
    dkv = [_dkv_block(i, n_groups, Bn) for i in range(n2)]
    assert sorted(dq) == sorted((a, h, b) for a in range(n_q) for h in range(Hn)
                                for b in range(Bn))
    assert sorted(dkv) == sorted((a, h, b) for a in range(n_k) for h in range(n_groups)
                                 for b in range(Bn))
    # causal: a dQ block walks its tile's keys up to the diagonal, a dK/dV
    # block its key tile's query tiles from the diagonal on: both start longest
    dq_work = [min(qi * 128 + 128, S) for qi, _, _ in dq]
    dkv_work = [S - kt * 128 for kt, _, _ in dkv]
    assert dq_work == sorted(dq_work, reverse=True)
    assert dkv_work == sorted(dkv_work, reverse=True)


def _c_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _c_function(name, **values):
    """Evaluate the source's constexpr function ``name`` at ``values``."""
    body = re.search(rf"constexpr int {name}\([^)]*\) {{\s*return ([^;]+);", SOURCE).group(1)
    env = {"kRows": _c_constant("kRows"), "kQ": _c_constant("kQ"), **values}
    return eval(body, {}, env)  # the expression is integer arithmetic only


@pytest.mark.parametrize("D", kernel.BWD_WGMMA_HEAD_DIMS)
def test_source_agrees_with_the_plan_constants(D):
    plans = re.search(r"#define BWD_WG_PLANS (.+)", SOURCE).group(1)
    assert plans.strip() == "X({}, {}, {})".format(
        kernel.BWD_DQ_KEYS, kernel.BWD_DQ_STAGES, kernel.BWD_DKV_STAGES)
    assert _c_constant("kRows") == kernel.BWD_ROWS and _c_constant("kQ") == kernel.BWD_STEP_ROWS
    from tools.time_flash_bwd_designs import SWEEP

    for plan in SWEEP:
        p = kernel.bwd_plan(D, *plan)
        assert _c_function("dq_smem", D=D, BC=plan[0], ST=plan[1]) == p["dq_smem_bytes"]
        assert _c_function("dkv_smem", D=D, ST=plan[2]) == p["dkv_smem_bytes"]


def test_no_floating_point_atomics_and_one_copy_of_the_hopper_helpers():
    for text in (SOURCE, HEADER):
        assert not re.search(r"\batomic[A-Z]\w*\(|\bred\.|\batom\.", text)
    for src in (SOURCE, FORWARD):
        assert '#include "../../csrc/hopper.cuh"' in src
        for helper in ("mbarrier.try_wait", "cp.async.bulk.tensor", "wgmma.mma_async",
                       "cuTensorMapEncodeTiled", "wgmma.fence"):
            assert helper not in src, helper
    for helper in ("mbarrier.try_wait", "cp.async.bulk.tensor", "wgmma.mma_async",
                   "cuTensorMapEncodeTiled"):
        assert helper in HEADER


def test_bwd_design_by_dtype_and_head_dim():
    bf, f32 = torch.bfloat16, torch.float32
    assert [kernel.bwd_design(bf, D) for D in (64, 96, 128, 16, 256)] == [
        kernel.WGMMA, kernel.WGMMA, kernel.WGMMA, kernel.CUDA_CORE, kernel.CUDA_CORE]
    assert kernel.bwd_design(f32, 128) == kernel.CUDA_CORE
    assert kernel.BWD_LAUNCHES == {kernel.WGMMA: 3, kernel.CUDA_CORE: 2}
    assert [kernel.bwd_heads_per_block(H_, Hkv) for H_, Hkv in
            ((32, 2), (16, 8), (20, 20), (24, 2), (12, 4))] == [8, 2, 1, 6, 3]


@pytest.mark.parametrize("dtype,D,design", [(torch.bfloat16, 128, kernel.WGMMA),
                                            (torch.bfloat16, 64, kernel.WGMMA),
                                            (torch.bfloat16, 96, kernel.WGMMA),
                                            (torch.bfloat16, 16, kernel.CUDA_CORE),
                                            (torch.float32, 128, kernel.CUDA_CORE)])
def test_the_wrapper_counts_each_launch_under_its_designs_name(monkeypatch, dtype, D, design):
    """Off the CPU the wrapper launches the design ``bwd_design`` names and
    counts BWD_LAUNCHES of it (phase 28's exact counts): here on meta
    tensors, the launch itself replaced."""
    calls = []
    monkeypatch.setattr(ops, "grid_prefill_bwd", lambda q, k, v, *a: calls.append(a) or (q, k, v))
    monkeypatch.setattr(ops.flash_prefill_bwd, "launches", 0)
    monkeypatch.setattr(ops.flash_prefill_bwd, "designs", {})
    q = torch.empty(2, 64, 8, D, dtype=dtype, device="meta")
    k = torch.empty(2, 64, 2, D, dtype=dtype, device="meta")
    lse = torch.empty(2, 8, 64, device="meta")
    ops.flash_prefill_bwd(q, k, k, q, q, lse, True)
    n = kernel.BWD_LAUNCHES[design]
    assert len(calls) == 1 and ops.flash_prefill_bwd.launches == n
    assert ops.flash_prefill_bwd.designs == {f"{design}, causal": n}


def test_phase_28_expects_the_designs_launches():
    text = (ROOT / "chip_smoke.py").read_text()
    assert "n_bwd = BWD_LAUNCHES[bwd_design(bf16, cfg.head_dim)]" in text
    assert "bwd = L * micro * n_bwd * TRAIN_STEPS" in text
    assert "time_in_turns" in text and "dkv_sum_kernel" in text
