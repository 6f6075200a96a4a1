"""The sized solve's few-groups plan on the CPU: its order of adds.

``csrc/bucket_mass.cu``'s ``repro_solve_sized`` runs its Newton steps on a
warp a group where at most 32 groups of 64 buckets hold an item: lane l of
warp g takes buckets l and l + 32 of group g, the group's sums an xor
butterfly over the lanes; warp k sums class k with lane g holding group
g's sums (0 where the group is of another class), by a butterfly; and
every thread takes the same Newton step.  Here a float64 emulation of
that plan, written from the kernel and not from the plain version, is
held to
:func:`repro_torch.kernels.prefix_tree.ref.solve_sized_ref` (the block
plan's order) bit for bit, at G = 1, 6, 31 and 32 groups over 1 to 4
classes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.prefix_tree.ref import (
    SIZED_GROUP,
    sized_class_sums,
    sized_groups,
    solve_sized_ref,
)

LANES = np.arange(32)


def _butterfly(v):
    """An xor butterfly over the last axis, as every lane ends it."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ o]
    return v


def _few_groups(cnt, total, s, cap, lo, hi, iters):
    """The few-groups plan, lane by lane in numpy (float32 terms, float64
    sums, float32 Newton step): the last iterate, and each step's point and
    class sums."""
    f32 = np.float32
    groups = sized_groups(torch.from_numpy(cnt)).numpy()
    g_count = len(groups)
    assert g_count <= 32
    my_cls = np.full(32, -1)
    my_cls[:g_count] = groups[:, 0]
    pairs = []
    for k, g in groups:
        c = cnt[k, g * SIZED_GROUP:(g + 1) * SIZED_GROUP]
        tot = total[k, g * SIZED_GROUP:(g + 1) * SIZED_GROUP]
        mean = np.where(c > 0, tot / np.maximum(c, f32(1)), f32(0)).astype(f32)
        pairs.append((c, mean))
    t, lo, hi, cap = f32(lo), f32(lo), f32(hi), f32(cap)
    steps = []
    for _ in range(iters):
        gm, gi = np.zeros(32), np.zeros(32)
        for g, (c, mean) in enumerate(pairs):
            tk = f32(s[my_cls[g]] * t)
            z = np.minimum(np.maximum(mean - tk, f32(0)), f32(1))
            term = (c * z).astype(np.float64)
            inner = np.where((z > 0) & (z < 1), c, f32(0)).astype(np.float64)
            m2 = (0.0 + term[:32]) + term[32:]
            i2 = (0.0 + inner[:32]) + inner[32:]
            gm[g] = 0.0 + _butterfly(m2)[g]
            gi[g] = 0.0 + _butterfly(i2)[g]
        mass = slope = 0.0
        sums = []
        for k in range(len(s)):
            m = _butterfly(np.where(my_cls == k, gm, 0.0))[0]
            n_in = _butterfly(np.where(my_cls == k, gi, 0.0))[0]
            sums.append((m, n_in))
            mass = mass + np.float64(s[k]) * m
            slope = slope + np.float64(f32(s[k] * s[k])) * n_in
        steps.append((t, np.asarray(sums)))
        m32, s32 = f32(mass), f32(slope)
        too_much = m32 >= cap
        lo = t if too_much else lo
        hi = hi if too_much else t
        t_newton = f32(t + f32(f32(m32 - cap) / max(s32, f32(1e-12))))
        t_mid = f32(f32(0.5) * f32(lo + hi))
        t = t_newton if (s32 > 0 and lo < t_newton < hi) else t_mid
    return t, steps


def _instance(g_count, classes, seed, wide, v=4096):
    """``g_count`` groups that hold an item spread over ``classes`` classes
    of ``v`` buckets, dyadic class sizes, a capacity inside the bracket.
    ``wide``: counts scaled by 2^0 .. 2^44, so that float64 sums round and
    their order shows."""
    rng = np.random.default_rng(seed)
    cnt = np.zeros((classes, v), np.float32)
    total = np.zeros((classes, v), np.float32)
    picks = rng.choice(classes * (v // SIZED_GROUP), g_count, replace=False)
    for p in picks:
        k, g = divmod(int(p), v // SIZED_GROUP)
        c = rng.integers(0, 6, SIZED_GROUP).astype(np.float32)
        c[rng.integers(0, SIZED_GROUP)] = 1 + rng.integers(0, 5)  # at least one item
        if wide:
            c *= np.exp2(rng.integers(0, 45, SIZED_GROUP)).astype(np.float32)
        cnt[k, g * SIZED_GROUP:(g + 1) * SIZED_GROUP] = c
        total[k, g * SIZED_GROUP:(g + 1) * SIZED_GROUP] = c * rng.random(SIZED_GROUP,
                                                                          np.float32) * 3
    s = np.asarray([1.0, 4.0, 16.0, 64.0][:classes], np.float32)
    cap = np.float32(0.3 * float((cnt * s[:, None]).sum()))
    return cnt, total, s, cap


@pytest.mark.parametrize("g_count", [1, 6, 31, 32])
@pytest.mark.parametrize("classes", [1, 2, 3, 4])
@pytest.mark.parametrize("wide", [False, True], ids=["counts", "wide"])
def test_few_groups_plan_adds_in_the_plain_versions_order(g_count, classes, wide):
    cnt, total, s, cap = _instance(g_count, classes, 100 * g_count + classes, wide)
    assert len(sized_groups(torch.from_numpy(cnt))) == g_count
    lo, hi = np.float32(0.0), np.float32(0.25)
    cnt_t, total_t, s_t = (torch.from_numpy(x) for x in (cnt, total, s))
    for iters in (0, 1, 30):
        want = solve_sized_ref(cnt_t, total_t, s_t, torch.tensor(cap), torch.tensor(lo),
                               torch.tensor(hi), iters)
        got, steps = _few_groups(cnt, total, s, cap, lo, hi, iters)
        assert np.float32(want.item()).tobytes() == got.tobytes(), (iters, float(want), got)
    # every step's class sums, float64, bit for bit the plain version's
    for t, sums in steps:
        m_k, i_k = sized_class_sums(cnt_t, total_t, s_t, torch.tensor(t))
        np.testing.assert_array_equal(sums, torch.stack([m_k, i_k], 1).numpy())
