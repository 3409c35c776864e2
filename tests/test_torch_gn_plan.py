"""K3's plan on the CPU: how ops/fused_groupnorm.py:_plan cuts an (N, S, C)
slab for csrc/group_norm.cu, and a plain computation that follows it.

The kernel runs only on the card; these tests hold what surrounds it: every
(sample, group, row) is covered once, with each group whole inside one item;
every block fits the opt-in; the UNet's keys take the one-launch mode A and
the VAE's largest slabs mode B; and fp32 statistics summed block by block
and combined in the kernel's order equal the JAX package's Pallas kernel in
interpret mode.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.ops.pallas_groupnorm import fused_group_norm as jax_fused_gn
from synfmc_tpu_torch.ops.fused_groupnorm import (
    _CLUSTER_MAX,
    _SMEM_A_MAX,
    SMEM_OPTIN,
    _plan,
    _plan_a,
    _plan_b,
    _smem_a,
    _smem_b,
)

# (S, C) of every GroupNorm of the flagship UNet at 16x256x384 (32 groups):
# serving runs them at N = 32 (the CFG pair), the train step at N = 16.
UNET_KEYS = [(1536, 320), (1536, 640), (1536, 960), (384, 320), (384, 640), (384, 960),
             (384, 1280), (384, 1920), (96, 640), (96, 1280), (96, 1920), (96, 2560),
             (24, 1280), (24, 2560)]
# (N, S, C) of the VAE: the decoder frame by frame (N = 1), the encoder on a
# train step's 16 frames; each with the mode its plan takes.
VAE_KEYS = [((1, 1536, 512), "A"), ((1, 6144, 512), "A"), ((1, 24576, 512), "B"),
            ((1, 24576, 256), "B"), ((1, 98304, 256), "B"), ((1, 98304, 128), "B"),
            ((16, 1536, 512), "A"), ((16, 6144, 512), "A"), ((16, 6144, 256), "A"),
            ((16, 24576, 256), "B"), ((16, 24576, 128), "B"), ((16, 98304, 128), "B")]
# Edges: 4 groups of 3 channels (a 24-byte bf16 row), a single row, one sample.
EDGE_KEYS = [(3, 7, 12, 4), (2, 1, 320, 32), (1, 24, 2560, 32), (4, 5, 96, 32),
             (2, 4096, 128, 32), (1, 97, 6144, 32), (1, 20000, 6144, 32), (32, 3, 64, 64)]


def _cdiv(a, b):
    return -(-a // b)


def kernel_blocks(plan, n, s, groups):
    """(sample, first group, end group, first row, end row) of each block, as
    csrc/group_norm.cu maps a block to its slice: gn_cluster's blockIdx.x in
    mode A; gn_apply's (chunk, sample) grid in mode B."""
    if plan.mode == "A":
        runs = groups // plan.run
        for b in range(plan.blocks):
            item, rank = divmod(b, plan.cluster)
            sample, run = divmod(item, runs)
            r0 = rank * plan.rows
            yield sample, run * plan.run, (run + 1) * plan.run, r0, min(s, r0 + plan.rows)
    else:
        for sample in range(n):
            for chunk in range(_cdiv(s, plan.rows)):
                yield sample, 0, groups, chunk * plan.rows, min(s, (chunk + 1) * plan.rows)


def assert_covers_once(plan, n, s, groups):
    """Items of whole groups tile each sample's groups, and each item's
    blocks tile its rows: every (sample, group, row) exactly once."""
    items = {}
    for sample, g0, g1, r0, r1 in kernel_blocks(plan, n, s, groups):
        assert 0 <= sample < n and 0 <= g0 < g1 <= groups and 0 <= r0 < r1 <= s
        items.setdefault((sample, g0, g1), []).append((r0, r1))
    for sample in range(n):
        runs = sorted((g0, g1) for (m, g0, g1) in items if m == sample)
        assert [g for run in runs for g in run] == [0] + [g for g0, g1 in runs[1:] for g in
                                                          (g0, g0)] + [groups]
    for spans in items.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == s
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def assert_fits(plan, s, c, groups, esize):
    """The block fits the opt-in (mode A: two blocks an SM), the cluster is
    portable, copies divide the row, and the plan's shared bytes are the
    kernel's layout."""
    assert 1 <= plan.cluster <= min(_CLUSTER_MAX, 16)
    assert 0 < plan.smem <= SMEM_OPTIN
    assert plan.rows >= 1 and groups % plan.run == 0
    width = plan.run * (c // groups)
    assert (width * esize) % plan.vec == 0 and plan.vec in (16, 8, 4, esize)
    if plan.mode == "A":
        assert plan.smem <= _SMEM_A_MAX
        assert plan.rows * plan.cluster >= s > plan.rows * (plan.cluster - 1)
        assert plan.smem == _smem_a(plan.rows, width, plan.run, esize, plan.vec)
        assert width * esize >= 64 or plan.run == groups
    else:
        assert plan.run == groups
        assert plan.smem == _smem_b(plan.rows, c, groups, esize, plan.vec)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("n", [32, 16])
@pytest.mark.parametrize("s,c", UNET_KEYS)
def test_unet_keys_take_mode_a(s, c, n, esize):
    plan = _plan(n, s, c, 32, esize)
    assert plan.mode == "A" and plan.vec == 16
    assert_fits(plan, s, c, 32, esize)
    assert_covers_once(plan, n, s, 32)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("key,mode", VAE_KEYS)
def test_vae_keys(key, mode, esize):
    """The slabs whose narrowest item fits no cluster take mode B in bf16 (the
    path's type); fp32 gives the same modes."""
    n, s, c = key
    plan = _plan(n, s, c, 32, esize)
    assert plan.mode == mode
    assert_fits(plan, s, c, 32, esize)
    assert_covers_once(plan, n, s, 32)
    if mode == "B":
        assert _plan_a(n, s, c, 32, esize) is None


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("n,s,c,groups", EDGE_KEYS)
def test_edge_plans(n, s, c, groups, esize):
    for plan in (_plan(n, s, c, groups, esize), _plan_b(n, s, c, groups, esize)):
        assert_fits(plan, s, c, groups, esize)
        assert_covers_once(plan, n, s, groups)


def test_every_gated_slab_has_a_plan():
    """Every channel count up to the gate's 6144 and every row count gets a
    plan that fits the opt-in, in both types."""
    for esize in (2, 4):
        for c, groups in ((12, 4), (96, 32), (320, 32), (2560, 32), (6144, 32), (6144, 6144)):
            for s in (1, 7, 24, 1536, 98304, 300_000):
                if s * c < 2 ** 31:
                    assert_fits(_plan(1, s, c, groups, esize), s, c, groups, esize)


def planned_group_norm(x, scale, bias, groups, eps, act, plan):
    """GroupNorm as the kernel computes it under ``plan``, in fp32: each
    block's per-group (sum, sumsq) over its rows, combined in the kernel's
    order (mode A: the cluster's ranks in order; mode B: each cluster of
    chunks in rank order, then gn_apply's threads over every 256 // G-th
    partial, then those in order), the one-pass variance, the affine folded
    into one scale and shift, then the activation."""
    n, s, c = x.shape
    cg = c // groups
    xf = x.float()
    k = plan.cluster
    if plan.mode == "A":
        blocks = k
    else:
        blocks = _cdiv(_cdiv(s, plan.rows), k) * k
    pad = torch.zeros(n, blocks * plan.rows - s, c)
    xb = torch.cat([xf, pad], 1).reshape(n, blocks, plan.rows, groups, cg)
    part_s, part_q = xb.sum((2, 4)), (xb * xb).sum((2, 4))  # (n, blocks, groups)

    def in_order(parts):
        total = torch.zeros(parts.shape[0], parts.shape[-1])  # a thread with no partial: 0
        for i in range(parts.shape[1]):
            total = total + parts[:, i]
        return total

    if plan.mode == "A":
        tot_s, tot_q = in_order(part_s), in_order(part_q)
    else:
        sub = 256 // groups if groups <= 256 else 1
        sums = []
        for part in (part_s, part_q):
            clusters = part.reshape(n, -1, k, groups)
            cl = torch.stack([in_order(clusters[:, p]) for p in range(clusters.shape[1])], 1)
            sums.append(in_order(torch.stack([in_order(cl[:, k0::sub]) for k0 in range(sub)], 1)))
        tot_s, tot_q = sums
    inv = torch.tensor(1.0 / np.float32(s * cg), dtype=torch.float32)
    mean = tot_s * inv
    rstd = torch.rsqrt(tot_q * inv - mean * mean + eps)
    ga = scale.float().reshape(groups, cg)[None] * rstd[..., None]
    be = bias.float().reshape(groups, cg)[None] - mean[..., None] * ga
    out = xf.reshape(n, s, groups, cg) * ga[:, None] + be[:, None]
    if act == "silu":
        out = out * torch.sigmoid(out)
    elif act == "relu":
        out = torch.relu(out)
    return out.reshape(n, s, c)


_SHAPES = [(2, 64, 128, 32), (3, 48, 96, 32), (2, 21, 12, 4)]


@functools.lru_cache(maxsize=None)
def _case(shape, act):
    n, s, c, groups = shape
    rng = np.random.default_rng([*shape, [None, "silu", "relu"].index(act)])
    x = rng.normal(size=(n, s, c)).astype(np.float32) * 2 + 0.5
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    want = np.asarray(jax_fused_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                   groups, 1e-6, act, True))
    return x, scale, bias, want


def _plans(kind, n, s, c, groups):
    if kind == "A":
        return _plan_a(n, s, c, groups, 4)
    if kind == "A4":  # the same item over a cluster of 4 blocks
        p = _plan_a(n, s, c, groups, 4)
        return p._replace(cluster=4, rows=_cdiv(s, 4))
    return _plan_b(n, s, c, groups, 4)._replace(rows=5, cluster=3)  # 3-chunk clusters


@pytest.mark.parametrize("kind", ["A", "A4", "B"])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_planned_matches_pallas_interpret(shape, act, kind):
    x, scale, bias, want = _case(shape, act)
    n, s, c, groups = shape
    plan = _plans(kind, n, s, c, groups)
    got = planned_group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), groups, 1e-6, act, plan)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
