"""The port's CUDA kernels against their plain versions, on the GPU.

These need the card and skip without one.  The repo's conftest imports JAX,
which the GPU machine need not have, so run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only, and takes chip_smoke.py's
limits.  Shapes are small: chip_smoke.py covers the main path's shapes.
"""

from collections import Counter

import pytest
import torch

from chip_smoke import F32_TOL, bf16_ok, kernel_error

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def assert_close(got, want, dtype):
    err, rel = kernel_error(got, want)
    if dtype == torch.float32:
        assert err < F32_TOL
    else:
        assert bf16_ok(err, rel), (err, rel)


# The first four cases, then the flagship widths, K4's ragged tail (S = 1617),
# one 128-row tile plus one row (S = 129), fewer rows than one tile (S = 5),
# the largest D of the wgmma instance (128) and the first of the mma.sync
# instance (136).
FLASH_CASES = [
    (2, 300, 8, 40), (1, 77, 2, 80), (1, 64, 1, 256), (3, 5, 4, 8),
    (2, 1536, 8, 40), (2, 384, 8, 80), (2, 1617, 8, 40), (1, 129, 8, 40), (1, 5, 8, 40),
    (1, 300, 2, 128), (1, 300, 2, 136),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", FLASH_CASES)
def test_flash_kernel(gen, dtype, b, s, h, d):
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_rand(gen, b, s, h * d, dtype=dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, d ** -0.5, h)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(), d ** -0.5, h)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,f,h,d", [
    (16, 16, 8, 40), (16, 16, 8, 80), (16, 16, 8, 160),  # F = 16: k = 8 tail, 5 and 10 k-steps
    (8, 24, 8, 160),  # key tiles padded to 32, the second query tile half empty
    (8, 64, 2, 32), (24, 3, 1, 8),  # four query tiles; one tile of 3 and D < 16
    (8, 16, 5, 40), (1000, 16, 5, 40),  # 5 heads: one head per block; all five in one block
    (136, 48, 1, 400),  # a unit above 48 KB of shared memory (the opt-in limit)
])
def test_temporal_kernel(gen, dtype, n, f, h, d):
    from synfmc_tpu_torch.ops.temporal_attention import (
        temporal_attention,
        temporal_attention_plain,
    )

    q, k, v = (_rand(gen, n, f, h * d, dtype=dtype) for _ in range(3))
    before = temporal_attention.launches
    got = temporal_attention(q, k, v, d ** -0.5, h)
    assert temporal_attention.launches == before + 1
    want = temporal_attention_plain(q.float(), k.float(), v.float(), d ** -0.5, h)
    assert_close(got, want, dtype)


# The first four cases, then K3's plans and their edges: the level-0 key
# (mode A, clusters of 8), the up block's 960 channels (groups of 60 bf16
# bytes, runs of 4), the VAE's first decoder level at N = 1 (48 blocks), a
# VAE slab that fits no cluster (mode B), and 12 channels in 4 groups (24
# bf16 bytes a row: 8-byte copies).
GN_CASES = [(2, 96, 320, 32, "silu"), (1, 4096, 128, 32, None), (3, 7, 12, 4, "relu"),
            (2, 24, 2560, 32, "silu"), (32, 1536, 320, 32, "silu"), (32, 1536, 960, 32, "silu"),
            (1, 1536, 512, 32, "silu"), (1, 98304, 128, 32, "silu"), (3, 7, 12, 4, None)]


def _gn_inputs(gen, n, s, c, dtype):
    x = _rand(gen, n, s, c, dtype=dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,s,c,groups,act", GN_CASES)
def test_group_norm_kernel(gen, dtype, n, s, c, groups, act):
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain

    x, w, b = _gn_inputs(gen, n, s, c, dtype)
    before = fused_group_norm.launches
    got = fused_group_norm(x, w, b, groups, 1e-6, act)
    assert fused_group_norm.launches == before + 1
    want = group_norm_plain(x.float(), w.float(), b.float(), groups, 1e-6, act)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("n,s,c,kernels", [(32, 1536, 320, ["gn_cluster"]),
                                           (1, 1536, 512, ["gn_cluster"]),
                                           (1, 98304, 128, ["gn_partials", "gn_apply"])])
def test_group_norm_launches(gen, n, s, c, kernels):
    """A mode-A call is one CUDA kernel, a mode-B call two, counted by
    chip_smoke.py's trace; two calls give the same bits."""
    from chip_smoke import gn_launches
    from synfmc_tpu_torch.ops.fused_groupnorm import _plan, fused_group_norm

    assert _plan(n, s, c, 32, 2).mode == ("A" if len(kernels) == 1 else "B")
    x, w, b = _gn_inputs(gen, n, s, c, torch.bfloat16)
    first = fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert gn_launches(lambda: fused_group_norm(x, w, b, 32, 1e-6, "silu")) == Counter(kernels)
    assert torch.equal(first, fused_group_norm(x, w, b, 32, 1e-6, "silu"))


def test_group_norm_plan_refusal(gen):
    """A plan whose shared bytes disagree with the kernel's layout, whose
    clusters do not cover the rows, or whose cluster is too large, is refused
    by the C entry with an error and launches nothing."""
    from synfmc_tpu_torch.ops.fused_groupnorm import _entry, _plan

    n, s, c = 32, 1536, 320
    x, w, b = _gn_inputs(gen, n, s, c, torch.bfloat16)
    out = torch.zeros_like(x)
    work = torch.empty(0, device="cuda")
    p = _plan(n, s, c, 32, 2)
    for bad in (p._replace(smem=p.smem + 16), p._replace(rows=p.rows - 1),
                p._replace(cluster=9)):
        err = _entry(x.dtype)(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                              work.data_ptr(), n, s, c, 32, 1e-6, 1, 0, bad.run, bad.cluster,
                              bad.rows, bad.vec, bad.smem, torch.cuda.current_stream().cuda_stream)
        assert err != 0, bad
    torch.cuda.synchronize()
    assert not out.any()


def test_group_norm_silu_range(gen):
    """The fused SiLU over v in [-20, 20], chip_smoke.py's check."""
    from chip_smoke import gn_silu_range

    gn_silu_range()


def assert_grads_close(got, want, dtype):
    """Gradient by gradient: chip_smoke.py's backward check in bf16, < 1e-4
    of the largest magnitude in fp32."""
    from chip_smoke import bwd_ok

    for g, w in zip(got, want):
        err, rel = kernel_error(g, w)
        assert (rel < F32_TOL) if dtype == torch.float32 else bwd_ok(err, rel), (err, rel)


@pytest.mark.parametrize("b,s,h,d", [(2, 1536, 8, 40), (2, 384, 8, 80), (1, 129, 8, 40),
                                     (1, 300, 2, 128), (1, 300, 2, 136)])
def test_flash_lse_matches_logsumexp(gen, b, s, h, d):
    """K1's fp32 log-sum-exp (read by the backward) equals torch.logsumexp of
    the plain fp32 logits of the bf16-scaled q, within 1e-2."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v = (_rand(gen, b, s, h * d, dtype=torch.bfloat16) for _ in range(3))
    _, lse = flash_attention_fwd(q, k, v, d ** -0.5, h, with_lse=True)
    split = lambda x: x.float().view(b, s, h, d).transpose(1, 2)
    logits = split((q.float() * d ** -0.5).to(torch.bfloat16)) @ split(k).transpose(-1, -2)
    assert (lse - torch.logsumexp(logits, dim=-1)).abs().max().item() < 1e-2


@pytest.mark.parametrize("b,s,h,d", [(2, 1536, 8, 40), (1, 1617, 2, 40), (2, 384, 8, 80),
                                     (1, 300, 2, 136)])
def test_flash_fwd_deterministic(gen, b, s, h, d):
    """Two calls give the same bits, output and log-sum-exp."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v = (_rand(gen, b, s, h * d, dtype=torch.bfloat16) for _ in range(3))
    first = flash_attention_fwd(q, k, v, d ** -0.5, h, with_lse=True)
    second = flash_attention_fwd(q, k, v, d ** -0.5, h, with_lse=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("d,kernel", [(40, "flash_fwd_wgmma"), (80, "flash_fwd_wgmma"),
                                      (128, "flash_fwd_wgmma"), (136, "flash_fwd_mma")])
def test_flash_fwd_runs_its_instance(gen, d, kernel):
    """The bf16 forward launches the instance fwd_instance names, and only
    that one."""
    from torch.profiler import ProfilerActivity, profile

    from synfmc_tpu_torch.ops.flash_attention import flash_attention, fwd_instance

    q = _rand(gen, 1, 200, 2 * d, dtype=torch.bfloat16)
    flash_attention(q, q, q, d ** -0.5, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, q, q, d ** -0.5, 2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_fwd" in e.name]
    assert names and all(kernel in n for n in names), names
    assert kernel == {"wgmma": "flash_fwd_wgmma", "mma_sync": "flash_fwd_mma"}[fwd_instance(d)[0]]


def test_flash_fwd_blocks_fit_the_optin(gen):
    """Each bf16 instance's block, as the launcher sizes it, fits this card's
    opt-in at every D the gate takes; worked by hand: a wgmma stage is 128
    keys x (QK^T depth + PV's N) bf16, two Q buffers of 192 rows (depth <= 48)
    or 128 on rows padded by 8, 16 bytes of mbarriers a stage and 32 for the
    Q buffers, as many of 4, 3, 2 stages as fit 232,448 bytes; the mma.sync
    block a 64-row q tile and two double-buffered 64-key K/V tiles."""
    from synfmc_tpu_torch.ops import _cuda

    smem = _cuda.entry("flash_fwd", "synfmc_flash_fwd_bf16_smem", [_cuda.I])
    assert smem(40) == 4 * 128 * (48 + 40) * 2 + 2 * 192 * 56 * 2 + 8 * 12 == 133216
    assert smem(80) == 4 * 128 * 160 * 2 + 2 * 128 * 88 * 2 + 8 * 12 == 208992
    assert smem(96) == 3 * 128 * 192 * 2 + 2 * 128 * 104 * 2 + 8 * 10 == 200784
    assert smem(112) == 2 * 128 * 224 * 2 + 2 * 128 * 120 * 2 + 8 * 8 == 176192
    assert smem(128) == 2 * 128 * 256 * 2 + 2 * 128 * 136 * 2 + 8 * 8 == 200768
    assert smem(136) == (64 + 4 * 64) * (144 + 8) * 2 == 97280
    assert smem(12) == smem(264) == 0
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert all(0 < smem(d) <= optin for d in range(8, 257, 8))


# The first five cases, then the edges of the tiles: K7's ragged tail (S =
# 1617), one row past a 128-row tile (S = 129) at D = 40, 80 and 256, fewer
# rows than one tile (S = 5) at D = 40, and one level-0 key.
FLASH_BWD_CASES = [
    (2, 300, 8, 40), (1, 77, 2, 80), (1, 130, 1, 256), (3, 5, 4, 8), (1, 384, 8, 80),
    (1, 1617, 2, 40), (2, 129, 2, 40), (2, 129, 2, 80), (1, 129, 2, 256), (2, 5, 2, 40),
    (2, 1536, 8, 40),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", FLASH_BWD_CASES)
def test_flash_bwd_kernel(gen, dtype, b, s, h, d):
    from synfmc_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = (_rand(gen, b, s, h * d, dtype=dtype) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, d ** -0.5, h, with_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, h)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), d ** -0.5, h)
    assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("b,s,h,d", [(2, 1536, 8, 40), (1, 1617, 2, 40), (2, 129, 2, 80)])
def test_flash_bwd_deterministic(gen, b, s, h, d):
    """Two calls on the same inputs give the same bits: no output is summed
    across blocks in an order that changes from run to run."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    q, k, v, do = (_rand(gen, b, s, h * d, dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, d ** -0.5, h, with_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, h)
    second = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, h)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


# The first four cases, then the tensor-core kernel's edges: the m16n8k8
# tail of D = 40 at a level-0-like shape, the mid block's F = 24 with one
# head a block, an H with no even divisor (few and many units), and a unit
# above 48 KB of shared memory (bf16 only: the fp32 kernel cannot hold one
# head of that size).
TEMPORAL_BWD_CASES = [
    (16, 16, 8, 40), (8, 24, 8, 160), (8, 64, 2, 32), (24, 3, 1, 8),
    (64, 16, 8, 40), (16, 24, 8, 160), (8, 16, 5, 40), (1000, 16, 5, 40),
]


@pytest.mark.parametrize("dtype,n,f,h,d", [
    (dtype, *case) for case in TEMPORAL_BWD_CASES for dtype in (torch.bfloat16, torch.float32)
] + [(torch.bfloat16, 136, 48, 1, 400)])
def test_temporal_bwd_kernel(gen, dtype, n, f, h, d):
    from synfmc_tpu_torch.ops.temporal_attention import (
        temporal_attention_bwd,
        temporal_attention_bwd_plain,
    )

    q, k, v, do = (_rand(gen, n, f, h * d, dtype=dtype) for _ in range(4))
    before = temporal_attention_bwd.launches
    got = temporal_attention_bwd(q, k, v, do, d ** -0.5, h)
    assert temporal_attention_bwd.launches == before + 1
    want = temporal_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), d ** -0.5, h)
    assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("kind", ["flash", "temporal", "group_norm"])
def test_gradient_through_wrapper_matches_plain(gen, kind):
    """On the card each wrapper's output carries a grad_fn, and autograd
    through it (kernel forward, kernel or PyTorch-ops backward) gives the
    gradients of autograd through the plain forward (fp32, TF32 off)."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain
    from synfmc_tpu_torch.ops.temporal_attention import (
        temporal_attention,
        temporal_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "group_norm":
        inputs = (_rand(gen, 2, 96, 64, dtype=torch.float32),
                  1 + 0.1 * _rand(gen, 64, dtype=torch.float32),
                  0.1 * _rand(gen, 64, dtype=torch.float32))
        fn, plain, args = fused_group_norm, group_norm_plain, (32, 1e-6, "silu")
    else:
        shape = (2, 300, 64) if kind == "flash" else (16, 16, 64)
        inputs = tuple(_rand(gen, *shape, dtype=torch.float32) for _ in range(3))
        fn, plain = ((flash_attention, flash_attention_plain) if kind == "flash"
                     else (temporal_attention, temporal_attention_plain))
        args = (0.25, 4)
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = fn(*leaves, *args)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, leaves, cot)
    ref = [x.clone().requires_grad_() for x in inputs]
    want = torch.autograd.grad(plain(*ref, *args), ref, cot)
    for g, w in zip(got, want):
        assert kernel_error(g, w)[1] < F32_TOL


@pytest.mark.parametrize("kernel", ["group_norm", "flash_fwd", "temporal_fwd", "flash_bwd",
                                    "temporal_bwd"])
def test_unloadable_kernel_raises(gen, monkeypatch, kernel):
    """A CUDA tensor never drops to the plain version, forward or backward: a
    library that cannot be loaded raises out of the wrapper."""
    from synfmc_tpu_torch.ops import _cuda
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention, temporal_attention_bwd

    def no_lib(name):
        raise RuntimeError(f"no {name} library")

    monkeypatch.setattr(_cuda, "load", no_lib)
    monkeypatch.setattr(_cuda, "_entries", {})
    x = _rand(gen, 8, 16, 32, dtype=torch.bfloat16)
    w = torch.ones(32, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(8, 4, 16, device="cuda")
    fn, args = {"group_norm": (fused_group_norm, (x, w, w, 4)),
                "flash_fwd": (flash_attention, (x, x, x, 0.5, 4)),
                "temporal_fwd": (temporal_attention, (x, x, x, 0.5, 4)),
                "flash_bwd": (flash_attention_bwd, (x, x, x, x, lse, x, 0.5, 4)),
                "temporal_bwd": (temporal_attention_bwd, (x, x, x, x, 0.5, 4))}[kernel]
    with pytest.raises(RuntimeError, match=f"no {kernel} library"):
        fn(*args)


def test_smem_optin_matches_device(gen):
    """The temporal gate's opt-in constant is this card's."""
    from synfmc_tpu_torch.ops.temporal_attention import SMEM_OPTIN

    assert torch.cuda.get_device_properties(0).shared_memory_per_block_optin == SMEM_OPTIN


@pytest.mark.parametrize("n,f,h,d", [(8, 48, 1, 400), (8, 64, 1, 256)])
def test_attention_declined_temporal_shape_runs_plain(gen, n, f, h, d):
    """fp32 shapes whose K8 unit passes the opt-in take the plain path, with
    gradients, and match plain_attention (fp32, TF32 off)."""
    from synfmc_tpu_torch.ops.attention import dot_product_attention, plain_attention, route
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = [_rand(gen, n, f, h, d, dtype=torch.float32) for _ in range(3)]
    assert route(inputs[0], inputs[1]) == "plain"
    before = temporal_attention.launches
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = dot_product_attention(*leaves)
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    got = (out, *torch.autograd.grad(out, leaves, cot))
    ref = [x.clone().requires_grad_() for x in inputs]
    want_out = plain_attention(*ref, d ** -0.5)
    want = (want_out, *torch.autograd.grad(want_out, ref, cot))
    assert temporal_attention.launches == before
    for g, w in zip(got, want):
        assert kernel_error(g, w)[1] < F32_TOL


def test_group_norm_wide_slab_runs_plain(gen):
    """norms.group_norm sends C = 8192 (above K3's 6144) to the plain version
    and a slab off 16 bytes to K3 on a copy; both match group_norm_plain."""
    from synfmc_tpu_torch.ops import norms
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain

    for c, offset in ((8192, 0), (320, 1)):
        buf = _rand(gen, 2 * 96 * c + offset, dtype=torch.bfloat16)
        x = buf[offset:].view(2, 96, c)
        w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        before = fused_group_norm.launches
        got = norms.group_norm(x, w, b, 32, 1e-6, "silu")
        assert fused_group_norm.launches == before + (c <= 6144)
        want = group_norm_plain(x.float(), w.float(), b.float(), 32, 1e-6, "silu")
        assert_close(got, want, torch.bfloat16)


@pytest.fixture(scope="module")
def obj_pipes():
    """The tiny obj-stage pipeline in fp32 on the CPU and, with the same
    weights, on the GPU (TF32 off), at 8 frames of 128x192: K1 takes level 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import OBJ_YAML, tiny_config
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config(mixed_precision=False, path=OBJ_YAML)
    # every conditioning path live: the seeded weights without the structural zeros
    cpu = randomize_pipeline_(build_pipeline(cfg, stage="obj", device="cpu", seed=0,
                                             allow_untrained_cm=True)[0], 0)
    gpu = build_pipeline(cfg, stage="obj", device="cuda", seed=1, allow_untrained_cm=True)[0]
    for name in ("unet", "vae", "text_encoder", "pose_encoder", "adapter"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    return cpu, gpu


def _unet_inputs(pipe, frames=8, height=128, width=192):
    """A CFG pair's UNet inputs on the pipeline's device, the same on both
    devices: latents, timesteps, context, pose and (uncond-zeroed) traj
    features made through the adapter."""
    from chip_smoke import object_traj, plucker

    gen = torch.Generator().manual_seed(3)
    lat = torch.randn(2, frames, height // 8, width // 8, 4, generator=gen).to(pipe.device)
    ctx = pipe.encode_prompt("a yellow bird hops along the road")
    pose = pipe.encode_pose(plucker(pipe, "pan", frames, height, width))
    traj = object_traj(pipe, 5, frames, height, width)
    t = torch.full((2,), 751, device=pipe.device)
    return lat, t, ctx, pose, traj


def _on_both(obj_pipes, fn):
    """fn(pipe, inputs) on the CPU (plain versions) and the GPU (kernels):
    the outputs, and each kernel's launches on the GPU run."""
    from chip_smoke import counters

    out = {}
    for pipe in obj_pipes:
        with torch.inference_mode():
            inputs = _unet_inputs(pipe)
            before = {k: c.launches for k, c in counters().items()}
            got = fn(pipe, *inputs)
            launched = {k: c.launches - before[k] for k, c in counters().items()}
        out[pipe.device.type] = (got.cpu() if torch.is_tensor(got) else got, launched)
    return out


def test_batch_b_forward_matches_cpu(obj_pipes):
    """A CFG-cache step's forward: the cond half alone at batch 1."""
    def fn(pipe, lat, t, ctx, pose, traj):
        return pipe.unet(lat[1:], t[1:], ctx[1:], pose_features=pose, traj_features=traj)

    out = _on_both(obj_pipes, fn)
    assert out["cuda"][1]["flash"] > 0 and out["cuda"][1]["group_norm"] > 0
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() < 1e-3


@pytest.mark.parametrize("batch", [2, 1], ids=["pair", "turbo"])
def test_shallow_forward_matches_cpu(obj_pipes, batch):
    """DeepCache's shallow forward on the pair, and at batch 1 with the cond
    half of the cache (turbo), on each device's own recorded cache."""
    from chip_smoke import PER_SHALLOW, counters

    def fn(pipe, lat, t, ctx, pose, traj):
        pose2 = [torch.cat([p, p]) for p in pose]
        traj2 = [torch.cat([torch.zeros_like(tr), tr]) for tr in traj]
        _, deep = pipe.unet(lat, t, ctx, pose_features=pose2, traj_features=traj2,
                            return_deep=True)
        before = {k: c.launches for k, c in counters().items()}
        if batch == 2:
            eps = pipe.unet(lat, t, ctx, pose_features=pose2, traj_features=traj2,
                            deep_cache=deep)
        else:
            eps = pipe.unet(lat[1:], t[1:], ctx[1:], pose_features=pose, traj_features=traj,
                            deep_cache=deep[1:])
        fn.shallow = {k: c.launches - before[k] for k, c in counters().items()}
        return eps

    out = _on_both(obj_pipes, fn)  # the GPU runs last: fn.shallow holds its launches
    assert {k: fn.shallow[k] for k in PER_SHALLOW} == PER_SHALLOW
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() < 1e-3


def test_chunked_decode_matches_cpu(obj_pipes):
    """8 latent frames decoded 4 a call: one K3 launch per GroupNorm a call."""
    from chip_smoke import PER_DECODE
    from synfmc_tpu_torch.pipelines.animation import decode_latents

    def fn(pipe, lat, *_):
        return decode_latents(pipe.vae, lat[:1], decode_chunk=4)

    out = _on_both(obj_pipes, fn)
    assert out["cuda"][1]["group_norm"] == 2 * PER_DECODE["group_norm"]
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() < 1e-3
