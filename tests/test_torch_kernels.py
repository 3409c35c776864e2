"""The port's kernel modules on the CPU: each CUDA kernel's plain version
against the JAX package's Pallas kernel in interpret mode, the attention
router against synfmc_tpu/ops/attention.py's rules, and the loud failures
(no GPU, no nvcc) that replace any silent fallback.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.ops.flash_attention import flash_attention as jax_flash
from synfmc_tpu.ops.norms import group_norm as jax_group_norm
from synfmc_tpu.ops.pallas_groupnorm import fused_group_norm as jax_fused_gn
from synfmc_tpu.ops.temporal_attention import _fwd_call as jax_temporal_fwd
from synfmc_tpu_torch.ops import _cuda
from synfmc_tpu_torch.ops.attention import dot_product_attention, route
from synfmc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
)
from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain
from synfmc_tpu_torch.ops.temporal_attention import (
    temporal_attention,
    temporal_attention_bwd,
    temporal_attention_plain,
)

ATOL = 2e-5


# The first three cases, then the CUDA kernel's tile edges: one 128-key tile
# plus one key, fewer keys than a tile, two and a half tiles at D = 80, three
# tiles at D = 128.
@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 40), (1, 48, 4, 16), (2, 24, 2, 80),
                                     (1, 129, 2, 40), (2, 5, 2, 40), (2, 300, 2, 80),
                                     (1, 384, 1, 128)])
def test_flash_plain_matches_pallas_interpret(rng, b, s, h, d):
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True))
    t = lambda x: torch.from_numpy(x).reshape(b, s, h * d)
    got = flash_attention_plain(t(q), t(k), t(v), scale, h).reshape(b, s, h, d).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = flash_attention.launches
    np.testing.assert_array_equal(flash_attention(t(q), t(k), t(v), scale, h).numpy(),
                                  got.reshape(b, s, h * d))
    assert flash_attention.launches == before


@pytest.mark.parametrize("n,f,h,d", [(8, 16, 2, 40), (16, 24, 4, 16), (8, 16, 1, 160), (8, 3, 1, 8)])
def test_temporal_plain_matches_pallas_interpret(rng, n, f, h, d):
    q, k, v = (rng.normal(size=(n, f, h * d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    want = np.asarray(jax_temporal_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       scale, h, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = temporal_attention_plain(tq, tk, tv, scale, h).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    before = temporal_attention.launches
    np.testing.assert_array_equal(temporal_attention(tq, tk, tv, scale, h).numpy(), got)
    assert temporal_attention.launches == before


@pytest.mark.parametrize("act", [None, "silu", "relu"])
def test_group_norm_plain_matches_pallas_interpret(rng, act):
    x = rng.normal(size=(2, 8, 8, 128)).astype(np.float32) * 2 + 0.5
    scale = rng.normal(size=(128,)).astype(np.float32)
    bias = rng.normal(size=(128,)).astype(np.float32)
    want = np.asarray(jax_fused_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                   1e-6, act, True))
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    got = group_norm_plain(tx, ts, tb, 32, 1e-6, act).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    before = fused_group_norm.launches
    np.testing.assert_array_equal(fused_group_norm(tx, ts, tb, 32, 1e-6, act).numpy(), got)
    assert fused_group_norm.launches == before


@pytest.mark.parametrize("c,act", [(96, "silu"), (960, None)])
def test_group_norm_plain_matches_xla_group_norm(rng, c, act):
    x = rng.normal(size=(3, 4, 6, c)).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                     eps=1e-6, act=act, use_pallas=False))
    got = group_norm_plain(*(torch.from_numpy(a) for a in (x, scale, bias)), 32, 1e-6, act)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


# Every attention call of the slice at the flagship shapes (CFG pair x 16
# frames at 256x384), plus the edges of each gate.
_ROUTE_CASES = [
    # (q shape (B, S, H, D), kv length, masked)
    ((32, 1536, 8, 40), 1536, False),   # level-0 spatial self
    ((32, 384, 8, 80), 384, False),     # level-1 spatial self
    ((32, 96, 8, 160), 96, False),      # level-2 spatial self
    ((32, 24, 8, 160), 24, False),      # mid-block spatial self
    ((32, 1536, 8, 40), 77, False),     # cross-attention to text
    ((32, 24, 8, 160), 77, False),
    ((3072, 16, 8, 40), 16, False),     # motion modules
    ((768, 16, 8, 80), 16, False),
    ((192, 16, 8, 160), 16, False),
    ((48, 16, 8, 160), 16, False),
    ((1536, 16, 8, 40), 16, False),     # pose encoder, batch 1
    ((24, 16, 8, 160), 16, False),
    ((1, 1536, 1, 512), 1536, False),   # VAE mid-block attention
    ((2, 77, 12, 64), 77, True),        # CLIP, causal mask
    ((4, 16, 8, 40), 16, False),        # too few rows for the temporal kernel
    ((12, 16, 8, 40), 16, False),       # rows not a multiple of 8
    ((8, 1, 8, 40), 1, False),          # one frame
    ((2, 256, 4, 64), 256, False),      # flash threshold
    ((2, 255, 4, 64), 255, False),
]


def _jax_route(monkeypatch, qshape, sk, masked):
    """The path synfmc_tpu's dispatch takes on a TPU backend, recorded
    without running anything."""
    import synfmc_tpu.ops.flash_attention as fa
    import synfmc_tpu.ops.temporal_attention as ta
    from synfmc_tpu.ops.attention import dot_product_attention as jax_dpa

    taken = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, scale: taken.append("flash") or q)
    monkeypatch.setattr(ta, "temporal_attention",
                        lambda q, k, v, scale, h: taken.append("temporal") or q)
    b, s, h, d = qshape
    q = jax.ShapeDtypeStruct(qshape, jnp.bfloat16)
    k = jax.ShapeDtypeStruct((b, sk, h, d), jnp.bfloat16)
    mask = jnp.zeros((1, 1, s, sk)) if masked else None
    jax.eval_shape(lambda q, k: jax_dpa(q, k, k, mask=mask), q, k)
    return taken[0] if taken else "plain"


@pytest.mark.parametrize("qshape,sk,masked", _ROUTE_CASES)
def test_routing_matches_jax_dispatch(monkeypatch, qshape, sk, masked):
    b, s, h, d = qshape
    q = torch.empty(qshape, dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, sk, h, d), dtype=torch.bfloat16, device="meta")
    mask = torch.zeros(1, 1, s, sk) if masked else None
    assert route(q, k, mask) == _jax_route(monkeypatch, qshape, sk, masked)


def test_dispatch_runs_each_path_on_cpu(rng):
    """dot_product_attention's three paths agree with the plain attention."""
    from synfmc_tpu_torch.ops.attention import plain_attention

    for shape in [(2, 256, 2, 16), (8, 16, 2, 16), (2, 96, 2, 16)]:
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(3))
        got = dot_product_attention(q, k, v)
        want = plain_attention(q, k, v, shape[-1] ** -0.5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("fault", [None, "output 3% high", "16 keys dropped"])
def test_bf16_kernel_check_fails_faulty_kernels(rng, fault):
    """chip_smoke.py's bf16 check at a main-path head shape (S=384, D=80):
    the plain version on bf16 operands (the roundings a sound kernel makes)
    passes it, a kernel wrong by a few percent or missing a few keys fails."""
    from chip_smoke import bf16_ok, kernel_error

    b, s, h, d = 2, 384, 8, 80
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = flash_attention_plain(q.float(), k.float(), v.float(), d ** -0.5, h)
    if fault is None:
        got = flash_attention_plain(q, k, v, d ** -0.5, h)
    elif fault == "output 3% high":
        got = flash_attention_plain(q, k, v, d ** -0.5, h).float() * 1.03
    else:
        got = flash_attention_plain(q, k[:, :-16], v[:, :-16], d ** -0.5, h)
    assert bf16_ok(*kernel_error(got, want)) == (fault is None)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("SYNFMC_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.load("group_norm")


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["group_norm", "flash_fwd", "temporal_fwd", "flash_bwd",
                                    "temporal_bwd"])
def test_cuda_tensor_never_falls_back(monkeypatch, kernel):
    """On a CUDA tensor a wrapper, forward or backward, asks for its kernel,
    and a library that cannot be loaded raises out of the wrapper instead of
    running the plain version."""
    asked = []

    def no_lib(name):
        asked.append(name)
        raise RuntimeError(f"no {name} library")

    monkeypatch.setattr(_cuda, "load", no_lib)
    monkeypatch.setattr(_cuda, "_entries", {})
    x = torch.zeros((8, 16, 32)).as_subclass(_ReportsCuda)
    assert x.device.type == "cuda"
    fn, args = {"group_norm": (fused_group_norm, (x, torch.ones(32), torch.zeros(32), 4)),
                "flash_fwd": (flash_attention, (x, x, x, 0.5, 4)),
                "temporal_fwd": (temporal_attention, (x, x, x, 0.5, 4)),
                "flash_bwd": (flash_attention_bwd, (x, x, x, x, torch.zeros(8, 4, 16), x, 0.5, 4)),
                "temporal_bwd": (temporal_attention_bwd, (x, x, x, x, 0.5, 4))}[kernel]
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"no {kernel} library"):
        fn(*args)
    assert asked == [kernel] and fn.launches == before


def test_build_pipeline_requires_gpu_unless_cpu_asked(monkeypatch):
    from synfmc_tpu_torch.pipelines.factory import build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline({})
