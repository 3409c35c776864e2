"""The port's backward kernels on the CPU: each plain backward against the
JAX package's Pallas backward in interpret mode (jax.vjp of the JAX
function), the autograd Functions around the three kernel wrappers, and
chip_smoke.py's backward check against faulty gradients.  (The backward
wrappers' refusal to fall back is in test_torch_kernels.py.)

Shapes, fp32, each chosen to reach one TPU kernel:
  K5 _bwd_packed_single_kernel  S=256, 2 heads of 8;
  K6 _bwd_packed_kernel         B=1, S=2048, 2 heads of 8 (too long for the
                                whole-sequence kernel: _bwd_single_fits is false);
  K7 _bwd_kernel (padded)       S=260, through _prep / _bwd, where the forward
                                is K4, _fwd;
  K8 temporal _bwd_kernel       N=16, F=16, 2 heads of 8; and the CUDA
                                kernel's shape classes: F=24 (two 16-key
                                tiles, the second half empty) at D=40 (an
                                m16n8k8 tail), and F=3 with one head.
Tolerance: 1e-5 absolute plus 1e-4 relative (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.ops.flash_attention import _bwd_single_fits
from synfmc_tpu.ops.flash_attention import flash_attention as jax_flash
from synfmc_tpu.ops.pallas_groupnorm import fused_group_norm as jax_fused_gn
from synfmc_tpu.ops.temporal_attention import temporal_attention as jax_temporal
from synfmc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_bwd, group_norm_plain
from synfmc_tpu_torch.ops.temporal_attention import (
    temporal_attention,
    temporal_attention_bwd_plain,
    temporal_attention_plain,
)

TOL = dict(atol=1e-5, rtol=1e-4)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _jax_flash_vjp(q, k, v, g, scale):
    out, vjp = jax.vjp(lambda *a: jax_flash(*a, scale, True), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("kernel,b,s", [("K5", 2, 256), ("K6", 1, 2048), ("K7", 1, 260)])
def test_flash_bwd_plain_matches_pallas_interpret(rng, kernel, b, s):
    h, d = 2, 8
    if kernel == "K6":
        assert not _bwd_single_fits(s, h * d)  # the q-blocked kernel
    elif kernel == "K5":
        assert _bwd_single_fits(s, h * d)
    q, k, v, g = (_normal(rng, b, s, h, d) for _ in range(4))
    scale = d ** -0.5
    want_out, want = _jax_flash_vjp(q, k, v, g, scale)
    t = lambda x: torch.from_numpy(x).reshape(b, s, h * d)
    got = flash_attention_bwd_plain(t(q), t(k), t(v), t(g), scale, h)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.reshape(b, s, h, d).numpy(), y, **TOL, err_msg=f"d{name}")
    if kernel == "K7":  # the padded forward, K4
        out = flash_attention_plain(t(q), t(k), t(v), scale, h).reshape(b, s, h, d)
        np.testing.assert_allclose(out.numpy(), want_out, **TOL)


@pytest.mark.parametrize("n,f,h,d", [(16, 16, 2, 8), (8, 24, 2, 40), (8, 3, 1, 16)])
def test_temporal_bwd_plain_matches_pallas_interpret(rng, n, f, h, d):
    q, k, v, g = (_normal(rng, n, f, h * d) for _ in range(4))
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_temporal(*a, scale, h, True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = temporal_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, g)), scale, h)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("act", [None, "silu", "relu"])
def test_group_norm_bwd_matches_jax_vjp(rng, act):
    """JAX differentiates its XLA path (_fused_gn_bwd); the port's backward
    is the same VJP written out in PyTorch ops."""
    x = _normal(rng, 2, 4, 6, 64) * 2 + 0.5
    scale, bias, g = 1 + 0.1 * _normal(rng, 64), 0.1 * _normal(rng, 64), _normal(rng, 2, 4, 6, 64)
    _, vjp = jax.vjp(lambda *a: jax_fused_gn(*a, 32, 1e-6, act, True),
                     *map(jnp.asarray, (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    got = group_norm_bwd(*(torch.from_numpy(a) for a in (x, scale, bias, g)), 32, 1e-6, act)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


def _wrapper_case(kind, rng):
    """(wrapper, differentiable inputs, extra args, plain forward)."""
    if kind == "group_norm":
        x = torch.from_numpy(_normal(rng, 2, 6, 8, 64))
        w, b = torch.from_numpy(1 + 0.1 * _normal(rng, 64)), torch.from_numpy(_normal(rng, 64))
        return fused_group_norm, (x, w, b), (32, 1e-6, "silu"), group_norm_plain
    shape = (2, 256, 32) if kind == "flash" else (16, 8, 32)
    qkv = tuple(torch.from_numpy(_normal(rng, *shape)) for _ in range(3))
    if kind == "flash":
        return flash_attention, qkv, (0.25, 4), flash_attention_plain
    return temporal_attention, qkv, (0.25, 4), temporal_attention_plain


@pytest.mark.parametrize("kind", ["flash", "temporal", "group_norm"])
def test_wrapper_output_carries_grad_fn(rng, kind):
    """An input that requires grad gives an output with a grad_fn (the
    wrapper's autograd Function), whose gradients equal autograd through the
    plain forward.  Without one, no graph is recorded."""
    fn, inputs, args, plain = _wrapper_case(kind, rng)
    assert fn(*inputs, *args).grad_fn is None
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = fn(*leaves, *args)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_")
    cot = torch.from_numpy(_normal(rng, *out.shape))
    got = torch.autograd.grad(out, leaves, cot)
    ref = [x.clone().requires_grad_() for x in inputs]
    want = torch.autograd.grad(plain(*ref, *args), ref, cot)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_no_grad_through_frozen_operands(rng):
    """Only the operands that require grad get one: a frozen GroupNorm affine
    is not differentiated."""
    fn, (x, w, b), args, _ = _wrapper_case("group_norm", rng)
    x = x.requires_grad_()
    fn(x, w, b, *args).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None


@pytest.mark.parametrize("fault", [None, "dK missing one key tile", "dQ 3% high"])
def test_bf16_backward_check_fails_faulty_kernels(rng, fault):
    """chip_smoke.py's backward check at a main-path head shape (S=384, D=80):
    the plain backward on bf16 operands (the roundings a sound kernel makes)
    passes it for every gradient; a dK that misses one 64-key tile or a dQ
    3% high fails it."""
    from chip_smoke import bwd_ok, kernel_error

    b, s, h, d = 2, 384, 8, 80
    args = [torch.from_numpy(_normal(rng, b, s, h * d)).to(torch.bfloat16) for _ in range(4)]
    want = flash_attention_bwd_plain(*(x.float() for x in args), d ** -0.5, h)
    dq, dk, dv = flash_attention_bwd_plain(*args, d ** -0.5, h)
    if fault == "dK missing one key tile":
        dk = dk.clone()
        dk[:, 64:128] = 0
    elif fault == "dQ 3% high":
        dq = dq.float() * 1.03
    ok = [bwd_ok(*kernel_error(x, y)) for x, y in zip((dq, dk, dv), want)]
    assert all(ok) == (fault is None), ok
