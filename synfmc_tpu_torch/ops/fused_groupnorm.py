"""Fused GroupNorm(+activation): the wrapper of CUDA kernel K3, its plain
version, and the autograd Function around it.

Replaces synfmc_tpu/ops/pallas_groupnorm.py:_gn_kernel.  The kernel
(csrc/group_norm.cu) is bound by bytes; it splits each sample's reduction
over many blocks (partial fp32 sums, a finalize step, one normalise pass)
so that a VAE slab of 12.6 M elements in 32 groups still fills the card.

The backward is PyTorch ops on both devices (:func:`group_norm_bwd`), as the
JAX package's _fused_gn_bwd differentiates its XLA path: there is no
backward kernel to port.

On a CPU tensor the forward runs :func:`group_norm_plain`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from synfmc_tpu_torch.ops import _cuda

_ACTS = {None: 0, "silu": 1, "relu": 2}
_MAX_C = 6144  # 2*C fp32 per-channel sums in 48 KB of shared memory
_TARGET_BLOCKS = 2 * 132  # two stats blocks per SM of an H100


def group_norm_plain(x, scale, bias, num_groups: int, eps: float = 1e-5,
                     act: Optional[str] = None) -> torch.Tensor:
    """ops/norms.py:group_norm math: one-pass fp32 stats E[x^2]-E[x]^2,
    affine folded into one scale/shift, optional silu/relu."""
    if act not in _ACTS:
        raise ValueError(f"unknown fused activation {act!r}")
    n, c = x.shape[0], x.shape[-1]
    xg = x.reshape(n, -1, num_groups, c // num_groups).float()
    m1 = xg.mean(dim=(1, 3))
    m2 = (xg * xg).mean(dim=(1, 3))
    rstd = torch.rsqrt(m2 - m1 * m1 + eps)  # (n, g)
    gamma = scale.float().reshape(num_groups, -1)[None] * rstd[..., None]  # (n, g, cg)
    beta = bias.float().reshape(num_groups, -1)[None] - m1[..., None] * gamma
    out = xg * gamma[:, None] + beta[:, None]
    if act == "silu":
        out = out * torch.sigmoid(out)
    elif act == "relu":
        out = torch.relu(out)
    return out.reshape(x.shape).to(x.dtype)


def group_norm_supported(s: int, c: int) -> bool:
    """Slabs K3 takes: S rows of C channels a sample, C <= _MAX_C and S*C < 2**31."""
    return c <= _MAX_C and s * c < 2 ** 31


def _chunks(n: int, s: int) -> int:
    return max(1, min(s, -(-_TARGET_BLOCKS // n)))


def group_norm_bwd(x, scale, bias, dout, num_groups: int, eps: float = 1e-5,
                   act: Optional[str] = None, affine: bool = True):
    """The VJP of :func:`group_norm_plain` in fp32 -> (dx, dscale, dbias);
    dscale and dbias are None unless ``affine``."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.reshape(n, -1, num_groups, cg).float()
    m1 = xg.mean(dim=(1, 3), keepdim=True)
    m2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(m2 - m1 * m1 + eps)  # (n, 1, g, 1)
    xhat = (xg - m1) * rstd
    gamma = scale.float().reshape(num_groups, cg)
    dz = dout.reshape(xg.shape).float()
    if act is not None:
        z = xhat * gamma + bias.float().reshape(num_groups, cg)
        if act == "silu":
            sig = torch.sigmoid(z)
            dz = dz * sig * (1 + z * (1 - sig))
        else:
            dz = dz * (z > 0)
    dxhat = dz * gamma
    dx = rstd * (dxhat - dxhat.mean(dim=(1, 3), keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=(1, 3), keepdim=True))
    dx = dx.reshape(x.shape).to(x.dtype)
    if not affine:
        return dx, None, None
    dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c).to(scale.dtype)
    return dx, dscale, dz.sum(dim=(0, 1)).reshape(c).to(bias.dtype)


def fused_group_norm_fwd(x, scale, bias, num_groups: int, eps: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """K3: x (N, ..., C) channel-last, contiguous -> same shape; per-sample
    group statistics (torch.nn.GroupNorm semantics)."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if act not in _ACTS:
        raise ValueError(f"unknown fused activation {act!r}")
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_group_norm: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm: x must be contiguous (channel-last)")
    s = x.numel() // (n * c)
    if not group_norm_supported(s, c) or x.data_ptr() % 16:
        raise ValueError(f"fused_group_norm: unsupported slab (S={s}, C={c}) or alignment")
    name = "synfmc_group_norm_bf16" if x.dtype == torch.bfloat16 else "synfmc_group_norm_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("group_norm", name, [P, P, P, P, P, I, I, I, I, F32, I, I, P])
    chunks = _chunks(n, s)
    chunks = -(-s // -(-s // chunks))  # the kernel's own rounding of rows per chunk
    out = torch.empty_like(x)
    work = torch.empty(n * chunks * num_groups * 2 + n * c * 2, device=x.device,
                       dtype=torch.float32)
    sc = scale.to(device=x.device, dtype=x.dtype).contiguous()
    bi = bias.to(device=x.device, dtype=x.dtype).contiguous()
    err = fn(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), work.data_ptr(),
             n, s, c, num_groups, float(eps), _ACTS[act], chunks,
             torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "group_norm")
    fused_group_norm.launches += 1
    return out


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, act)
        return fused_group_norm_fwd(x, scale, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dout):
        x, scale, bias = ctx.saved_tensors
        affine = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dscale, dbias = group_norm_bwd(x, scale, bias, dout, *ctx.cfg, affine=affine)
        return dx, dscale, dbias, None, None, None


def fused_group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5,
                     act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+act) over the trailing channel axis of a contiguous
    (N, ..., C) tensor, differentiable when an operand requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, scale, bias, num_groups, eps, act)
    return fused_group_norm_fwd(x, scale, bias, num_groups, eps, act)


fused_group_norm.launches = 0
