"""Packed temporal self-attention: the wrapper of CUDA kernel K2 and its plain version.

Replaces synfmc_tpu/ops/temporal_attention.py:_fwd_kernel.  The kernel
(csrc/temporal_fwd.cu) is bound by bytes: rows are independent, a block loads
its rows' head slices once into shared memory and keeps each query's F
logits in registers.

On a CPU tensor the wrapper runs :func:`temporal_attention_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from synfmc_tpu_torch.ops import _cuda
from synfmc_tpu_torch.ops.flash_attention import _check_cuda

MAX_FRAMES = 64


def temporal_supported(q2, heads: int) -> bool:
    """ops/temporal_attention.py:temporal_supported, plus the kernel's own
    limits (F <= 64, head dim a multiple of 8)."""
    if q2.dim() != 3:
        return False
    n, f, c = q2.shape
    if c % heads or f > MAX_FRAMES or (c // heads) % 8:
        return False
    return f >= 2 and n >= 8 and n % 8 == 0


def temporal_attention_plain(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """The packed-layout reference (_xla_ref): fp32 throughout."""
    n, f, c = q2.shape
    d = c // heads
    q = q2.float().reshape(n, f, heads, d)
    k = k2.float().reshape(n, f, heads, d)
    v = v2.float().reshape(n, f, heads, d)
    logits = torch.einsum("nfhd,nghd->nhfg", q, k) * scale
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhfg,nghd->nfhd", p, v)
    return out.reshape(n, f, c).to(q2.dtype)


def temporal_attention(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """Self-attention over F positions of each of N rows, (N, F, H*D)."""
    n, f, c = q2.shape
    if k2.shape != q2.shape or v2.shape != q2.shape:
        raise ValueError("temporal_attention: q, k, v must share one (N, F, H*D) shape")
    if c % heads:
        raise ValueError(f"temporal_attention: {c} channels not divisible by {heads} heads")
    d = c // heads
    if q2.device.type == "cpu":
        return temporal_attention_plain(q2, k2, v2, scale, heads)
    if f > MAX_FRAMES or d % 8:
        raise ValueError(f"temporal_attention: needs F <= {MAX_FRAMES} and D % 8 == 0, got F={f} D={d}")
    _check_cuda("temporal_attention", (q2, k2, v2), q2.dtype)
    name = "synfmc_temporal_fwd_bf16" if q2.dtype == torch.bfloat16 else "synfmc_temporal_fwd_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("temporal_fwd", name, [P, P, P, P, I, I, I, I, F32, P])
    out = torch.empty_like(q2)
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(), n, f, heads, d,
             float(scale), torch.cuda.current_stream(q2.device).cuda_stream)
    _cuda.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0
