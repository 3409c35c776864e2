"""Packed temporal self-attention: the wrappers of CUDA kernels K2 (forward)
and K8 (backward), their plain versions, and the autograd Function that
joins them.

The forward replaces synfmc_tpu/ops/temporal_attention.py:_fwd_kernel.  The
kernel (csrc/temporal_fwd.cu) is bound by bytes: rows are independent, so
each block copies one (row, head group) slab with cp.async and runs both
products on mma.sync tensor cores (bf16; the fp32 instance stays on the
CUDA cores).

The backward replaces _bwd_kernel with csrc/temporal_bwd.cu: the same row
independence, so each block copies one (row, head group) unit of q, k, v and
dO with cp.async, recomputes its F x F softmax, and runs the five products
on mma.sync tensor cores (bf16; the fp32 instance stays on the CUDA cores),
with no cross-block sum.

Both are ``torch.library`` ops (``synfmc::temporal_attention_fwd``,
``synfmc::temporal_attention_bwd``; ops/_library.py).  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from synfmc_tpu_torch.ops import _cuda, _library
from synfmc_tpu_torch.ops.flash_attention import _check_cuda, _stream

MAX_FRAMES = 64
# Opt-in shared memory per block of the H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin),
# a constant so that the CPU and the card route the same shapes the same way.
SMEM_OPTIN = 232448


def _seg_stride(seg: int) -> int:
    """csrc/mma.cuh:seg_stride: an odd number of 16-byte chunks a bf16 row."""
    return seg + (0 if (seg // 8) % 2 else 8)


def _row_stride_f32(d: int) -> int:
    """csrc/common.cuh:row_stride<float>: an odd number of words a row."""
    return d if d % 2 else d + 1


def unit_bytes(f: int, d: int, dtype) -> tuple[int, int]:
    """Shared memory (bytes) of one head's unit in K2 and in K8 at F frames
    and head dim D, as the launchers size it (csrc/temporal_fwd.cu:
    launch_bf16, launch_f32; csrc/temporal_bwd.cu: launch_bf16, launch_f).
    A larger head group never needs more than one head: the launchers fall
    back to one head a unit."""
    if dtype == torch.bfloat16:
        kt = -(-f // 16)
        seg = _seg_stride(d)
        return 3 * f * seg * 2, (4 * f * seg + 2 * 16 * kt * (16 * kt + 8)) * 2
    ld = _row_stride_f32(d)
    return 3 * f * ld * 4, 4 * f * ld * 4 + 2 * f * (f + 1) * 4


def temporal_supported(q2, heads: int) -> bool:
    """ops/temporal_attention.py:temporal_supported, plus the kernels' own
    limits: F <= 64, head dim a multiple of 8, a kernel for the dtype (bf16,
    fp32), and one head's unit of both K2 and K8 within SMEM_OPTIN.  A pure
    function of (N, F, H, D, dtype)."""
    if q2.dim() != 3:
        return False
    n, f, c = q2.shape
    if c % heads or f > MAX_FRAMES or (c // heads) % 8:
        return False
    if q2.dtype not in (torch.bfloat16, torch.float32):
        return False
    if max(unit_bytes(f, c // heads, q2.dtype)) > SMEM_OPTIN:
        return False
    return f >= 2 and n >= 8 and n % 8 == 0


def _heads(x2, heads):
    n, f, c = x2.shape
    return x2.float().reshape(n, f, heads, c // heads)


def temporal_attention_plain(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """The packed-layout reference (_xla_ref): fp32 throughout."""
    q, k, v = _heads(q2, heads), _heads(k2, heads), _heads(v2, heads)
    p = torch.softmax(torch.einsum("nfhd,nghd->nhfg", q, k) * scale, dim=-1)
    return torch.einsum("nhfg,nghd->nfhd", p, v).reshape(q2.shape).to(q2.dtype)


def temporal_attention_bwd_plain(q2, k2, v2, do2, scale: float, heads: int):
    """_bwd_kernel's math -> (dq, dk, dv): the normalised fp32 P,
    delta = rowsum(dO * (P V)) with P cast to v's type for the recomputed
    fp32 output, dS = P * (dO V^T - delta) * scale, dS and P cast to the operand
    type before the products, dK and dV contracted over the queries."""
    cast = lambda x, t: x.to(t.dtype).float()
    q, k, v = _heads(q2, heads), _heads(k2, heads), _heads(v2, heads)
    do = _heads(do2, heads)
    p = torch.softmax(torch.einsum("nfhd,nghd->nhfg", q, k) * scale, dim=-1)
    dp = torch.einsum("nfhd,nghd->nhfg", do, v)
    o = torch.einsum("nhfg,nghd->nfhd", cast(p, v2), v)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]  # (n, h, f, 1)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("nhfg,nghd->nfhd", cast(ds, k2), k)
    dk = torch.einsum("nhfg,nfhd->nghd", cast(ds, q2), q)
    dv = torch.einsum("nhfg,nfhd->nghd", cast(p, do2), cast(do, do2))
    shape = q2.shape
    return (dq.reshape(shape).to(q2.dtype), dk.reshape(shape).to(k2.dtype),
            dv.reshape(shape).to(v2.dtype))


def _check_shapes(name, q2, others, heads, unit: int):
    """(N, F, D); on a non-CPU tensor, raises for a shape the kernel cannot
    run (``unit`` picks K2's or K8's entry of :func:`unit_bytes`)."""
    n, f, c = q2.shape
    if any(t.shape != q2.shape for t in others):
        raise ValueError(f"{name}: operands must share one (N, F, H*D) shape")
    if c % heads:
        raise ValueError(f"{name}: {c} channels not divisible by {heads} heads")
    d = c // heads
    if q2.device.type != "cpu" and (f > MAX_FRAMES or d % 8):
        raise ValueError(f"{name}: needs F <= {MAX_FRAMES} and D % 8 == 0, got F={f} D={d}")
    if q2.device.type != "cpu" and q2.dtype in (torch.bfloat16, torch.float32):
        need = unit_bytes(f, d, q2.dtype)[unit]
        if need > SMEM_OPTIN:
            raise ValueError(f"{name}: one head at F={f} D={d} {q2.dtype} needs {need} bytes "
                             f"of shared memory, above the {SMEM_OPTIN} a block can have")
    return n, f, d


def _fwd_cuda(q2, k2, v2, scale: float, heads: int):
    """K2's launch."""
    n, f, c = q2.shape
    _check_cuda("temporal_attention", (q2, k2, v2), q2.dtype)
    name = "synfmc_temporal_fwd_bf16" if q2.dtype == torch.bfloat16 else "synfmc_temporal_fwd_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("temporal_fwd", name, [P, P, P, P, I, I, I, I, F32, P])
    out = torch.empty_like(q2)
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(), n, f, heads,
             c // heads, float(scale), _stream(q2))
    _cuda.check(err, "temporal_attention")
    return out


def _fwd_fake(q2, k2, v2, scale: float, heads: int):
    return torch.empty_like(q2)


def _bwd_cuda(q2, k2, v2, do2, scale: float, heads: int):
    """K8's launch."""
    n, f, c = q2.shape
    _check_cuda("temporal_attention_bwd", (q2, k2, v2, do2), q2.dtype)
    name = "synfmc_temporal_bwd_bf16" if q2.dtype == torch.bfloat16 else "synfmc_temporal_bwd_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("temporal_bwd", name, [P] * 7 + [I, I, I, I, F32, P])
    dq, dk, dv = torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), do2.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), n, f, heads, c // heads, float(scale), _stream(q2))
    _cuda.check(err, "temporal_attention_bwd")
    return dq, dk, dv


def _bwd_fake(q2, k2, v2, do2, scale: float, heads: int):
    return torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)


_library.define("temporal_attention_fwd",
                "(Tensor q2, Tensor k2, Tensor v2, float scale, int heads) -> Tensor",
                temporal_attention_plain, _fwd_cuda, _fwd_fake)
_library.define("temporal_attention_bwd",
                "(Tensor q2, Tensor k2, Tensor v2, Tensor do2, float scale, int heads)"
                " -> (Tensor, Tensor, Tensor)", temporal_attention_bwd_plain, _bwd_cuda, _bwd_fake)


def temporal_attention_fwd(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """K2 (``synfmc::temporal_attention_fwd``): self-attention over F
    positions of each of N rows, (N, F, H*D)."""
    _check_shapes("temporal_attention", q2, (k2, v2), heads, 0)
    out = _library.call("temporal_attention_fwd", q2, k2, v2, float(scale), int(heads))
    if _library.counts(q2):
        temporal_attention.launches += 1
    return out


def temporal_attention_bwd(q2, k2, v2, do2, scale: float, heads: int):
    """K8 (``synfmc::temporal_attention_bwd``): (dq, dk, dv) of the packed
    temporal attention."""
    _check_shapes("temporal_attention_bwd", q2, (k2, v2, do2), heads, 1)
    grads = _library.call("temporal_attention_bwd", q2, k2, v2, do2, float(scale), int(heads))
    if _library.counts(q2):
        temporal_attention_bwd.launches += 1
    return grads


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q2, k2, v2, scale, heads):
        ctx.save_for_backward(q2, k2, v2)
        ctx.scale, ctx.heads = scale, heads
        return temporal_attention_fwd(q2, k2, v2, scale, heads)

    @staticmethod
    def backward(ctx, dout):
        q2, k2, v2 = ctx.saved_tensors
        dq, dk, dv = temporal_attention_bwd(q2, k2, v2, dout.contiguous().to(q2.dtype),
                                            ctx.scale, ctx.heads)
        return dq, dk, dv, None, None


def temporal_attention(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """Self-attention over F positions of each of N rows, (N, F, H*D),
    differentiable when an operand requires grad."""
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad or v2.requires_grad):
        return _TemporalAttention.apply(q2, k2, v2, scale, heads)
    return temporal_attention_fwd(q2, k2, v2, scale, heads)


temporal_attention.launches = 0
temporal_attention_bwd.launches = 0
