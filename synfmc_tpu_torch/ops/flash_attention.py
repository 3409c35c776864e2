"""Flash attention forward on the packed layout: the wrapper of CUDA kernel K1
and its plain version.

Replaces synfmc_tpu/ops/flash_attention.py:_fwd_packed_kernel.  The kernel
(csrc/flash_fwd.cu) is bound by operations at the UNet's shapes; it streams
K/V tiles through shared memory with an online softmax, because one head's
K/V at S=1536 no longer fits a block's shared memory as it fit the TPU's VMEM.

On a CPU tensor the wrapper runs :func:`flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from synfmc_tpu_torch.ops import _cuda

MAX_HEAD_DIM = 256


def flash_supported(q) -> bool:
    """Shapes the kernel takes: (B, S, H, D) with D % 8 == 0 and D <= 256.

    The TPU gate's VMEM terms (resident K/V bytes, the 16384-token cap) do
    not apply: K/V are streamed."""
    if q.dim() != 4:
        return False
    d = q.shape[-1]
    return d <= MAX_HEAD_DIM and d % 8 == 0


def flash_attention_plain(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """_fwd_packed_kernel's math on (B, S, H*D): q scaled in its own type,
    fp32 logits and softmax, P cast to v's type for PV (fp32 accumulation),
    the denominator dividing the output."""
    b, sq, c = q2.shape
    sk = k2.shape[1]
    d = c // heads
    qh = (q2.float() * scale).to(q2.dtype).float().reshape(b, sq, heads, d).transpose(1, 2)
    kh = k2.float().reshape(b, sk, heads, d).transpose(1, 2)
    vh = v2.float().reshape(b, sk, heads, d).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    o = (p.to(v2.dtype).float() @ vh) / den
    return o.transpose(1, 2).reshape(b, sq, c).to(q2.dtype)


def _check_cuda(name, tensors, dtype):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {dtype} not supported")


def flash_attention(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """Self-attention on packed (B, S, H*D) tensors -> (B, S, H*D)."""
    b, s, c = q2.shape
    if k2.shape != q2.shape or v2.shape != q2.shape:
        raise ValueError("flash_attention: q, k, v must share one (B, S, H*D) shape")
    if c % heads:
        raise ValueError(f"flash_attention: {c} channels not divisible by {heads} heads")
    d = c // heads
    if q2.device.type == "cpu":
        return flash_attention_plain(q2, k2, v2, scale, heads)
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 <= {MAX_HEAD_DIM}")
    _check_cuda("flash_attention", (q2, k2, v2), q2.dtype)
    name = "synfmc_flash_fwd_bf16" if q2.dtype == torch.bfloat16 else "synfmc_flash_fwd_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("flash_fwd", name, [P, P, P, P, I, I, I, I, F32, P])
    out = torch.empty_like(q2)
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(), b, s, heads, d,
             float(scale), torch.cuda.current_stream(q2.device).cuda_stream)
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
