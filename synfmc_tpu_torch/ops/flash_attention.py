"""Flash attention on the packed layout: the wrappers of CUDA kernels K1
(forward) and K5-K7 (backward), their plain versions, and the autograd
Function that joins them.

The forward replaces synfmc_tpu/ops/flash_attention.py:_fwd_packed_kernel
(and, since its tiles mask any sequence length, the padded _fwd_kernel).  The
kernel (csrc/flash_fwd.cu) streams K/V tiles through shared memory with an
online softmax, because one head's K/V at S=1536 no longer fits a block's
shared memory as it fit the TPU's VMEM.  In bf16 it has two instances, chosen
by the head dim (:func:`fwd_instance`): D <= 128 on wgmma, one persistent
block an SM fed by a producer warpgroup's ring of asynchronous K/V copies;
128 < D <= 256 on mma.sync.  When a gradient is wanted it also writes each
row's fp32 log-sum-exp, so the backward recomputes P without a second
softmax.

The backward replaces _bwd_packed_single_kernel, _bwd_packed_kernel and the
padded _bwd_kernel with one kernel set (csrc/flash_bwd.cu): a prologue pass
for delta = rowsum(dO*O) that, in bf16, also writes q' = bf16(q*scale) once
into a (B, S, H*D) scratch buffer (the wrapper allocates it beside the fp32
(B, H, S) delta), then one block per key tile for dK/dV and one per query
tile for dQ, each streaming the other side's tiles through a ring of
asynchronous copies.  Every output is written by one block in a fixed order,
so there is no whole-sequence limit, no atomics, and the gradients are the
same bits on every run.

Both are ``torch.library`` ops (``synfmc::flash_attention_fwd``,
``synfmc::flash_attention_bwd``; ops/_library.py).  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from synfmc_tpu_torch.ops import _cuda, _library

MAX_HEAD_DIM = 256
WGMMA_MAX_HEAD_DIM = 128
_PV_N = (40, 48, 64, 80, 96, 112, 128)  # csrc/wgmma.cuh's instances of N


def fwd_instance(d: int, dtype=torch.bfloat16) -> tuple:
    """The forward kernel instance csrc/flash_fwd.cu:synfmc_flash_fwd_bf16 (or
    _f32) runs for head dim ``d``: ("wgmma", QK^T depth, PV's N) for bf16
    D <= 128, ("mma_sync", padded D) for bf16 128 < D <= 256, ("f32",) for
    float32."""
    if dtype == torch.float32:
        return ("f32",)
    if d <= WGMMA_MAX_HEAD_DIM:
        return ("wgmma", -(-d // 16) * 16, next(n for n in _PV_N if n >= d))
    return ("mma_sync", -(-d // 16) * 16)


def flash_supported(q) -> bool:
    """Shapes the kernels take: (B, S, H, D) with D % 8 == 0 and D <= 256.

    The TPU gate's VMEM terms (resident K/V bytes, the 16384-token cap) do
    not apply: K/V are streamed."""
    if q.dim() != 4:
        return False
    d = q.shape[-1]
    return d <= MAX_HEAD_DIM and d % 8 == 0


def _heads(x2, heads):
    b, s, c = x2.shape
    return x2.float().reshape(b, s, heads, c // heads).transpose(1, 2)


def _merge(xh, dtype):
    b, h, s, d = xh.shape
    return xh.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _plain(q2, k2, v2, scale: float, heads: int):
    """(out, lse): :func:`flash_attention_plain` and the fp32 (B, H, S)
    log-sum-exp of the scaled logits."""
    qh = _heads((q2.float() * scale).to(q2.dtype), heads)
    logits = qh @ _heads(k2, heads).transpose(-1, -2)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True)
    o = (p.to(v2.dtype).float() @ _heads(v2, heads)) / den
    return _merge(o, q2.dtype), (m + torch.log(den))[..., 0]


def flash_attention_plain(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """_fwd_packed_kernel's math on (B, S, H*D): q scaled in its own type,
    fp32 logits and softmax, P cast to v's type for PV (fp32 accumulation),
    the denominator dividing the output."""
    return _plain(q2, k2, v2, scale, heads)[0]


def flash_attention_bwd_plain(q2, k2, v2, do2, scale: float, heads: int):
    """_bwd_packed_single_kernel's math on (B, S, H*D) -> (dq, dk, dv):
    q' = q*scale, unnormalised fp32 P, dO_n = dO/den,
    dS = P * (dO_n V^T - rowsum(dO_n * O)), with P, dO_n and dS cast to the
    operand type before their matmuls and dQ scaled on the way out."""
    dt = v2.dtype
    cast = lambda x: x.to(dt).float()
    q = _heads((q2.float() * scale).to(q2.dtype), heads)  # q'
    k, v = _heads(k2, heads), _heads(v2, heads)
    logits = q @ k.transpose(-1, -2)
    pu = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = pu.sum(dim=-1, keepdim=True)
    puc = cast(pu)
    don = _heads(do2, heads) / den
    donc = cast(don)
    dp = donc @ v.transpose(-1, -2)
    delta = (don * (puc @ v)).sum(dim=-1, keepdim=True) / den
    dsc = cast(pu * (dp - delta))
    dq = (dsc @ k) * scale
    dk = dsc.transpose(-1, -2) @ q
    dv = puc.transpose(-1, -2) @ donc
    return _merge(dq, q2.dtype), _merge(dk, k2.dtype), _merge(dv, v2.dtype)


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


def _check_shapes(name, q2, others, heads):
    b, s, c = q2.shape
    if any(t.shape != q2.shape for t in others):
        raise ValueError(f"{name}: operands must share one (B, S, H*D) shape")
    if c % heads:
        raise ValueError(f"{name}: {c} channels not divisible by {heads} heads")
    d = c // heads
    if q2.device.type != "cpu" and (d % 8 or d > MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 <= {MAX_HEAD_DIM}")
    return b, s, d


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_cuda(q2, k2, v2, scale: float, heads: int, with_lse: bool):
    """K1's launch: (out, lse), lse empty unless ``with_lse``."""
    b, s, c = q2.shape
    d = c // heads
    _check_cuda("flash_attention", (q2, k2, v2), q2.dtype)
    name = "synfmc_flash_fwd_bf16" if q2.dtype == torch.bfloat16 else "synfmc_flash_fwd_f32"
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    fn = _cuda.entry("flash_fwd", name, [P, P, P, P, P, I, I, I, I, F32, P])
    out = torch.empty_like(q2)
    lse = torch.empty((b, heads, s) if with_lse else (0,), device=q2.device,
                      dtype=torch.float32)
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, b, s, heads, d, float(scale), _stream(q2))
    if err and q2.dtype == torch.bfloat16:
        need = _cuda.entry("flash_fwd", "synfmc_flash_fwd_bf16_smem", [I])(d)
        _cuda.check(err, f"flash_attention (head dim {d}: {need} bytes of shared memory a block)")
    _cuda.check(err, "flash_attention")
    return out, lse


def _fwd_cpu(q2, k2, v2, scale: float, heads: int, with_lse: bool):
    if with_lse:
        out, lse = _plain(q2, k2, v2, scale, heads)
        return out, lse.contiguous()
    return flash_attention_plain(q2, k2, v2, scale, heads), q2.new_empty((0,), dtype=torch.float32)


def _fwd_fake(q2, k2, v2, scale: float, heads: int, with_lse: bool):
    b, s, _ = q2.shape
    return (torch.empty_like(q2),
            q2.new_empty((b, heads, s) if with_lse else (0,), dtype=torch.float32))


def _bwd_cuda(q2, k2, v2, out, lse, do2, scale: float, heads: int):
    """K5-K7's launches: (dq, dk, dv) from K1's output and log-sum-exp."""
    b, s, c = q2.shape
    d = c // heads
    _check_cuda("flash_attention_bwd", (q2, k2, v2, out, do2), q2.dtype)
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (b, heads, s):
        raise ValueError("flash_attention_bwd: needs K1's fp32 (B, H, S) log-sum-exp")
    lse = lse.contiguous()
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    dq, dk, dv = torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)
    delta = torch.empty_like(lse)
    if q2.dtype == torch.bfloat16:  # the prologue writes q' = bf16(q * scale) to a scratch
        fn = _cuda.entry("flash_bwd", "synfmc_flash_bwd_bf16", [P] * 11 + [I, I, I, I, F32, P])
        scratch = (torch.empty_like(q2).data_ptr(),)
    else:
        fn = _cuda.entry("flash_bwd", "synfmc_flash_bwd_f32", [P] * 10 + [I, I, I, I, F32, P])
        scratch = ()
    err = fn(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
             lse.data_ptr(), do2.data_ptr(), delta.data_ptr(), *scratch, dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, s, heads, d, float(scale), _stream(q2))
    _cuda.check(err, "flash_attention_bwd")
    return dq, dk, dv


def _bwd_cpu(q2, k2, v2, out, lse, do2, scale: float, heads: int):
    return flash_attention_bwd_plain(q2, k2, v2, do2, scale, heads)


def _bwd_fake(q2, k2, v2, out, lse, do2, scale: float, heads: int):
    return torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)


_library.define("flash_attention_fwd",
                "(Tensor q2, Tensor k2, Tensor v2, float scale, int heads, bool with_lse)"
                " -> (Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)
_library.define("flash_attention_bwd",
                "(Tensor q2, Tensor k2, Tensor v2, Tensor out, Tensor? lse, Tensor do2,"
                " float scale, int heads) -> (Tensor, Tensor, Tensor)",
                _bwd_cpu, _bwd_cuda, _bwd_fake)


def flash_attention_fwd(q2, k2, v2, scale: float, heads: int, with_lse: bool = False):
    """K1 (``synfmc::flash_attention_fwd``): (out, lse) with lse the fp32
    (B, H, S) log-sum-exp of the scaled logits when ``with_lse``, else None."""
    _check_shapes("flash_attention", q2, (k2, v2), heads)
    out, lse = _library.call("flash_attention_fwd", q2, k2, v2, float(scale), int(heads),
                             bool(with_lse))
    if _library.counts(q2):
        flash_attention.launches += 1
    return out, (lse if with_lse else None)


def flash_attention_bwd(q2, k2, v2, out, lse, do2, scale: float, heads: int):
    """K5/K6/K7 (``synfmc::flash_attention_bwd``): (dq, dk, dv) of the packed
    attention, from K1's output and log-sum-exp on a CUDA tensor, from the
    plain recompute on a CPU one."""
    _check_shapes("flash_attention_bwd", q2, (k2, v2, do2), heads)
    grads = _library.call("flash_attention_bwd", q2, k2, v2, out, lse, do2, float(scale),
                          int(heads))
    if _library.counts(q2):
        flash_attention_bwd.launches += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q2, k2, v2, scale, heads):
        out, lse = flash_attention_fwd(q2, k2, v2, scale, heads, with_lse=True)
        ctx.save_for_backward(q2, k2, v2, out, lse)
        ctx.scale, ctx.heads = scale, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q2, k2, v2, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q2, k2, v2, out, lse, dout.contiguous(),
                                         ctx.scale, ctx.heads)
        return dq, dk, dv, None, None


def flash_attention(q2, k2, v2, scale: float, heads: int) -> torch.Tensor:
    """Self-attention on packed (B, S, H*D) tensors -> (B, S, H*D),
    differentiable when an operand requires grad."""
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad or v2.requires_grad):
        return _FlashAttention.apply(q2, k2, v2, scale, heads)
    return flash_attention_fwd(q2, k2, v2, scale, heads)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
