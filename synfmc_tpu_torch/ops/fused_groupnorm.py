"""Fused GroupNorm(+activation): the wrapper of CUDA kernel K3, its plan,
its plain version, and the autograd Function around it.

Replaces synfmc_tpu/ops/pallas_groupnorm.py:_gn_kernel.  The kernel
(csrc/group_norm.cu) is bound by bytes.  :func:`_plan` cuts each sample
into items of whole groups: in mode A an item's rows fit the shared memory
of a thread-block cluster, so one launch reads x once and writes once; in
mode B (a slab whose narrowest item fits no cluster) a stats pass and an
apply pass read x twice in two launches.

The backward is PyTorch ops on both devices (:func:`group_norm_bwd`), as the
JAX package's _fused_gn_bwd differentiates its XLA path: there is no
backward kernel to port.

The forward is a ``torch.library`` op (``synfmc::fused_group_norm_fwd``;
ops/_library.py).  On a CPU tensor it runs :func:`group_norm_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from synfmc_tpu_torch.ops import _cuda, _library

_ACTS = {None: 0, "silu": 1, "relu": 2}
_MAX_C = 6144  # group_norm_supported's channel limit: a mode-B stats block stays in the opt-in

# The H100's shared memory and SMs, and the kernel's constants (csrc/group_norm.cu).
SMEM_OPTIN = 232_448      # opt-in dynamic shared memory a block
_SM_SHARED = 233_472      # shared memory an SM holds; each block also takes 1 KB
_SMS = 132
_THREADS = 256            # kThreads
_CLUSTER_MAX = 8          # kMaxCluster: the portable cluster size
_MIN_RUN_BYTES = 64       # an item's row is two 32-byte DRAM sectors or more
# The most shared memory a mode-A block may take, half an SM's, so that at
# least two blocks overlap one's write with another's load; an item that
# needs more takes mode B.  It only caps an item's tile: the plan aims for
# tiles of _TILE_TARGET, at which registers hold five gn_cluster blocks an
# SM (kResidentA).
_SMEM_A_MAX = _SM_SHARED // 2 - 1024
_TILE_TARGET = 32 * 1024
_TARGET_BLOCKS = 256  # mode A widens its runs while its grid keeps this many blocks
_TARGET_BLOCKS_B = 8 * _SMS  # mode B's chunks, in all samples


class GnPlan(NamedTuple):
    """How K3 cuts an (N, S, C) slab of G groups.

    mode "A": ``blocks`` = N * (G / run) * cluster; an item is (sample, a run
    of ``run`` groups), and its ``cluster`` blocks each hold ``rows`` of its
    rows.  mode "B": ``blocks`` = N * chunks chunks of ``rows`` rows in each
    pass; clusters of ``cluster`` chunks sum their stats partials.
    ``vec``: bytes a copy;
    ``smem``: dynamic shared bytes of a (stats) block.
    """

    mode: str
    run: int
    cluster: int
    rows: int
    vec: int
    smem: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _groups_spanned(elems: int, cg: int) -> int:
    """Most groups of ``cg`` channels that one vector of ``elems`` channels
    touches (the kernel's groups_spanned)."""
    return max((v * elems + elems - 1) // cg - v * elems // cg + 1 for v in range(cg))


def _vec_bytes(row_bytes: int, esize: int, cg: int) -> int:
    """The widest copy that divides a row and touches at most two groups."""
    return next(v for v in (16, 8, 4, esize)
                if row_bytes % v == 0 and _groups_spanned(v // esize, cg) <= 2)


def _lanes(vpr: int, rows: int) -> int:
    """Row lanes of a block whose rows hold ``vpr`` vectors (the kernel's lanes_of)."""
    return max(1, min(_THREADS // min(vpr, _THREADS), rows))


def _smem_a(rows: int, width: int, run: int, esize: int, vec: int) -> int:
    vpr = width * esize // vec
    return _cdiv(rows * width * esize, 16) * 16 + 16 * _lanes(vpr, rows) * vpr + 16 * run


def _smem_b(rows: int, c: int, groups: int, esize: int, vec: int) -> int:
    vpr = c * esize // vec
    return 16 * _lanes(vpr, rows) * vpr + 4 * 2 * groups


def _plan_a(n: int, s: int, c: int, groups: int, esize: int) -> Optional[GnPlan]:
    """Mode A's plan, or None when no item of whole groups fits a cluster of
    at most 8 blocks within _SMEM_A_MAX a block.  Runs are whole groups of
    at least 64 bytes a row (or whole rows), with 16-byte copies where any
    run allows them.  From the narrowest run of 128 bytes or more, each run takes the
    smallest cluster whose tile is at most 32 KB; the run widens while the
    cluster does not grow and 256 blocks or more remain, and narrows where
    no cluster gives such a tile.  Where none does, the smallest tile that
    fits wins.  (Chosen on an H100 from timed candidates at the UNet's and
    the VAE's keys.)"""
    cg = c // groups
    runs = [r for r in range(1, groups + 1)
            if groups % r == 0 and (r == groups or r * cg * esize >= _MIN_RUN_BYTES)]
    vecs = {r: _vec_bytes(r * cg * esize, esize, cg) for r in runs}
    if any(v == 16 for v in vecs.values()):
        runs = [r for r in runs if vecs[r] == 16]

    def fits(run, k):
        rows = _cdiv(s, k)
        if _cdiv(s, rows) != k:  # a rank without rows
            return None
        smem = _smem_a(rows, run * cg, run, esize, vecs[run])
        if smem > _SMEM_A_MAX:
            return None
        return GnPlan("A", run, k, rows, vecs[run], smem, n * (groups // run) * k)

    def small_tile(run):  # the smallest cluster with a tile of at most 32 KB
        return next((p for k in range(1, _CLUSTER_MAX + 1) if (p := fits(run, k))
                     and p.rows * run * cg * esize <= _TILE_TARGET), None)

    i = next((i for i, r in enumerate(runs) if r * cg * esize >= 128), len(runs) - 1)
    while i > 0 and small_tile(runs[i]) is None:
        i -= 1
    best = small_tile(runs[i])
    if best is None:
        every = [p for r in runs for k in range(1, _CLUSTER_MAX + 1) if (p := fits(r, k))]
        return min(every, key=lambda p: (p.rows * p.run, p.cluster), default=None)
    for r in runs[i + 1:]:
        wider = small_tile(r)
        if wider is None or wider.cluster > best.cluster or wider.blocks < _TARGET_BLOCKS:
            break
        best = wider
    return best


def _plan_b(n: int, s: int, c: int, groups: int, esize: int) -> GnPlan:
    """Mode B's plan: about 8 chunks an SM over all samples, at most 2 an SM
    in one sample.  Where a sample has more than 64 chunks, clusters of 8
    sum them, so that each apply block reads at most a few dozen partials a
    group.  (Chosen on an H100 from timed candidates at the VAE's keys.)"""
    vec = _vec_bytes(c * esize, esize, c // groups)
    rows = _cdiv(s, max(1, min(s, _cdiv(_TARGET_BLOCKS_B, n), 2 * _SMS)))
    chunks = _cdiv(s, rows)
    return GnPlan("B", groups, _CLUSTER_MAX if chunks > 64 else 1, rows, vec,
                  _smem_b(rows, c, groups, esize, vec), n * chunks)


@functools.lru_cache(maxsize=1024)  # tens of microseconds of host time a call otherwise
def _plan(n: int, s: int, c: int, groups: int, esize: int) -> GnPlan:
    """K3's plan for an (n, s, c) slab of ``groups`` groups in elements of
    ``esize`` bytes: mode A where an item fits a cluster, else mode B."""
    return _plan_a(n, s, c, groups, esize) or _plan_b(n, s, c, groups, esize)


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


def _entry(dtype: torch.dtype):
    """K3's C entry for ``dtype``: (x, scale, bias, out, work, N, S, C, G,
    eps, act, mode, run, cluster, rows, vec, smem, stream) -> cudaError_t; it
    refuses a plan it cannot run (csrc/group_norm.cu)."""
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    name = "synfmc_group_norm_bf16" if dtype == torch.bfloat16 else "synfmc_group_norm_f32"
    return _cuda.entry("group_norm", name, [P, P, P, P, P, I, I, I, I, F32, I, I, I, I, I, I, I, P])


def _fwd_cuda(x, scale, bias, num_groups: int, eps: float, act: Optional[str]):
    """K3's launch: its plan, then one or two kernels.  An x off 16 bytes is
    copied first."""
    n, c = x.shape[0], x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_group_norm: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm: x must be contiguous (channel-last)")
    s = x.numel() // (n * c)
    if not group_norm_supported(s, c):
        raise ValueError(f"fused_group_norm: unsupported slab (S={s}, C={c})")
    fn = _entry(x.dtype)
    if x.data_ptr() % 16:
        x = x.clone()
    p = _plan(n, s, c, num_groups, x.element_size())
    parts = 0 if p.mode == "A" else n * _cdiv(_cdiv(s, p.rows), p.cluster) * num_groups * 2
    out = torch.empty_like(x)
    work = torch.empty(parts, device=x.device, dtype=torch.float32)
    # read as vectors of the plan's width
    sc, bi = (t.to(device=x.device, dtype=x.dtype).contiguous() for t in (scale, bias))
    sc, bi = (t.clone() if t.data_ptr() % 16 else t for t in (sc, bi))
    err = fn(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), work.data_ptr(),
             n, s, c, num_groups, float(eps), _ACTS[act], "AB".index(p.mode), p.run, p.cluster,
             p.rows, p.vec, p.smem, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "group_norm")
    return out


def _fwd_cpu(x, scale, bias, num_groups: int, eps: float, act: Optional[str]):
    return group_norm_plain(x, scale, bias, num_groups, eps, act).contiguous()


def _fwd_fake(x, scale, bias, num_groups: int, eps: float, act: Optional[str]):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_library.define("fused_group_norm_fwd",
                "(Tensor x, Tensor scale, Tensor bias, int num_groups, float eps, str? act)"
                " -> Tensor", _fwd_cpu, _fwd_cuda, _fwd_fake)


def fused_group_norm_fwd(x, scale, bias, num_groups: int, eps: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """K3 (``synfmc::fused_group_norm_fwd``): x (N, ..., C) channel-last,
    contiguous -> same shape; per-sample group statistics (torch.nn.GroupNorm
    semantics)."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if act not in _ACTS:
        raise ValueError(f"unknown fused activation {act!r}")
    out = _library.call("fused_group_norm_fwd", x, scale, bias, int(num_groups), float(eps),
                        act)
    if _library.counts(x):
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
