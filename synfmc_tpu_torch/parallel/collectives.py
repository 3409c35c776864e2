"""The mesh's explicit collectives.

The port has no partitioner: where the JAX package's GSPMD inserts a
collective because a computation needs a whole mesh axis (ops/spmd.py runs
each kernel per shard on local data), the port calls one of these, and the
kernels stay as they are:

- ``frames_to_rows`` / ``rows_to_frames``: the motion module's exchange over
  the ``sp`` group, an ``all_to_all_single`` that turns a rank's frames
  ``(b, f/S, h, w, c)`` into its rows of whole-clip token groups
  ``(rows_r, f, c)`` and back; autograd Functions, each the other's backward;
- ``all_gather``: whole frames (``sp``), a whole batch or the CFG pair
  (``data``);
- ``all_reduce_``: the gradient average and the loss, once a step;
- ``reduce_scatter_`` and ``all_gather_into_`` (mesh.fsdp > 1): the split
  tensors' gradients summed into each rank's part of a rank-major flat
  buffer, and the updated parts gathered back (``mesh.FsdpShards``), once
  each a step, and a sharded checkpoint's assembly;
- ``all_reduce_max``, ``barrier``.

Every op runs on the tensors' own device, CUDA tensors under gloo too: the
card's PyTorch build (2.11, CUDA 12.8) takes all_reduce, broadcast,
all_gather(_into_tensor), all_to_all_single (even and uneven) and
reduce_scatter_tensor on CUDA tensors over gloo, so nothing is staged
through host memory; a build that refused one would raise, not fall back.
``CALLS``, ``BYTES`` and ``SECONDS`` count every call, the bytes this rank
sent and the host seconds it waited, for the smoke run's report; a trace
finds each call in a ``synfmc::<op>`` range.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import Counter
from typing import Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

CALLS: Counter = Counter()
BYTES: Counter = Counter()
SECONDS: Counter = Counter()


def reset_counters() -> None:
    for c in (CALLS, BYTES, SECONDS):
        c.clear()


@contextlib.contextmanager
def _op(name: str, sent: int):
    """Count a call of ``name`` that sends ``sent`` bytes, and time it."""
    CALLS[name] += 1
    BYTES[name] += sent
    t0 = time.perf_counter()
    with record_function(f"synfmc::{name}"):
        yield
    SECONDS[name] += time.perf_counter() - t0


def _size(group) -> int:
    """A group's size; None stands for a line of one (``mesh.Axis``)."""
    return 1 if group is None else dist.get_world_size(group)


def row_splits(rows: int, size: int, align: int = 8) -> list[int]:
    """Token-group rows per rank of the ``sp`` group: whole multiples of
    ``align`` where ``rows`` is one (K2 and K8 take N % 8 == 0 only), the
    earlier ranks taking the extra units (24 over 2: 16 + 8); otherwise an
    even split, the earlier ranks taking the remainder."""
    unit = align if rows % align == 0 else 1
    n = rows // unit
    return [unit * (n // size + (1 if i < n % size else 0)) for i in range(size)]


def _all_to_all(out: torch.Tensor, inp: torch.Tensor, out_splits, in_splits, group) -> None:
    row = inp.element_size() * math.prod(inp.shape[1:])
    with _op("all_to_all_single", row * (sum(in_splits) - in_splits[dist.get_rank(group)])):
        dist.all_to_all_single(out, inp, list(out_splits), list(in_splits), group=group)


def _frames_to_rows(x: torch.Tensor, group, index: int, splits: Sequence[int]) -> torch.Tensor:
    b, fl, h, w, c = x.shape
    size = len(splits)
    tokens = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, fl, c).contiguous()
    mine = splits[index]
    out = tokens.new_empty((size * mine, fl, c))
    _all_to_all(out, tokens, [mine] * size, splits, group)
    # the frames of rank j arrive j-th: frame index j * fl + i stays global
    return out.reshape(size, mine, fl, c).permute(1, 0, 2, 3).reshape(mine, size * fl, c)


def _rows_to_frames(y: torch.Tensor, group, index: int, splits: Sequence[int],
                    shape: Sequence[int]) -> torch.Tensor:
    b, fl, h, w, c = shape
    size = len(splits)
    mine = splits[index]
    send = y.reshape(mine, size, fl, c).permute(1, 0, 2, 3).reshape(size * mine, fl, c)
    send = send.contiguous()
    out = y.new_empty((b * h * w, fl, c))
    _all_to_all(out, send, splits, [mine] * size, group)
    return out.reshape(b, h, w, fl, c).permute(0, 3, 1, 2, 4)


class _FramesToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, splits):
        ctx.group, ctx.index, ctx.splits, ctx.shape = group, index, tuple(splits), tuple(x.shape)
        return _frames_to_rows(x, group, index, splits)

    @staticmethod
    def backward(ctx, g):
        return (_rows_to_frames(g.contiguous(), ctx.group, ctx.index, ctx.splits, ctx.shape),
                None, None, None)


class _RowsToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, splits, shape):
        ctx.group, ctx.index, ctx.splits = group, index, tuple(splits)
        return _rows_to_frames(y, group, index, splits, shape)

    @staticmethod
    def backward(ctx, g):
        return (_frames_to_rows(g.contiguous(), ctx.group, ctx.index, ctx.splits),
                None, None, None, None)


def frames_to_rows(x: torch.Tensor, group, index: int, splits: Sequence[int]) -> torch.Tensor:
    """A rank's frames ``(b, f/S, h, w, c)`` -> its rows of the clip's token
    groups ``(splits[index], f, c)``, rows taken in (b, h, w) order and split
    as ``splits`` says (``row_splits``); the frames in global order."""
    return _FramesToRows.apply(x, group, index, tuple(splits))


def rows_to_frames(y: torch.Tensor, group, index: int, splits: Sequence[int],
                   shape: Sequence[int]) -> torch.Tensor:
    """``frames_to_rows``'s inverse: rows ``(splits[index], f, c)`` -> this
    rank's frames, ``shape`` = ``(b, f/S, h, w, c)`` (a permuted view)."""
    return _RowsToFrames.apply(y, group, index, tuple(splits), tuple(shape))


def all_gather_into_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """The group's ``inp`` (equal sizes) laid end to end in rank order into
    ``out``'s own storage."""
    with _op("all_gather_into_tensor", inp.numel() * inp.element_size()):
        dist.all_gather_into_tensor(out, inp, group=group)


def reduce_scatter_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """The sum over the group of ``inp`` (size x ``out.numel()`` elements,
    rank-major: part j for rank j), this rank's part into ``out``.  The
    bytes counted are the parts this rank sends on."""
    with _op("reduce_scatter", inp.element_size() * (inp.numel() - out.numel())):
        dist.reduce_scatter_tensor(out, inp, group=group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's equal shards of ``x`` concatenated along ``dim``, in rank
    order (not differentiable).  A group of one returns ``x``."""
    size = _size(group)
    if size == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((size * xt.shape[0], *xt.shape[1:]))
    all_gather_into_(out, xt, group)
    return out.movedim(0, dim)


def all_reduce_(tensors: Sequence[torch.Tensor], group, average: bool = True) -> None:
    """Sum (or average) each tensor over the group, in place, through one
    flat fp32 buffer (one collective for all of them; a lone contiguous fp32
    tensor is its own buffer)."""
    if _size(group) == 1 or not tensors:
        return
    in_place = (len(tensors) == 1 and tensors[0].dtype == torch.float32
                and tensors[0].is_contiguous())
    flat = tensors[0].view(-1) if in_place else torch.cat([t.reshape(-1).float()
                                                           for t in tensors])
    with _op("all_reduce", flat.numel() * flat.element_size()):
        dist.all_reduce(flat, group=group)
    if average:
        flat.div_(_size(group))
    if in_place:
        return
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _small_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_max(value: int, group) -> int:
    """The largest ``value`` over the group."""
    t = torch.tensor([value], dtype=torch.int64, device=_small_device(group))
    with _op("all_reduce", t.element_size()):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def barrier(group=None) -> None:
    """Every rank of the group waits here."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
