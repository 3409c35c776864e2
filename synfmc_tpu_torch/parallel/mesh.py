"""The device mesh over ``torch.distributed`` process groups.

The counterpart of synfmc_tpu/parallel/mesh.py with one process per GPU, as
PyTorch runs it (``python -m torch.distributed.run --nproc-per-node N``),
where the JAX package runs one process over every local device.  Ranks are
laid out as ``create_mesh`` / ``create_serving_mesh`` reshape devices:
``np.arange(world).reshape(sizes)``, data-major, the last axis (``sp``)
varying fastest, and every line of every axis gets a process group.

- ``init_distributed`` joins the group torchrun's environment describes;
- ``Mesh`` holds this rank's coordinates and its line of each axis;
- ``is_main_process``, ``local_shard_indices`` and ``sync_stop_flag`` are the
  JAX module's;
- ``fsdp_rows`` is ``shard_over_fsdp``'s rule as a pure function of names and
  shapes, ``FsdpShards`` a tensor set's ZeRO-1 layout on this rank (its rank-
  major flat buffer), ``Shard`` a rank's rows of one tensor, and
  ``gather_shards`` / ``fetch_to_host`` assemble a tree of them (a collective
  over the fsdp line, as the JAX module's ``process_allgather``).

A mesh never falls back: a world size that does not fit it, a mesh > 1
without a process group, and two NCCL ranks on one device all raise.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.parallel import collectives

TRAIN_AXES = ("data", "fsdp", "sp")
LAUNCH = "python -m torch.distributed.run --nproc-per-node N -m <module> ..."


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group that torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) describes; returns this rank's
    device.  ``device`` defaults to ``cuda:LOCAL_RANK`` (raises when this
    host has fewer GPUs), ``backend`` to ``nccl`` for CUDA and ``gloo`` for
    the CPU; ``torch.cuda.set_device`` runs before the group starts.  Ranks
    that share a card pass that card and ``backend="gloo"``: NCCL refuses two
    ranks on one device, and this raises for it before any collective."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"no process group environment ({', '.join(missing)} unset): launch "
                           f"with {LAUNCH}")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    if device is None:
        dev = resolve_device(None)
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but this host has {torch.cuda.device_count()} GPU(s): "
                f"launch at most that many ranks a host, or pass the device (and "
                f"backend='gloo' for ranks that share one)")
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError("a process group with another rank or world size is running")
        return dev
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kw)
    if backend == "nccl" and world > 1:
        _check_devices(rank, world, dev)
    return dev


def _check_devices(rank: int, world: int, dev: torch.device) -> None:
    """Raise when two ranks of the NCCL group sit on one device (read
    through the group's store, before any collective)."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"synfmc/device/{rank}", f"{socket.gethostname()}/{dev}")
    seen: dict[str, int] = {}
    for r in range(world):
        where = store.get(f"synfmc/device/{r}").decode()
        if where in seen:
            raise RuntimeError(
                f"ranks {seen[where]} and {r} share {where} over NCCL, which refuses two ranks "
                f"on one device: give each rank its own GPU, or pass backend='gloo'")
        seen[where] = r


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The rank-0 guard (the reference's global_rank == 0)."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's line along one mesh axis: its group (None for a line of
    one), the global ranks on it in order, and this rank's index there."""

    name: str
    group: Any
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """Ranks laid out as ``np.arange(world).reshape(sizes)`` over named axes,
    the last varying fastest (``training_mesh``, ``serving_mesh``)."""

    def __init__(self, sizes: dict):
        self.names = tuple(sizes)
        self.shape = {k: int(v) for k, v in sizes.items()}
        self.rank = rank()
        if any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes must be >= 1, got {self.shape}")
        self.size = math.prod(self.shape.values())
        if self.size > 1 and not dist.is_initialized():
            raise RuntimeError(f"a {self._desc()} mesh needs a process group: launch with "
                               f"{LAUNCH} and call parallel.mesh.init_distributed() first")
        if world_size() != self.size:
            raise ValueError(f"{world_size()} ranks cannot form a {self._desc()} mesh "
                             f"({self.size} ranks): launch {self.size}")
        grid = np.arange(self.size).reshape([self.shape[n] for n in self.names])
        here = np.argwhere(grid == self.rank)[0]
        self.axes: dict[str, Axis] = {}
        for i, name in enumerate(self.names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[name])
            for line in lines:  # every rank creates every group, in the same order
                ranks = tuple(int(r) for r in line)
                group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self.axes[name] = Axis(name, group, ranks, int(here[i]))
        # the replica plane: the ranks of this rank's fsdp index (data x sp),
        # over which a sharded gradient sums after the fsdp reduce-scatter
        self.replicas: Optional[Axis] = None
        if self.shape.get("fsdp", 1) > 1:
            i = self.names.index("fsdp")
            for plane in np.moveaxis(grid, i, 0).reshape(self.shape["fsdp"], -1):
                ranks = tuple(int(r) for r in plane)
                group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self.replicas = Axis("replicas", group, ranks, ranks.index(self.rank))

    def _desc(self) -> str:
        return " x ".join(f"{k}={v}" for k, v in self.shape.items())

    def __repr__(self) -> str:
        return f"Mesh({self._desc()}, rank {self.rank})"

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def index(self, name: str) -> int:
        return self.axes[name].index if name in self.axes else 0

    def count(self, name: str) -> int:
        return self.shape.get(name, 1)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def world_group(self):
        """The group of every rank (None for a mesh of one)."""
        return dist.group.WORLD if self.size > 1 else None


def serving_mesh(data: int, sp: int = 1) -> Mesh:
    """``create_serving_mesh``'s ('data', 'sp') layout."""
    return Mesh({"data": data, "sp": sp})


def training_mesh(data: int = 1, fsdp: int = 1, sp: int = 1) -> Mesh:
    """``create_mesh``'s ('data', 'fsdp', 'sp') layout."""
    return Mesh({"data": data, "fsdp": fsdp, "sp": sp})


def shard(n: int, axis, what: str) -> slice:
    """This rank's equal part of ``n`` items (prompts, samples, frames) along
    ``axis``: all of them without one (or on a line of one)."""
    if axis is None or axis.size == 1:
        return slice(None)
    if n % axis.size:
        raise ValueError(f"{n} {what} must divide over the mesh '{axis.name}' axis {axis.size}")
    k = n // axis.size
    return slice(axis.index * k, (axis.index + 1) * k)


def local_shard_indices(total: int) -> np.ndarray:
    """This rank's example indices, round-robin by rank (DistributedSampler)."""
    return np.arange(rank(), total, world_size())


def barrier() -> None:
    """Every rank waits here (none without a process group)."""
    if world_size() > 1:
        collectives.barrier()


def sync_stop_flag(local: bool) -> bool:
    """Collective OR of a per-rank stop flag (a MAX all-reduce): a signal
    that lands on one rank stops every rank at the same step.  Every rank
    calls it at the same point of every step; alone it returns ``local``."""
    if world_size() == 1:
        return bool(local)
    return bool(collectives.all_reduce_max(int(bool(local)), dist.group.WORLD))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (itself alone)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_object_device())
    return box[0]


def _object_device() -> Optional[torch.device]:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


MIN_SHARD_ELEMENTS = 1024  # shard_over_fsdp's min_size


def fsdp_rows(shapes: dict, fsdp: int, index: int,
              min_size: int = MIN_SHARD_ELEMENTS) -> dict:
    """``shard_over_fsdp``'s rule (synfmc_tpu/parallel/mesh.py:121-154) on
    named shapes: a tensor whose dim 0 ``fsdp`` divides and that holds at
    least ``min_size`` elements is split on dim 0 over the fsdp line, and
    rank ``index`` of the line owns the rows ``slice`` returned for it; any
    other tensor is replicated (None).  torch's dim 0 is the out-features or
    out-channels, where flax's is the in-features or the kernel height, so
    the set of split tensors differs from the JAX package's (memory only)."""
    rows = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        split = fsdp > 1 and shape and shape[0] % fsdp == 0 and math.prod(shape) >= min_size
        k = shape[0] // fsdp if split else 0
        rows[name] = slice(index * k, (index + 1) * k) if split else None
    return rows


@dataclasses.dataclass
class Shard:
    """This rank's rows of a tensor split on dim 0 over the fsdp line
    ``axis``: ``local`` holds rank ``axis.index``'s equal part, the line's
    ranks the others in order."""

    local: torch.Tensor
    axis: Axis

    @property
    def whole_shape(self) -> tuple:
        return (self.local.shape[0] * self.axis.size, *self.local.shape[1:])


class FsdpShards:
    """A named tensor set's ZeRO-1 layout on this rank of ``mesh``
    (``fsdp_rows`` of ``shapes``): the fsdp line, the replica plane, the
    rows this rank owns of each split tensor, and the rank-major flat buffer
    that carries the split tensors through one collective each way: part j
    is rank j's rows of every split tensor, laid end to end in name order."""

    def __init__(self, mesh: Mesh, shapes: dict):
        self.axis, self.plane = mesh.axis("fsdp"), mesh.replicas
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.rows = fsdp_rows(self.shapes, self.axis.size, self.axis.index)
        self.names = [n for n, r in self.rows.items() if r is not None]
        self.chunk = {n: math.prod(self.shapes[n]) // self.axis.size for n in self.names}
        self.offset, c = {}, 0
        for n in self.names:
            self.offset[n], c = c, c + self.chunk[n]
        self.part = c  # elements of one rank's part

    def local_shape(self, name: str) -> tuple:
        shape = self.shapes[name]
        return (shape[0] // self.axis.size, *shape[1:]) if self.rows[name] else shape

    def take(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``whole`` (a view), or ``whole`` if replicated."""
        r = self.rows[name]
        return whole if r is None else whole[r]

    def _parts(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        """``name``'s rows of every rank in the flat buffer, (size, k, ...)."""
        o, c = self.offset[name], self.chunk[name]
        return flat.view(self.axis.size, self.part)[:, o:o + c].view(
            self.axis.size, *self.local_shape(name))

    def pack(self, tensors: dict, dtype: torch.dtype) -> torch.Tensor:
        """The split tensors (whole, by name, any strides: a conv weight is
        channels-last) as the rank-major flat buffer in ``dtype``, each
        rank's rows in logical order: ``size * part`` elements."""
        ref = tensors[self.names[0]]
        flat = torch.empty(self.axis.size * self.part, dtype=dtype, device=ref.device)
        for n in self.names:
            self._parts(flat, n).copy_(tensors[n].unflatten(0, (self.axis.size, -1)))
        return flat

    def unpack_into(self, flat: torch.Tensor, tensors: dict) -> None:
        """Write the rank-major flat buffer into the whole tensors (by name)."""
        for n in self.names:
            tensors[n].unflatten(0, (self.axis.size, -1)).copy_(self._parts(flat, n))

    def split(self, part: torch.Tensor) -> dict:
        """One rank's part of the flat buffer as views of each split
        tensor's rows."""
        return {n: part[self.offset[n]:self.offset[n] + self.chunk[n]].view(self.local_shape(n))
                for n in self.names}

    def wrap(self, tensors: dict) -> dict:
        """``tensors`` (this rank's, by name) with each split tensor's rows
        as a ``Shard``, for ``gather_shards`` / ``fetch_to_host``."""
        return {n: Shard(t, self.axis) if self.rows[n] else t for n, t in tensors.items()}


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _map_leaves(out.append, tree)
    return out


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a tree, a ``Shard``'s rows included (the
    result stays a ``Shard``); other leaves as they are."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        if isinstance(x, Shard):
            return Shard(fn(x.local), x.axis)
        return x

    return _map_leaves(leaf, tree)


def tree_nbytes(tree: Any) -> int:
    """The bytes of a tree's tensors, a ``Shard`` counted whole."""
    n = 0
    for x in _leaves(tree):
        if isinstance(x, Shard):
            n += x.local.element_size() * math.prod(x.whole_shape)
        elif isinstance(x, torch.Tensor):
            n += x.element_size() * x.numel()
    return n


def gather_shards(tree: Any) -> Any:
    """The tree with every ``Shard`` replaced by its whole tensor on this
    rank's device; other leaves as they are.  A collective: every rank of
    the fsdp line calls it at the same point with the same tree structure;
    one all-gather of a rank-major flat buffer for each (line, dtype), and
    the whole tensors land on every rank of the line.  Without a ``Shard``
    it runs nothing."""
    shards = [x for x in _leaves(tree) if isinstance(x, Shard)]
    whole: dict = {}
    buckets: dict = {}
    for s in shards:
        buckets.setdefault((s.axis.ranks, s.local.dtype), []).append(s)
    for bucket in buckets.values():
        axis = bucket[0].axis
        send = torch.cat([s.local.reshape(-1) for s in bucket])
        recv = send.new_empty((axis.size, send.numel()))
        collectives.all_gather_into_(recv.view(-1), send, axis.group)
        o = 0
        for s in bucket:
            c = s.local.numel()
            whole[id(s)] = recv[:, o:o + c].reshape(s.whole_shape)
            o += c
        del recv
    return _map_leaves(lambda x: whole[id(x)] if isinstance(x, Shard) else x, tree)


def fetch_to_host(tree: Any) -> Any:
    """The counterpart of the JAX module's ``fetch_to_host``: the tree with
    every tensor whole in host memory.  On a sharded tree (``Shard`` leaves)
    it is a collective (``gather_shards``): every rank of the fsdp line calls
    it at the same point, and the whole tensors land on every caller's host.
    Without a ``Shard`` it is a copy, and no collective runs."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), gather_shards(tree))
