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
  JAX module's; ``fetch_to_host`` is trivial while nothing is sharded
  (``mesh.fsdp`` = 1: every rank holds every tensor whole).

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


def fetch_to_host(tree: Any) -> Any:
    """A tree of tensors copied to host memory.  Every rank holds every
    tensor whole (``mesh.fsdp`` = 1), so no collective is needed."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: fetch_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_to_host(v) for v in tree)
    return tree
