"""Host-side training-loop overlap: input prefetch + async checkpointing.

The port's copy of synfmc_tpu/training/pipeline_io.py (``ThreadPrefetcher``
:33, ``AsyncCheckpointWriter`` :147):

- ``ThreadPrefetcher``: a background thread stages batch N+1 (loader wait,
  tokenizer, host-to-device copy) while the device executes step N;
- ``AsyncCheckpointWriter``: checkpoint serialization and the disk write run
  on a writer thread, from a host copy of the state taken between steps;
- ``snapshot_on_device`` / ``snapshot_fits_on_device`` (:102-140): the
  device-side copy of the state that lets the writer thread do the
  device-to-host copy too (``PinnedCopier``, on a CUDA stream of its own),
  and whether it fits beside the step's high-water mark.

Both preserve determinism: prefetch changes when a batch is built, never
which batch (sample content is a pure function of (seed, epoch, idx),
data/loader.py), and the host copy or the snapshot is taken before the next
step updates the state.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from synfmc_tpu_torch.parallel.mesh import tree_map


def snapshot_on_device(tree: Any) -> Any:
    """A device-side copy of every tensor of ``tree`` (a ``Shard``'s rows
    included), enqueued on the current stream before the next step changes
    the state, so that it holds the pre-step values while the writer thread
    copies it to the host at leisure (``PinnedCopier``)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def snapshot_fits_on_device(nbytes: int, headroom: float = 1.25, device=None) -> bool:
    """Whether a snapshot of ``nbytes`` fits on ``device`` beside the step's
    high-water mark: the snapshot lives through the next steps while the
    writer drains it, so it must fit at the step's peak
    (``max_memory_allocated``), not between steps.  What this process can
    reach is the card's free memory (``mem_get_info``, other processes on
    the card counted) plus what its allocator holds.  False where the
    device cannot say (the CPU), as the JAX function answers."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(dev)
    reachable = free + torch.cuda.memory_reserved(dev)
    return torch.cuda.max_memory_allocated(dev) + nbytes * headroom < reachable


class PinnedCopier:
    """Copies a snapshot's tensors to the host on a CUDA stream of its own
    (the writer thread's, so that the copy does not queue behind the next
    step on the default stream), into pinned host tensors kept from one
    checkpoint to the next.  A copy into pageable memory stalls the training
    loop's launches for its whole length, even from another thread and
    stream, and so does allocating pinned memory; a copy into pinned memory
    that is already there runs beside the loop (PERF.md §6).  The
    returned tree holds the kept tensors, so it is read before the next
    call.  On the CPU it clones."""

    def __init__(self, device):
        device = torch.device(device)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._host: list = []

    def __call__(self, tree: Any, ready=None) -> Any:
        """``tree`` on the host, once the event ``ready`` (recorded after
        the snapshot) has passed."""
        if self.stream is None:
            return tree_map(lambda t: t.to("cpu", copy=True), tree)
        slot = itertools.count()

        def copy(t):
            k = next(slot)
            if k == len(self._host):
                self._host.append(None)
            h = self._host[k]
            if h is None or h.shape != t.shape or h.dtype != t.dtype:
                h = self._host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t, non_blocking=True)

        with torch.cuda.stream(self.stream):
            if ready is not None:
                self.stream.wait_event(ready)
            host = tree_map(copy, tree)
        self.stream.synchronize()
        return host


class ThreadPrefetcher:
    """Wrap an iterator so ``next()`` overlaps with consumer compute.

    ``depth`` items are staged ahead by a daemon thread.  Exceptions raised
    by the source propagate to the consumer at the matching ``next()`` call.
    ``close()`` stops the thread promptly (it must be called when abandoning
    the iterator early, else the thread parks on a full queue holding
    references to the source).
    """

    _SENTINEL = object()

    def __init__(self, source: Iterator, depth: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(source,), daemon=True, name="batch-prefetch"
        )
        self._thread.start()

    def _run(self, source: Iterator) -> None:
        try:
            for item in source:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(self._SENTINEL)
        except BaseException as e:  # surface loader crashes at next()
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        # unblock a producer parked on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class AsyncCheckpointWriter:
    """Serialize checkpoint writes onto a single background thread.

    ``submit`` waits for the previous write (checkpoints must land in
    order; Orbax paths could also collide) then runs ``fn`` on a fresh
    daemon thread.  ``wait`` joins the in-flight write and re-raises any
    failure — call it before reading back a checkpoint and at train end.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err
