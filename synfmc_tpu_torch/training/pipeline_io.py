"""Host-side training-loop overlap: input prefetch + async checkpointing.

The port's copy of synfmc_tpu/training/pipeline_io.py (``ThreadPrefetcher``
:33, ``AsyncCheckpointWriter`` :147):

- ``ThreadPrefetcher``: a background thread stages batch N+1 (loader wait,
  tokenizer, host-to-device copy) while the device executes step N;
- ``AsyncCheckpointWriter``: checkpoint serialization and the disk write run
  on a writer thread, from a host copy of the state taken between steps.

Both preserve determinism: prefetch changes when a batch is built, never
which batch (sample content is a pure function of (seed, epoch, idx),
data/loader.py), and the host copy is taken before the next step updates
the state.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


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
