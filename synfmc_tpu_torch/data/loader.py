"""Host-side data loading: a persistent pool of worker processes.

The port's copy of synfmc_tpu/data/loader.py: worker *processes* run the dataset's numpy
``__getitem__`` (pure Python and numpy, so threads would serialize on the
GIL); a bounded result queue applies backpressure and the parent reorders
batches so iteration order is deterministic.  The epoch's permutation is
``np.random.default_rng((seed, epoch))``'s, as in the JAX package, and
sample content is a pure function of (dataset seed, epoch, index), so the
batch sequence equals the JAX loader's and does not depend on the number of
workers.

Several processes (``process_index`` of ``process_count``: the trainer's
ranks of the mesh's ``data`` axis) stride-slice the same global
permutation, as DistributedSampler does, so the shards are disjoint.  Each
shard is cut to ``len(dataset) // process_count`` examples, so that every
rank has the same number of batches an epoch: a length the ranks do not
divide would otherwise give the first ranks one batch more, and the others
would wait for it at their next collective.  (The JAX package keeps the
longer shards; this cut is the port's.)

Workers are forked from a parent that has usually initialised CUDA already.
They must stay numpy-only: ``_forbid_cuda_in_worker`` makes any CUDA use in
a worker raise at once, and a worker's exception is sent to the parent and
raised there with the worker's traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Callable, Iterator, Optional

import numpy as np

STALL_S = 600.0
PREFETCH = 2  # batches in flight beyond one a worker


def _forbid_cuda_in_worker() -> None:
    """Make CUDA use inside a data worker (a forked child) raise.  Every CUDA
    tensor, stream or query initialises through ``torch.cuda._lazy_init``."""
    import torch

    def _raise(*_a, **_k):
        raise RuntimeError("CUDA used inside a data-loader worker (a forked child): dataset "
                           "code must be numpy-only; move device work to the parent")

    torch.cuda._lazy_init = _raise
    torch.cuda.init = _raise


class WorkerError(RuntimeError):
    """An exception raised in a worker, with the worker's traceback."""


def _worker_loop(dataset, collate_fn, job_q, out_q) -> None:
    """Persistent worker: lives across epochs until ``close`` terminates it;
    jobs are (bi, batch_idx, epoch, gen)."""
    import signal

    # The trainer installs a preemption handler (SIGTERM -> checkpoint and
    # exit) in the parent; a worker that inherited it would not die on
    # Process.terminate().  Workers are stateless: default-die on TERM,
    # ignore ctrl-C (the parent checkpoints and shuts the pool down).
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    _forbid_cuda_in_worker()
    cur_epoch = None
    while True:
        bi, batch_idx, epoch, gen = job_q.get()
        try:
            if epoch != cur_epoch:
                cur_epoch = epoch
                dataset.set_epoch(epoch)
            batch = collate_fn([dataset[int(i)] for i in batch_idx])
        except Exception:
            batch = WorkerError(traceback.format_exc())
        out_q.put((bi, gen, batch))  # blocks when full: backpressure


class ShardedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.dataset = dataset
        self.process_index = process_index
        self.process_count = process_count
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.epoch = 0
        self.start_batch = 0
        self._gen = 0  # per-iterator generation tag (stale-result filtering)
        self._workers: list = []
        self._job_q = None
        self._out_q = None

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Per-epoch reshuffle; ``start_batch`` skips the first N batches of
        the epoch without loading them (mid-epoch resume)."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _epoch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """The global permutation of the global seed (every rank computes the
        same one), this rank's stride slice of it, cut to the shortest
        rank's length."""
        idx = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, self.epoch if epoch is None else epoch)).shuffle(idx)
        shard = idx[self.process_index::self.process_count]
        return shard[:len(idx) // self.process_count]

    def _epoch_batches(self, epoch: Optional[int] = None) -> list[np.ndarray]:
        indices = self._epoch_indices(epoch)
        step = self.batch_size
        stop = len(indices) - (step - 1 if self.drop_last else 0)
        return [indices[i : i + step] for i in range(0, stop, step)]

    def __len__(self) -> int:
        return len(self._epoch_batches())

    def _ensure_workers(self) -> None:
        """Start the persistent worker pool once (fork: the dataset reaches
        the workers by copy-on-write, with its C++ library already loaded)."""
        if self._workers:
            return
        ctx = mp.get_context("fork")
        self._job_q = ctx.Queue()
        self._out_q = ctx.Queue(maxsize=PREFETCH + self.num_workers)
        self._workers = [
            ctx.Process(target=_worker_loop,
                        args=(self.dataset, self.collate_fn, self._job_q, self._out_q),
                        daemon=True)
            for _ in range(self.num_workers)
        ]
        for w in self._workers:
            w.start()

    def close(self) -> None:
        """Stop the worker pool (idempotent; also runs at GC).  Workers are
        stateless, and one may be blocked on a full result queue, so they
        are terminated rather than asked to finish their jobs."""
        if not self._workers:
            return
        started = [w for w in self._workers if w.pid is not None]
        for w in started:
            w.terminate()
        for w in started:
            w.join(timeout=5)
        for q in (self._job_q, self._out_q):
            q.cancel_join_thread()
            q.close()
        self._workers = []
        self._job_q = self._out_q = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _result(self, gen: int):
        """The next result of iterator ``gen``; raises a worker's exception,
        and when no result comes for ``STALL_S`` or a worker has died."""
        t0 = time.monotonic()
        while True:
            try:
                bi, g, batch = self._out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [w.exitcode for w in self._workers if not w.is_alive()]
                if dead or time.monotonic() - t0 > STALL_S:
                    raise RuntimeError(f"data workers stalled (exitcodes={dead})") from None
                continue
            if g != gen:
                continue  # stale result from an abandoned earlier iterator
            if isinstance(batch, WorkerError):
                raise batch
            return bi, batch

    def epochs(self, start_epoch: int = 0, start_batch: int = 0) -> Iterator[tuple[int, dict]]:
        """Infinite cross-epoch stream of ``(epoch, batch)``: the next epoch's
        jobs are enqueued as soon as the in-flight window (num_workers +
        PREFETCH) has room, so workers never idle at an epoch boundary.
        The sequence equals repeated ``set_epoch`` + ``__iter__``."""
        if self.num_workers == 0:  # synchronous path
            ep, sb = start_epoch, start_batch
            while True:
                self.dataset.set_epoch(ep)
                for batch_idx in self._epoch_batches(ep)[sb:]:
                    yield ep, self.collate_fn([self.dataset[int(i)] for i in batch_idx])
                ep, sb = ep + 1, 0

        self._ensure_workers()
        self._gen += 1
        gen = self._gen

        def jobs():
            ep, sb = start_epoch, start_batch
            while True:
                for batch_idx in self._epoch_batches(ep)[sb:]:
                    yield ep, batch_idx
                ep, sb = ep + 1, 0

        job_iter = jobs()
        window = self.num_workers + PREFETCH
        epochs_by_bi: dict[int, int] = {}
        next_bi = 0
        want = 0
        reorder: dict[int, dict] = {}
        while True:
            while next_bi - want < window:
                ep, batch_idx = next(job_iter)
                self._job_q.put((next_bi, batch_idx, ep, gen))
                epochs_by_bi[next_bi] = ep
                next_bi += 1
            while want not in reorder:
                bi, batch = self._result(gen)
                reorder[bi] = batch
            yield epochs_by_bi.pop(want), reorder.pop(want)
            want += 1

    def __iter__(self) -> Iterator[dict]:
        batches = self._epoch_batches()[self.start_batch :]
        if self.num_workers == 0:  # synchronous path
            self.dataset.set_epoch(self.epoch)
            for batch_idx in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in batch_idx])
            return

        self._ensure_workers()
        self._gen += 1
        gen = self._gen
        for bi, batch_idx in enumerate(batches):
            self._job_q.put((bi, batch_idx, self.epoch, gen))

        reorder: dict[int, dict] = {}
        for want in range(len(batches)):
            while want not in reorder:
                bi, batch = self._result(gen)
                reorder[bi] = batch
            yield reorder.pop(want)
