"""Dynamic micro-batching for the serving daemon (a copy of
synfmc_tpu/serving/batcher.py, pure Python).

Requests that agree on the shape-relevant parameters (video_length, steps,
guidance) are coalesced into ONE batched pipeline call instead of queueing
serially on the device:

- **Bounded shapes.** Batched shapes are bucketed to powers of two up to
  ``max_batch`` (1, 2, 4, ...); a group of 3 samples pads to 4 by repeating
  the last sample and the padded outputs are dropped.
- **Per-request seeds stay exact.** Each request's initial latents are
  drawn from its own generator seeded with its seed, at its own shape, and
  concatenated, so a batched sample starts from the noise its solo run
  would.
- **Errors are per-group, surfaced per-request.** A failing group marks
  every member with the exception; the dispatch thread keeps serving.

The port's ``Job`` carries the camera already parsed (intrinsics, RT) by the
HTTP handler, which validated it, so the text is parsed once.
``run_group(jobs, key) -> list[result]`` is supplied by the caller
(scripts/serve.py builds the padded pipeline call there).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class Job:
    """One /generate request: ``prompts`` contributes len(prompts) samples."""

    prompts: list
    seed: int
    camera: Optional[tuple]  # (intrinsics (F, 4), RT (F, 3, 4)) parsed by the handler, or None
    video_length: int
    steps: int
    guidance: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None

    @property
    def key(self) -> tuple:
        return (self.video_length, self.steps, self.guidance)

    @property
    def n(self) -> int:
        return len(self.prompts)


def bucket_size(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch (bounds the shapes seen)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, n))


class MicroBatcher:
    """Single dispatch thread owning the device; callers block in submit().

    ``batch_window``: after picking up a head request, wait up to this many
    seconds for same-key followers before dispatching (0 = never wait —
    coalescing then only happens when requests are already queued behind a
    running group, which is exactly the overloaded case batching exists for).
    """

    def __init__(self, run_group: Callable, max_batch: int = 1,
                 batch_window: float = 0.0):
        self.run_group = run_group
        self.max_batch = max(1, int(max_batch))
        self.batch_window = float(batch_window)
        self._buf: deque[Job] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def submit(self, job: Job):
        with self._cv:
            self._buf.append(job)
            self._cv.notify()
        job.event.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _take_group(self) -> Optional[list[Job]]:
        with self._cv:
            while not self._buf and not self._stop:
                self._cv.wait()
            if self._stop and not self._buf:
                return None
            group = [self._buf.popleft()]
        if self.batch_window > 0 and group[0].n < self.max_batch:
            # optional accumulation pause for bursty-but-not-yet-queued load
            threading.Event().wait(self.batch_window)
        with self._cv:
            budget = self.max_batch - group[0].n
            i = 0
            while i < len(self._buf) and budget > 0:
                j = self._buf[i]
                if j.key == group[0].key and j.n <= budget:
                    del self._buf[i]
                    group.append(j)
                    budget -= j.n
                else:
                    i += 1
        return group

    def _loop(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            try:
                results = self.run_group(group, group[0].key)
                if len(results) != len(group):
                    raise RuntimeError(f"run_group gave {len(results)} results for "
                                       f"{len(group)} jobs")
                for j, r in zip(group, results):
                    j.result = r
            except Exception as e:  # the group's members get it; the thread serves on
                for j in group:
                    j.error = e
            finally:
                for j in group:
                    j.event.set()
