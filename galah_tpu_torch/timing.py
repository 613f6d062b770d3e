"""Per-stage wall times and counts of one run.

A :class:`StageClock` is created by the caller (the CLI creates one per
run) and handed to the stores, the backends and the engine. Each stage
ends with a device synchronize, so its host-clock time covers the
device work it queued, not only the enqueue. Stages may nest (the
greedy stage reads and profiles the genomes its exact ANIs need); a
stage's seconds exclude the stages run inside it, so the stages of a
run add up to at most its wall.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, List, TypeVar

import torch

from galah_tpu_torch.device import synchronize

T = TypeVar("T")


class StageClock:
    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # seconds of work on worker threads, summed over the threads (so
        # they may exceed the wall; they are no stage)
        self.work_seconds: Dict[str, float] = defaultdict(float)
        self._work_lock = threading.Lock()
        # per open stage, the seconds of the stages nested in it so far
        self._inner: List[float] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            synchronize(self.device)
            elapsed = time.perf_counter() - t0
            self.seconds[name] += elapsed - self._inner.pop()
            if self._inner:
                self._inner[-1] += elapsed

    def count(self, name: str, n: int) -> None:
        self.counts[name] += int(n)

    def waits(self, items: Iterable[T], name: str,
              count: str) -> Iterator[T]:
        """`items`, with each wait for the next one timed as stage
        `name` (the consumer's wait on a read-ahead) and each item
        counted under `count`."""
        it = iter(items)
        while True:
            with self.stage(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            self.count(count, 1)
            yield item

    def timed(self, fn: Callable[..., T], name: str) -> Callable[..., T]:
        """`fn`, adding the seconds of each call, on whatever thread it
        runs, to ``work_seconds[name]``."""
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                dt = time.perf_counter() - t0
                with self._work_lock:
                    self.work_seconds[name] += dt
        return run
