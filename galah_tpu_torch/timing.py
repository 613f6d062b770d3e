"""Per-stage wall times and counts of one run.

A :class:`StageClock` is created by the caller (the CLI creates one per
run) and handed to the stores, the backends and the engine. Each stage
ends with a device synchronize, so its host-clock time covers the
device work it queued, not only the enqueue. Stages may nest (the
greedy stage reads and profiles the genomes its exact ANIs need); a
stage's ``seconds`` exclude the stages run inside it, so the stages of
a run add up to at most its wall.

For the run report (``obs/report.py``) the clock also keeps the stage
tree, each stage path's inclusive seconds and count in the shape of
``galah_tpu``'s ``StageTimer.tree()``, and the kernel launches of the
run (the deltas of ``kernels.LAUNCHES`` since the clock was made),
which the report reads as ``disp[<kernel>]`` counters. Each stage that
closes is a trace span (``obs/trace.py``), emitted after its device
synchronize.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import (Callable, Dict, Iterable, Iterator, List, Tuple,
                    TypeVar)

import torch

from galah_tpu_torch import kernels
from galah_tpu_torch.device import synchronize
from galah_tpu_torch.obs import trace

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
        # per open stage, its name and the seconds of the stages nested
        # in it so far
        self._open: List[str] = []
        self._inner: List[float] = []
        # stage path -> [inclusive seconds, count], in first-close order
        self._tree: Dict[Tuple[str, ...], List[float]] = {}
        self._launches0 = dict(kernels.LAUNCHES)
        self._born = time.monotonic()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        self._open.append(name)
        self._inner.append(0.0)
        try:
            yield
        finally:
            synchronize(self.device)
            elapsed = time.perf_counter() - t0
            self.seconds[name] += elapsed - self._inner.pop()
            if self._inner:
                self._inner[-1] += elapsed
            node = self._tree.setdefault(tuple(self._open), [0.0, 0])
            node[0] += elapsed
            node[1] += 1
            self._open.pop()
            trace.emit_complete(name, t0, elapsed, cat="stage")

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
        runs, to ``work_seconds[name]``; each call is a trace span of
        category ``work`` on its thread."""
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                dt = time.perf_counter() - t0
                with self._work_lock:
                    self.work_seconds[name] += dt
                trace.emit_complete(name, t0, dt, cat="work")
        return run

    def elapsed(self) -> float:
        """Wall-clock seconds since this clock was made."""
        return time.monotonic() - self._born

    def tree(self) -> List[dict]:
        """The nested stage tree, JSON-ready: each node is {name,
        total_s (inclusive), count, children}, in first-close order of
        its path, a parent made on demand when a child closes first
        (``galah_tpu``'s ``StageTimer.tree()``)."""
        data = {p: tuple(v) for p, v in self._tree.items()}
        nodes: Dict[Tuple[str, ...], dict] = {}
        roots: List[dict] = []

        def node_for(path: Tuple[str, ...]) -> dict:
            node = nodes.get(path)
            if node is None:
                acc, count = data.get(path, (0.0, 0))
                node = {"name": path[-1], "total_s": round(acc, 6),
                        "count": count, "children": []}
                nodes[path] = node
                if len(path) == 1:
                    roots.append(node)
                else:
                    node_for(path[:-1])["children"].append(node)
            return node

        for path in data:
            node_for(path)
        return roots

    def launches(self) -> Dict[str, int]:
        """Each kernel's launches since this clock was made, those
        launched at least once."""
        out = {}
        for name, n in kernels.LAUNCHES.items():
            delta = n - self._launches0.get(name, 0)
            if delta:
                out[name] = delta
        return out

    def counters(self) -> Dict[str, int]:
        """The counts, and each launched kernel's launches as
        ``disp[<kernel>]``: the counters of ``galah_tpu``'s run report."""
        out = dict(self.counts)
        for name, n in self.launches().items():
            out[f"disp[{name}]"] = n
        return out
