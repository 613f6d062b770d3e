"""Per-stage wall times and counts of one run.

A :class:`StageClock` is created by the caller (the CLI creates one per
run) and handed to the store, the backends and the engine. Each stage
ends with a device synchronize, so its host-clock time covers the
device work it queued, not only the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

from galah_tpu_torch.device import synchronize


class StageClock:
    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.seconds[name] += time.perf_counter() - t0

    def count(self, name: str, n: int) -> None:
        self.counts[name] += int(n)
