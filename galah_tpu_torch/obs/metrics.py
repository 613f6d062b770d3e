"""Typed metrics registry: counters, gauges, histograms. The port's
copy of ``galah_tpu/obs/metrics.py``.

The run's ``timing.StageClock`` keeps the stage seconds and counts;
every other number a run produces (sketch-cache hits and misses, the
exact-ANI pairs computed, the index's generation) is registered here,
so the end-of-run ``run_report.json`` (``obs/report.py``) and the
heartbeat (``obs/heartbeat.py``) carry it.

Thread safety: emission may come from worker threads (the read-ahead
pool), so every mutation happens under the registry's one lock.

One process-wide registry (``GLOBAL``) backs the module-level helpers;
``reset`` gives a run a fresh one.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time as _time
from typing import Dict, Iterator, List, Optional, Union

Number = Union[int, float]

# Each metric's values are read and written under its _lock, and the
# registry's _metrics under the registry's _lock; metrics made by a
# registry share its lock (one lock for all of it).


class Metric:
    """Base: a named, typed, documented series."""

    kind = "metric"

    def __init__(self, name: str, help: str = "", unit: str = "") -> None:
        self.name = name
        self.help = help
        self.unit = unit

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing count (work done, cache hits, ...)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 _lock: Optional[threading.Lock] = None) -> None:
        super().__init__(name, help, unit)
        self._lock = _lock or threading.Lock()
        self.value = 0

    def inc(self, delta: Number = 1) -> None:
        if delta < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (delta={delta})")
        with self._lock:
            self.value += delta

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "value": self.value}


class Gauge(Metric):
    """Last-written value (a ratio, a config-derived size, ...)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 _lock: Optional[threading.Lock] = None) -> None:
        super().__init__(name, help, unit)
        self._lock = _lock or threading.Lock()
        self.value: Optional[Number] = None

    def set(self, value: Number) -> None:
        with self._lock:
            self.value = value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "value": self.value}


class Histogram(Metric):
    """Streaming summary of observations: count / sum / min / max /
    mean (no bucket boundaries to tune; the run report wants honest
    aggregates, not quantile sketches)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 _lock: Optional[threading.Lock] = None) -> None:
        super().__init__(name, help, unit)
        self._lock = _lock or threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: Number) -> None:
        v = float(value)
        if math.isnan(v):
            return  # a NaN observation would poison sum/min/max
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        """Observe the wall-clock duration of a with-block, in
        seconds."""
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.observe(_time.perf_counter() - t0)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean}


class MetricsRegistry:
    """Get-or-create registry of typed metrics, one lock for all of it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, unit: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, unit=unit, _lock=self._lock)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                unit: str = "") -> Counter:
        return self._get_or_create(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "",
                  unit: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help, unit)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """Every metric's current state, JSON-ready, sorted by name."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: metrics[name].snapshot()
                for name in sorted(metrics)}


# Process-wide registry backing the module-level helpers.
GLOBAL = MetricsRegistry()

#: The one pipeline-occupancy gauge name: the fraction of a streaming
#: stage's wall spent with the consumer busy (1.0 = never starved). The
#: heartbeat and the report read it under this name.
PIPELINE_OCCUPANCY_GAUGE = "workload.pipeline_occupancy"


def pipeline_occupancy(value: float, stage: str = "") -> Gauge:
    """Set the occupancy gauge (per-stage variant via ``[stage]``)."""
    name = (f"{PIPELINE_OCCUPANCY_GAUGE}[{stage}]" if stage
            else PIPELINE_OCCUPANCY_GAUGE)
    g = GLOBAL.gauge(
        name,
        help="Streaming-stage occupancy: fraction of stage wall with "
             "the consumer busy (1.0 = never starved)")
    g.set(max(0.0, min(1.0, float(value))))
    return g


def counter(name: str, help: str = "", unit: str = "") -> Counter:
    return GLOBAL.counter(name, help=help, unit=unit)


def gauge(name: str, help: str = "", unit: str = "") -> Gauge:
    return GLOBAL.gauge(name, help=help, unit=unit)


def histogram(name: str, help: str = "", unit: str = "") -> Histogram:
    return GLOBAL.histogram(name, help=help, unit=unit)


def snapshot() -> Dict[str, dict]:
    return GLOBAL.snapshot()


def reset() -> None:
    """Fresh registry (run start / tests)."""
    global GLOBAL
    GLOBAL = MetricsRegistry()
