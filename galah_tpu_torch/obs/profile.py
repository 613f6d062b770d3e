"""Per-kernel device costs of a run: the ``device_costs`` section of the
run report. The port's copy of ``galah_tpu/obs/profile.py``.

Each kernel wrapper in ``ops/`` brackets its launch with its entry's
``launch`` (``profiled(name)``, registered once a kernel), next to the
``kernels.LAUNCHES`` count that marks the launch, so an entry's
``calls`` are the kernel's launches. There is nothing to lower or
compile ahead of time: an entry records, per run,

  * ``calls`` (CUDA launches) and ``plain_calls`` (the wrapper given CPU
    tensors ran the plain version), and ``signatures``, the distinct
    (shape, dtype) keys it was called with;
  * ``dispatch_wall_s``: host seconds spent in the launch calls;
  * ``compile_wall_s``: the ``nvcc`` build of the kernel
    (``kernels/build.py``), charged to the run that built it;
  * ``flops`` and ``bytes_accessed``: 32-bit operations and bytes of
    every call, counted from its shapes (``kernels/costs.py``, the rule
    of PERF.md's Bound column), plain calls included;
  * ``device_s``: the stream's seconds between a CUDA event pair
    recorded on the launch's stream around each launch: the kernel's
    time, plus the launch call's own latency where the stream sat idle
    while the host launched (a profiler trace's kernel spans hold the
    kernel alone). No launch waits for its events: pending pairs are
    polled with ``Event.query()`` once ``PENDING_POOL`` of them are
    queued, and the rest are read at ``snapshot()``, after one
    synchronize a device;
  * ``achieved_flops_per_s`` / ``achieved_bytes_per_s``: the counts
    over ``device_s``, not over the dispatch wall (a launch returns
    before its kernel ends), and their shares of the card's peaks
    (``PEAKS``, by ``torch.cuda.get_device_name``). On the CPU, or on a
    card the table does not name, they are null.

The ``hbm`` high-water is the caching allocator's peak
(``torch.cuda.memory_stats``' ``allocated_bytes.all.peak``, reset at
``reset()``), sampled at launches and at the engine's stage boundaries
(``sample_memory``); null on the CPU.

``GALAH_OBS_PROFILE=0`` makes ``launch`` a pass-through: the kernel
still launches, only the accounting is skipped. No failure here ever
moves a launch to its plain version.

Importing this module imports no torch: the ``report``, ``perf``,
``flow`` and ``top`` subcommands stay torch-free, and torch is reached
through ``sys.modules`` by code that runs only where a kernel ran.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Deque, Dict, Iterator, Optional, Tuple

#: the card's name -> (peak 32-bit operations/s, peak bytes/s): the
#: float32 rate outside the tensor cores and the HBM rate of NVIDIA's
#: H100 SXM data sheet, at its 700 W limit (the figures of PERF.md's
#: bounds). Any other card, and the CPU, has no entry: nulls.
PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}

#: event pairs an entry queues before it polls the oldest with
#: ``Event.query()`` (never a synchronize)
PENDING_POOL = 64

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer). Each
# entry's counters live under the entry's own lock; the allocator
# high-water under _LOCK; the entry registry under _REGISTRY_LOCK.
# None of them nest (a caller copies the registry, releases its lock,
# then takes each entry's); the declared order says which way the
# nesting must go if that ever changes.
GUARDED_BY = {
    "ProfiledFunction.calls": "ProfiledFunction._lock",
    "ProfiledFunction.plain_calls": "ProfiledFunction._lock",
    "ProfiledFunction.signatures": "ProfiledFunction._lock",
    "ProfiledFunction.dispatch_wall_s": "ProfiledFunction._lock",
    "ProfiledFunction.compile_wall_s": "ProfiledFunction._lock",
    "ProfiledFunction.flops_total": "ProfiledFunction._lock",
    "ProfiledFunction.bytes_total": "ProfiledFunction._lock",
    "ProfiledFunction.device_s": "ProfiledFunction._lock",
    "ProfiledFunction._pending": "ProfiledFunction._lock",
    "ProfiledFunction._deferred": "ProfiledFunction._lock",
    "ProfiledFunction._devices": "ProfiledFunction._lock",
    "_REGISTRY": "_REGISTRY_LOCK",
    "_HBM": "_LOCK",
}
LOCK_ORDER = ["_REGISTRY_LOCK", "ProfiledFunction._lock", "_LOCK"]

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "ProfiledFunction"] = {}

_LOCK = threading.Lock()
#: the run's allocator high-water: global peak and one peak per stage
#: label handed to sample_memory()
_HBM: Dict[str, Any] = {"peak_bytes": None, "source": None,
                        "per_stage": {}}

Cost = Tuple[Any, Any]  # (bytes, operations): numbers or 0-d tensors


def enabled() -> bool:
    """The GALAH_OBS_PROFILE gate (default on; '0'/'false' disables)."""
    from galah_tpu_torch.config import env_value

    raw = (env_value("GALAH_OBS_PROFILE") or "1").strip().lower()
    return raw not in ("0", "false", "no", "off")


def _torch():
    return sys.modules.get("torch")


def on_device(device):
    """A context in which CUDA `device` is the current device: a switch
    only where it is not already (a switch costs microseconds a
    launch)."""
    torch = _torch()
    if device.index is None or device.index == torch.cuda.current_device():
        return nullcontext()
    return torch.cuda.device(device)


class ProfiledFunction:
    """The cost counters of one kernel."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Zero the counters for a new run (pending events dropped)."""
        with self._lock:
            self.calls = 0
            self.plain_calls = 0
            self.signatures: set = set()
            self.dispatch_wall_s = 0.0
            self.compile_wall_s = 0.0
            self.flops_total = 0.0
            self.bytes_total = 0.0
            self.device_s = 0.0
            self._pending: Deque[tuple] = deque()
            # device -> (2,) float64 [bytes, ops] of data-dependent
            # counts, summed on the device and read at snapshot
            self._deferred: Dict[Any, Any] = {}
            self._devices: set = set()

    # -- accounting ---------------------------------------------------

    def _add_cost(self, cost: Cost, device) -> None:
        """Add (bytes, ops), holding any device scalar on its device."""
        torch = _torch()
        host = [0.0, 0.0]
        dev = []
        for i, v in enumerate(cost):
            if torch is not None and isinstance(v, torch.Tensor):
                dev.append((i, v))
            else:
                host[i] = float(v)
        pair = None
        if dev:
            pair = torch.zeros(2, dtype=torch.float64, device=device)
            for i, v in dev:
                pair[i] = v
        with self._lock:
            self.bytes_total += host[0]
            self.flops_total += host[1]
            if pair is not None:
                prev = self._deferred.get(device)
                self._deferred[device] = (pair if prev is None
                                          else prev + pair)

    @contextmanager
    def launch(self, device, signature: tuple,
               cost: Callable[[], Cost]) -> Iterator[None]:
        """Bracket one launch of this kernel on CUDA `device`: an event
        pair on the device's current stream, the host wall of the
        launch call, its signature and `cost()` (bytes, operations).
        With profiling off, a pass-through. A launch that raises is not
        counted."""
        if not enabled():
            yield
            return
        torch = _torch()
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with on_device(device):
            start.record(stream)
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        with on_device(device):
            end.record(stream)
            bytes_ops = cost()
        with self._lock:
            self.calls += 1
            calls = self.calls
            self.signatures.add(signature)
            self.dispatch_wall_s += wall
            self._devices.add(device)
            self._pending.append((start, end))
            poll = len(self._pending) >= PENDING_POOL
        self._add_cost(bytes_ops, device)
        if poll:
            self._poll()
        if calls <= 4 or calls % 16 == 0:
            sample_memory(None)

    def plain_call(self, signature: tuple, cost: Callable[[], Cost]) -> None:
        """One call of the wrapper on CPU tensors (its plain version):
        counted, with its shape's bytes and operations."""
        if not enabled():
            return
        bytes_ops = cost()
        with self._lock:
            self.plain_calls += 1
            self.signatures.add(signature)
        self._add_cost(bytes_ops, None)

    def add_operations(self, ops: float) -> None:
        """Operations of a launch that the host learns after it (the
        slab fold's, from the iterations it reads back with the flags);
        nothing touches the device."""
        if not enabled():
            return
        with self._lock:
            self.flops_total += float(ops)

    def add_compile(self, seconds: float) -> None:
        with self._lock:
            self.compile_wall_s += float(seconds)

    def _poll(self) -> None:
        """Read the finished pairs at the head of the queue; stops at
        the first unfinished one."""
        with self._lock:
            while self._pending and self._pending[0][1].query():
                start, end = self._pending.popleft()
                self.device_s += start.elapsed_time(end) / 1e3

    def resolve(self) -> None:
        """Wait for this entry's devices once, then read every pending
        pair and deferred count (``snapshot`` calls it)."""
        torch = _torch()
        with self._lock:
            if torch is None or not (self._pending or self._deferred):
                return
            devices = list(self._devices)
            deferred, self._deferred = self._deferred, {}
        for device in devices:
            torch.cuda.synchronize(device)
        self._poll()
        read = [pair.tolist() for pair in deferred.values()]
        with self._lock:
            for b, f in read:
                self.bytes_total += b
                self.flops_total += f

    # -- reporting ----------------------------------------------------

    def snapshot(self, peak: Optional[Tuple[float, float]]) -> dict:
        self.resolve()
        with self._lock:
            dev_s = self.device_s if self.calls else None
            achieved_f = (self.flops_total / dev_s
                          if dev_s and self.flops_total else None)
            achieved_b = (self.bytes_total / dev_s
                          if dev_s and self.bytes_total else None)
            return {
                "calls": self.calls,
                "plain_calls": self.plain_calls,
                "signatures": len(self.signatures),
                "flops": self.flops_total or None,
                "bytes_accessed": self.bytes_total or None,
                "dispatch_wall_s": self.dispatch_wall_s,
                "compile_wall_s": self.compile_wall_s,
                "device_s": dev_s,
                "memory": {},
                "achieved_flops_per_s": achieved_f,
                "achieved_bytes_per_s": achieved_b,
                "flops_utilization": (achieved_f / peak[0]
                                      if peak and achieved_f else None),
                "bandwidth_utilization": (achieved_b / peak[1]
                                          if peak and achieved_b
                                          else None),
            }


def profiled(name: str) -> ProfiledFunction:
    """The registered cost entry of kernel `name` (made on first use)."""
    with _REGISTRY_LOCK:
        pf = _REGISTRY.get(name)
        if pf is None:
            pf = _REGISTRY[name] = ProfiledFunction(name)
        return pf


# ---------------------------------------------------------------------------
# Allocator high-water
# ---------------------------------------------------------------------------


def _cuda_devices() -> list:
    """The indices of the CUDA devices this process has used, or []
    when CUDA is not initialized (sampling never initializes it)."""
    torch = _torch()
    if torch is None or not torch.cuda.is_initialized():
        return []
    current = torch.cuda.current_device()
    with _REGISTRY_LOCK:
        registry = list(_REGISTRY.values())
    used = {current}
    for pf in registry:
        with pf._lock:
            used.update(current if d.index is None else d.index
                        for d in pf._devices)
    return sorted(used)


def sample_memory(stage: Optional[str] = None) -> Optional[int]:
    """Record the caching allocator's peak of allocated bytes since the
    run began, summed over the CUDA devices used, into the global and
    (with a `stage`) the per-stage high-water. Returns the bytes, or
    None on the CPU. Never raises."""
    try:
        devices = _cuda_devices()
        if not devices:
            return None
        torch = _torch()
        current = sum(int(torch.cuda.memory_stats(d).get(
            "allocated_bytes.all.peak", 0)) for d in devices)
    except Exception:
        return None
    with _LOCK:
        if _HBM["peak_bytes"] is None or current > _HBM["peak_bytes"]:
            _HBM["peak_bytes"] = current
            _HBM["source"] = "memory_stats"
        if stage is not None:
            prev = _HBM["per_stage"].get(stage)
            if prev is None or current > prev:
                _HBM["per_stage"][stage] = current
    return current


# ---------------------------------------------------------------------------
# Peaks and snapshot
# ---------------------------------------------------------------------------


def device_peaks(device=None) -> dict:
    """The roofline entry of the run's `device` (a ``torch.device``):
    its kind and (peak operations/s, peak bytes/s) from ``PEAKS``;
    nulls for an unnamed card, "cpu" and nulls on the CPU, all nulls
    when the run made no device."""
    out = {"device_kind": None, "peak_flops_per_s": None,
           "peak_bytes_per_s": None}
    torch = _torch()
    if torch is None or device is None:
        return out
    if device.type == "cpu":
        out["device_kind"] = "cpu"
        return out
    if not torch.cuda.is_initialized():
        return out
    try:
        kind = torch.cuda.get_device_name(device)
    except Exception:
        return out
    out["device_kind"] = kind
    peak = PEAKS.get(kind)
    if peak is not None:
        out["peak_flops_per_s"], out["peak_bytes_per_s"] = peak
    return out


def snapshot(device=None) -> dict:
    """The ``device_costs`` section of run_report.json for a run on
    `device`: every entry called this run, the high-water, the peaks,
    and the nvcc seconds of the run."""
    peaks = device_peaks(device)
    peak = (None if peaks["peak_flops_per_s"] is None
            else (peaks["peak_flops_per_s"], peaks["peak_bytes_per_s"]))
    with _REGISTRY_LOCK:
        registry = sorted(_REGISTRY.values(), key=lambda pf: pf.name)
    entries = {pf.name: pf.snapshot(peak) for pf in registry
               if pf.calls or pf.plain_calls or pf.compile_wall_s}
    sample_memory(None)
    with _LOCK:
        hbm = {"peak_bytes": _HBM["peak_bytes"],
               "source": _HBM["source"],
               "per_stage": dict(_HBM["per_stage"])}
    return {
        "profiling_enabled": enabled(),
        "entries": entries,
        "hbm": hbm,
        "peaks": peaks,
        "compile": {"nvcc_s": sum(e["compile_wall_s"]
                                  for e in entries.values())},
    }


def reset() -> None:
    """Per-run reset (``obs.reset_run``): every entry's counters, the
    high-water marks and the allocator's peak statistics."""
    devices = _cuda_devices()
    with _REGISTRY_LOCK:
        registry = list(_REGISTRY.values())
    for pf in registry:
        pf.reset()
    with _LOCK:
        _HBM["peak_bytes"] = None
        _HBM["source"] = None
        _HBM["per_stage"] = {}
    torch = _torch()
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
