"""Periodic liveness heartbeat: ``heartbeat.jsonl`` beside the report.
The port's copy of ``galah_tpu/obs/heartbeat.py``.

A daemon thread samples the metrics registry every
``GALAH_OBS_HEARTBEAT_S`` seconds (default 0 = off) and durably
appends one crc-framed record (``io/atomic.append_jsonl``, the
torn-tail-tolerant framing of the checkpoints) per beat:

    {"beat": n, "ts": ..., "uptime_s": ..., "occupancy": {stage: v},
     "gauges": {...}, "counters": {...}, "queue_depths": {},
     "flow_items": {}, "rss_mb": ...}

``queue_depths`` and ``flow_items`` stay empty: the port has no flow
tracing (``galah_tpu/obs/flow.py``) yet. The thread reads only the
registry and ``/proc`` RSS, never the device.

A run whose heartbeat file stops advancing is wedged (``galah_tpu``'s
fleet scheduler preempts a shard on that), and a SIGKILL mid-write
costs exactly one torn record, skipped on read. The in-process side
keeps bounded occupancy and RSS accumulators for the run report. The
CLI starts the thread next to the run-report sink, and
``obs.finalize`` (plus the crash hooks, ``obs.install_crash_hooks``)
stops it with a final beat, so an interrupted run still carries a last
snapshot.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Dict, Optional

from galah_tpu_torch.config import env_value

logger = logging.getLogger(__name__)

HEARTBEAT_FILENAME = "heartbeat.jsonl"

_SHARD_DIR_RE = re.compile(r"shard_(\d+)$")

# workload.pipeline_occupancy[<stage>] gauges (obs/metrics.py); the
# unlabelled gauge is the whole-pipeline value
OCC_RE = re.compile(r"^workload\.pipeline_occupancy(?:\[(.*)\])?$")


def _infer_role_shard(directory: str) -> tuple:
    """(role, shard) stamps for beats written into ``directory``.

    A fleet worker subprocess carries the scheduler's
    GALAH_TPU_FLEET_WORKER env stamp and writes its heartbeat inside
    ``shards/shard_NNN/`` — both are recoverable here without any new
    plumbing. Single-process runs get (None, None): beats stay
    unstamped, and old logs read clean."""
    role = "worker" if env_value("GALAH_TPU_FLEET_WORKER") else None
    shard = None
    m = _SHARD_DIR_RE.search(os.path.abspath(directory or "."))
    if m:
        shard = int(m.group(1))
    return role, shard


def _rss_mb() -> Optional[float]:
    """Resident set size in MB from /proc/self/status (stdlib-only;
    None on platforms without procfs)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        pass
    return None

# A Heartbeat's _lock guards its _beats, _occ, _rss and _final_done.
# The module global GLOBAL is unguarded by the same lifecycle argument
# as trace.RECORDER: start()/stop() run in the single-threaded CLI
# lifecycle; the beat thread only ever touches its own instance.


class Heartbeat:
    """One run's heartbeat writer thread."""

    def __init__(self, directory: str, period_s: float,
                 role: Optional[str] = None) -> None:
        os.makedirs(directory or ".", exist_ok=True)
        self.path = os.path.join(directory or ".", HEARTBEAT_FILENAME)
        self.period_s = max(0.05, float(period_s))
        # role/shard stamps (set once here, read-only afterwards):
        # explicit role wins (the fleet scheduler passes "scheduler");
        # otherwise inferred from the worker env stamp + shard dir
        inferred_role, self.shard = _infer_role_shard(directory)
        self.role = role or inferred_role
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._t0 = time.monotonic()
        self._beats = 0
        # stage -> [min, sum, count, last] occupancy accumulator
        self._occ: Dict[str, list] = {}
        # [min, sum, count, peak] rss_mb accumulator: the run report
        # summarizes the whole beat series, not just the final sample
        self._rss: Optional[list] = None
        self._final_done = False
        # sampler thread: only reads the registry (behind its own lock)
        self._thread = threading.Thread(
            target=self._run, name="galah-heartbeat", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.period_s):
            try:
                self.beat()
            except Exception:  # telemetry never takes down the run
                logger.debug("heartbeat beat failed", exc_info=True)

    def _gather(self) -> dict:
        """Sample the registry, outside self._lock (the registry takes
        its own lock)."""
        from galah_tpu_torch.obs import metrics as obs_metrics

        gauges: Dict[str, float] = {}
        counters: Dict[str, float] = {}
        occupancy: Dict[str, float] = {}
        for name, m in obs_metrics.snapshot().items():
            kind = m.get("kind")
            if kind == "counter":
                counters[name] = m.get("value")
            elif kind == "gauge":
                v = m.get("value")
                if isinstance(v, (int, float)):
                    gauges[name] = v
                    match = OCC_RE.match(name)
                    if match:
                        occupancy[match.group(1) or "pipeline"] = v
        rec = {
            "ts": time.time(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "occupancy": occupancy,
            "gauges": gauges,
            "counters": counters,
            "queue_depths": {},
            "flow_items": {},
        }
        if self.role is not None:
            rec["role"] = self.role
        if self.shard is not None:
            rec["shard"] = self.shard
        rss = _rss_mb()
        if rss is not None:
            rec["rss_mb"] = rss
        return rec

    def beat(self) -> None:
        """Sample + durably append one record (also the final-flush
        entry point: crash hooks call this directly)."""
        from galah_tpu_torch.io import atomic

        rec = self._gather()
        with self._lock:
            self._beats += 1
            rec["beat"] = self._beats
            for stage, v in rec["occupancy"].items():
                acc = self._occ.get(stage)
                if acc is None:
                    self._occ[stage] = [v, v, 1, v]
                else:
                    acc[0] = min(acc[0], v)
                    acc[1] += v
                    acc[2] += 1
                    acc[3] = v
            rss = rec.get("rss_mb")
            if isinstance(rss, (int, float)):
                if self._rss is None:
                    self._rss = [rss, rss, 1, rss]
                else:
                    self._rss[0] = min(self._rss[0], rss)
                    self._rss[1] += rss
                    self._rss[2] += 1
                    self._rss[3] = max(self._rss[3], rss)
        atomic.append_jsonl(self.path, rec,
                            site="io.atomic.append[heartbeat]")

    def stop(self, flush: bool = True, join_timeout: float = 5.0) -> None:
        """Stop the thread; with ``flush`` write one final beat (once,
        however many of finalize/atexit/excepthook call us)."""
        self._stop_evt.set()
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=join_timeout)
        if not flush:
            return
        with self._lock:
            if self._final_done:
                return
            self._final_done = True
        try:
            self.beat()
        except Exception:
            logger.debug("final heartbeat failed", exc_info=True)

    def snapshot(self) -> dict:
        """Bounded summary for the run report's flow section."""
        with self._lock:
            series = {
                stage: {"min": round(acc[0], 4),
                        "mean": round(acc[1] / acc[2], 4),
                        "last": round(acc[3], 4),
                        "samples": acc[2]}
                for stage, acc in sorted(self._occ.items())
            }
            beats = self._beats
            rss = None
            if self._rss is not None:
                rss = {"min_mb": round(self._rss[0], 1),
                       "mean_mb": round(self._rss[1] / self._rss[2], 1),
                       "peak_mb": round(self._rss[3], 1),
                       "samples": self._rss[2]}
        out = {"period_s": self.period_s, "beats": beats,
               "path": self.path, "occupancy_series": series}
        if rss is not None:
            out["rss_series"] = rss
        return out


# The active heartbeat, None when GALAH_OBS_HEARTBEAT_S is unset/0.
GLOBAL: Optional[Heartbeat] = None


def start(directory: str, period_s: float,
          role: Optional[str] = None) -> Heartbeat:
    global GLOBAL
    if GLOBAL is not None:
        GLOBAL.stop(flush=False)
    GLOBAL = Heartbeat(directory, period_s, role=role)
    GLOBAL.start()
    logger.info("Heartbeat every %.3gs -> %s", GLOBAL.period_s,
                GLOBAL.path)
    return GLOBAL


def maybe_start(report_path: Optional[str],
                role: Optional[str] = None) -> Optional[Heartbeat]:
    """CLI lifecycle hook: start next to the run-report sink when
    GALAH_OBS_HEARTBEAT_S > 0 (the flag's default keeps it off)."""
    try:
        period = float(env_value("GALAH_OBS_HEARTBEAT_S") or 0.0)
    except (TypeError, ValueError):
        logger.warning("GALAH_OBS_HEARTBEAT_S is not a number; "
                       "heartbeat disabled")
        return None
    if period <= 0:
        return None
    directory = os.path.dirname(report_path) if report_path else "."
    return start(directory or ".", period, role=role)


def stop(flush: bool = True) -> None:
    hb = GLOBAL
    if hb is not None:
        hb.stop(flush=flush)


def flush() -> None:
    """One immediate beat (signal-path flush: no join, no teardown)."""
    hb = GLOBAL
    if hb is not None:
        try:
            hb.beat()
        except Exception:
            logger.debug("heartbeat flush failed", exc_info=True)


def active() -> bool:
    return GLOBAL is not None


def snapshot() -> Optional[dict]:
    hb = GLOBAL
    return None if hb is None else hb.snapshot()


def reset() -> None:
    """Drop the active heartbeat without a final beat (tests/run
    start); the thread is stopped first."""
    global GLOBAL
    if GLOBAL is not None:
        GLOBAL.stop(flush=False)
    GLOBAL = None


def load(directory: str):
    """(records, torn_count) of a run dir's heartbeat.jsonl: the
    torn-tail-tolerant read."""
    from galah_tpu_torch.io import atomic
    path = directory
    if os.path.isdir(directory):
        path = os.path.join(directory, HEARTBEAT_FILENAME)
    return atomic.read_jsonl(path)


def read_latest_beat(path: str) -> Optional[dict]:
    """Newest beat record of a run dir's (or file's) heartbeat.jsonl,
    or None: tolerates missing files and torn tails, never raises.
    ``galah_tpu``'s fleet scheduler probes liveness through this."""
    try:
        records, _torn = load(path)
    except Exception:
        logger.debug("heartbeat read failed: %s", path, exc_info=True)
        return None
    return records[-1] if records else None
