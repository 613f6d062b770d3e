"""Chrome-trace-format span/event recorder (``--trace-events PATH``):
the port's copy of ``galah_tpu/obs/trace.py``.

Writes one JSON trace event per line in the Chrome Trace Event "JSON
array" dialect: the file opens with ``[`` and every event line ends
with a comma. Chrome's trace viewer and Perfetto both accept the
unterminated form, and ``close()`` appends a terminator so the artifact
is also plain valid JSON. The recorder is append-only and flushed per
event: a crashed run still leaves a loadable trace up to the crash.

What lands in the trace:
  * every ``timing.StageClock`` stage as a complete ("ph": "X") event,
    named by stage, category "stage", emitted after the stage's device
    synchronize so the span covers the device work it queued; the
    reading seconds of the read-ahead threads (``StageClock.timed``)
    as "X" events of category "work" on their own thread ids;
  * each ``nvcc`` build of a kernel (``kernels/build.py``) as an "X"
    event of category "nvcc" (``galah_tpu`` records its JAX compile
    events here);
  * structured events (quarantines, preemptions, resumes:
    ``obs/events.py``) as instant ("ph": "i") events;
  * flow events ("ph": "s"/"t"/"f") through ``emit_flow``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

# A TraceRecorder's _lock guards its _fh and _closed. The module
# global RECORDER is deliberately not guarded: start()/stop() run in the
# single-threaded CLI lifecycle, and the emit_* helpers take a local
# snapshot (`rec = RECORDER`) so a concurrent stop() cannot null the
# reference mid-emit.


class TraceRecorder:
    """Streaming Chrome-trace writer; all emission is lock-serialized."""

    def __init__(self, path: str) -> None:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "w")
        self._fh.write("[\n")
        self._pid = os.getpid()
        # all timestamps are microseconds since recorder start, on the
        # clock StageClock uses (perf_counter)
        self._t0 = time.perf_counter()
        self._closed = False
        self._emit({"ph": "M", "name": "process_name", "pid": self._pid,
                    "tid": 0,
                    "args": {"name": "galah_tpu_torch host pipeline"}})

    def _emit(self, event: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._fh.write(json.dumps(event, sort_keys=True) + ",\n")
            self._fh.flush()

    def _ts(self, perf_t: float) -> float:
        return max(0.0, (perf_t - self._t0) * 1e6)

    def complete(self, name: str, start: float, duration: float,
                 cat: str = "stage", args: Optional[dict] = None) -> None:
        """A finished span: `start` is its time.perf_counter() value."""
        ev = {"ph": "X", "name": name, "cat": cat, "pid": self._pid,
              "tid": threading.get_ident() & 0xFFFFFFFF,
              "ts": round(self._ts(start), 3),
              "dur": round(duration * 1e6, 3)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "s": "p", "name": name, "cat": cat,
              "pid": self._pid,
              "tid": threading.get_ident() & 0xFFFFFFFF,
              "ts": round(self._ts(time.perf_counter()), 3)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def flow(self, ph: str, name: str, flow_id: int,
             cat: str = "flow") -> None:
        """A Chrome flow event: ``ph`` is "s" (start), "t" (step) or
        "f" (finish). Events sharing (cat, id, name) are drawn as one
        arrow chain across threads."""
        ev = {"ph": ph, "name": name, "cat": cat, "id": int(flow_id),
              "pid": self._pid,
              "tid": threading.get_ident() & 0xFFFFFFFF,
              "ts": round(self._ts(time.perf_counter()), 3)}
        if ph == "f":
            # bind to the enclosing slice's end, so the arrow lands on
            # the consuming span rather than the next unrelated one
            ev["bp"] = "e"
        self._emit(ev)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # terminate the array so the file is also plain valid JSON
            self._fh.write("{}\n]\n")
            self._fh.close()


# The active recorder, None when --trace-events was not given. The
# emit_* helpers below are the no-op-when-inactive forms every call
# site uses (timing.py, obs/events.py, kernels/build.py).
RECORDER: Optional[TraceRecorder] = None


def start(path: str) -> TraceRecorder:
    """Open the trace file and route all emission to it."""
    global RECORDER
    if RECORDER is not None:
        RECORDER.close()
    RECORDER = TraceRecorder(path)
    logger.info("Writing Chrome-trace events to %s (load in Perfetto)",
                path)
    return RECORDER


def stop() -> None:
    global RECORDER
    if RECORDER is not None:
        RECORDER.close()
        RECORDER = None


def active() -> bool:
    return RECORDER is not None


def emit_complete(name: str, start_t: float, duration: float,
                  cat: str = "stage",
                  args: Optional[dict] = None) -> None:
    rec = RECORDER
    if rec is not None:
        rec.complete(name, start_t, duration, cat=cat, args=args)


def emit_instant(name: str, cat: str = "event",
                 args: Optional[dict] = None) -> None:
    rec = RECORDER
    if rec is not None:
        rec.instant(name, cat=cat, args=args)


def emit_flow(ph: str, name: str, flow_id: int,
              cat: str = "flow") -> None:
    rec = RECORDER
    if rec is not None:
        rec.flow(ph, name, flow_id, cat=cat)
