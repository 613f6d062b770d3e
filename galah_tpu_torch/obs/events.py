"""Structured run events and the warn-once dedupe: the port's copy of
``galah_tpu/obs/events.py``.

Every ``record(kind, **fields)`` appends one timestamped row to a
process-wide log that the run report serializes under ``"events"``
(quarantined genomes, preemptions, resumes, a fallback to input order),
and mirrors it into the Chrome trace (``obs/trace.py``) as an instant
event, so a Perfetto timeline shows it between the stage spans.

``warn_once`` logs a warning whose repetition says nothing new (the
missing-CheckM notice of every clusterer an embedding tool builds) the
first time its dedupe key is seen in the process; each later call
records a ``warn-once-suppressed`` event instead, so the report keeps
the true multiplicity.

Timestamps are wall-clock epoch seconds (the report is a cross-run
artifact; perf_counter origins do not compare across processes).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from galah_tpu_torch.obs import trace as _trace

_LOCK = threading.Lock()
_EVENTS: List[dict] = []

_WARN_ONCE_LOCK = threading.Lock()
_WARNED: Set[Tuple[str, str]] = set()

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer). The
# locks are never nested (record() is called after the warn-once lock
# is released); the declared order says which way the nesting must go
# if that ever changes.
GUARDED_BY = {
    "_EVENTS": "_LOCK",
    "_WARNED": "_WARN_ONCE_LOCK",
}
LOCK_ORDER = ["_WARN_ONCE_LOCK", "_LOCK"]


def record(kind: str, **fields) -> None:
    """Append one event row; values must be JSON-serializable."""
    row: Dict[str, object] = {"kind": kind, "time": time.time()}
    row.update(fields)
    with _LOCK:
        _EVENTS.append(row)
    _trace.emit_instant(kind, cat="event", args=fields or None)


def snapshot() -> List[dict]:
    with _LOCK:
        return [dict(r) for r in _EVENTS]


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()


def warn_once(logger: logging.Logger, msg: str, *args,
              key: Optional[str] = None) -> None:
    """Log `msg` at WARNING the first time its dedupe key is seen in
    this process, then suppress-and-record. The key is ``key`` when
    given, else the logger's name and the message; each suppressed
    repeat records a ``warn-once-suppressed`` event."""
    dedupe = (key or logger.name, key or msg)
    with _WARN_ONCE_LOCK:
        first = dedupe not in _WARNED
        if first:
            _WARNED.add(dedupe)
    if first:
        logger.warning(msg, *args)
    else:
        record("warn-once-suppressed", logger=logger.name,
               message=msg % args if args else msg)


def reset_warn_once() -> None:
    """Forget emitted warnings (tests)."""
    with _WARN_ONCE_LOCK:
        _WARNED.clear()
