"""Cooperative preemption: stop at a safe boundary, resume later. The
port's copy of ``galah_tpu/resilience/interrupt.py``.

A preemptible GPU VM gets SIGTERM with a short grace window; an
operator sends SIGINT.

* ``install()`` registers SIGTERM and SIGINT handlers. The first signal
  only records itself and sets the stop flag; a second means "now":
  the process runs the flush hooks (``register_flush``; the heartbeat's
  last beat) and exits with ``EXIT_PREEMPTED`` at once. Every
  checkpoint write is durable when it returns.
* The engine calls ``check(boundary)`` right after the state of
  `boundary` reached the disk; with a stop pending it raises
  ``PreemptionRequested``. The CLI records the interruption in the
  checkpoint and exits with ``EXIT_PREEMPTED`` (75, EX_TEMPFAIL:
  "transient, run me again").
* ``note_resume`` records that this run continues an interrupted one;
  ``snapshot`` reports the state.

The CLI installs the handlers only for the length of a ``cluster`` run,
so a library caller keeps its own. CPython runs signal handlers on the
main thread; other threads only read the stop flag, a
``threading.Event``.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: EX_TEMPFAIL: "preempted, safe to run again"
EXIT_PREEMPTED = 75

_HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionRequested(Exception):
    """Raised at a safe boundary after a stop was requested; names the
    boundary and the signal."""

    def __init__(self, boundary: str, signame: str) -> None:
        super().__init__(f"preemption requested ({signame}), stopping at "
                         f"safe boundary {boundary!r}")
        self.boundary = boundary
        self.signame = signame


_STOP = threading.Event()
_SIGNALS: List[str] = []      # arrival order, main thread only
_BOUNDARY: Optional[str] = None
_RESUMED_FROM: Optional[str] = None
_PRIOR_INTERRUPTIONS = 0
_PREV_HANDLERS: Dict[int, Any] = {}
# last-gasp hooks of the second-signal exit (the first signal's path
# drains through obs.finalize instead); each is bounded and lock-light,
# and its failure is ignored here
_FLUSH_HOOKS: List[Any] = []


def register_flush(fn) -> None:
    """Register a callable run right before the second-signal hard
    exit (idempotent per callable)."""
    if fn not in _FLUSH_HOOKS:
        _FLUSH_HOOKS.append(fn)


def _handler(signum, frame) -> None:
    signame = signal.Signals(signum).name
    if _STOP.is_set():
        logger.error("second signal %s: exiting immediately (%d)",
                     signame, EXIT_PREEMPTED)
        for fn in list(_FLUSH_HOOKS):
            try:
                fn()
            except Exception:
                logger.debug("flush hook failed", exc_info=True)
        os._exit(EXIT_PREEMPTED)
    _SIGNALS.append(signame)
    _STOP.set()
    logger.warning("%s received: will stop at the next safe boundary "
                   "(send again to exit immediately)", signame)


def install() -> None:
    """Register the handlers (idempotent). Only the main thread can set
    handlers; from any other thread this does nothing and says so."""
    if threading.current_thread() is not threading.main_thread():
        logger.warning("not on the main thread: SIGTERM/SIGINT keep "
                       "their handlers, so a stop can only be requested "
                       "through interrupt.request_stop()")
        return
    for sig in _HANDLED_SIGNALS:
        prev = signal.signal(sig, _handler)
        if sig not in _PREV_HANDLERS:
            _PREV_HANDLERS[sig] = prev


def uninstall() -> None:
    """Restore the handlers that ``install`` displaced."""
    for sig, prev in _PREV_HANDLERS.items():
        signal.signal(sig, prev)
    _PREV_HANDLERS.clear()


def reset() -> None:
    """Clear the interruption state (between runs, and in tests)."""
    global _BOUNDARY, _RESUMED_FROM, _PRIOR_INTERRUPTIONS
    _STOP.clear()
    _SIGNALS.clear()
    _BOUNDARY = None
    _RESUMED_FROM = None
    _PRIOR_INTERRUPTIONS = 0


def request_stop(signame: str = "REQUESTED") -> None:
    """Request a stop without a signal."""
    _SIGNALS.append(signame)
    _STOP.set()


def check(boundary: str) -> None:
    """Honour a pending stop: called right after the state that makes
    `boundary` safe has reached the disk."""
    global _BOUNDARY
    if not _STOP.is_set():
        return
    if _BOUNDARY is None:
        _BOUNDARY = boundary
    raise PreemptionRequested(boundary,
                              _SIGNALS[-1] if _SIGNALS else "REQUESTED")


def note_resume(resumed_from: str, prior_interruptions: int) -> None:
    """Record that this run continues an interrupted one."""
    global _RESUMED_FROM, _PRIOR_INTERRUPTIONS
    _RESUMED_FROM = resumed_from
    _PRIOR_INTERRUPTIONS = prior_interruptions
    logger.info("resuming from %s (%d prior interruption(s))",
                resumed_from, prior_interruptions)


def snapshot() -> Dict[str, Any]:
    """The interruption state, as ``galah_tpu``'s run report holds it."""
    return {
        "stop_requested": _STOP.is_set(),
        "signals": list(_SIGNALS),
        "boundary": _BOUNDARY,
        "resumed_from": _RESUMED_FROM,
        "prior_interruptions": _PRIOR_INTERRUPTIONS,
    }
