"""Warn once a process: the port's copy of ``galah_tpu/obs/events.py``'s
``warn_once`` and ``reset_warn_once``.

A warning whose repetition says nothing new (the missing-CheckM notice
of every clusterer an embedding tool builds) is logged the first time
its dedupe key is seen and only counted after that. The key is
process-scoped: ``key`` when the caller gives one, else the logger's
name and the message. The port has no run report yet, so a suppressed
repeat is counted in ``SUPPRESSED`` (per dedupe key) instead of being
recorded as an event.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Optional, Set, Tuple

_LOCK = threading.Lock()
_WARNED: Set[Tuple[str, str]] = set()

#: suppressed repeats per dedupe key, since the last reset
SUPPRESSED: "collections.Counter[Tuple[str, str]]" = collections.Counter()


def warn_once(logger: logging.Logger, msg: str, *args,
              key: Optional[str] = None) -> None:
    """Log `msg` at WARNING the first time its dedupe key is seen in
    this process; count each later call in ``SUPPRESSED``."""
    dedupe = (key or logger.name, key or msg)
    with _LOCK:
        first = dedupe not in _WARNED
        if first:
            _WARNED.add(dedupe)
        else:
            SUPPRESSED[dedupe] += 1
    if first:
        logger.warning(msg, *args)


def reset_warn_once() -> None:
    """Forget the warnings emitted and the repeats counted (tests)."""
    with _LOCK:
        _WARNED.clear()
        SUPPRESSED.clear()
