"""The durable write: the port's copy of ``galah_tpu/io/atomic.py``'s
whole-file primitives.

A file is written as a unique ``.tmp`` in its own directory, fsynced,
renamed over the target with ``os.replace`` and its directory fsynced,
so a reader sees the old content or the new, never a torn mix, and the
rename itself survives a host crash. ``sweep_tmp`` removes the ``.tmp``
files a killed writer left behind; in a directory that concurrent runs
share, only those older than ``SHARED_TMP_MAX_AGE_S``.

Not ported yet: ``galah_tpu``'s filesystem fault injection
(``_fs_fault``, the ``GALAH_FI`` kinds) and the checksum-framed JSONL
log (``append_jsonl``/``read_jsonl``).
"""

from __future__ import annotations

import io
import logging
import os
import tempfile
import time
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)

#: age gate of ``sweep_tmp`` in shared directories (the sketch cache): a
#: younger ``.tmp`` may belong to a live concurrent writer
SHARED_TMP_MAX_AGE_S = 3600.0


def fsync_dir(path: str) -> None:
    """Make a completed rename in `path` durable. Best effort: some
    filesystems refuse a read-only directory descriptor; the rename is
    still atomic there, only its durability window widens."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes(path: str, data: bytes) -> None:
    """Atomically and durably replace `path` with `data`. On failure the
    error propagates, the tmp file is removed and `path` is untouched."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(parent)


def write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """An ``.npz`` built in memory, then one durable write: a killed
    writer never leaves a half-written entry under the final name."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    write_bytes(path, buf.getbuffer())


def sweep_tmp(directory: str, max_age_s: float = 0.0) -> int:
    """Remove the ``*.tmp`` files in `directory` (those at least
    `max_age_s` old when it is nonzero); returns how many went."""
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    now = time.time()  # an age gate on file mtimes, not a duration
    for name in names:
        if not name.endswith(".tmp"):
            continue
        p = os.path.join(directory, name)
        try:
            if max_age_s and now - os.stat(p).st_mtime < max_age_s:
                continue
            os.unlink(p)
            removed += 1
        except OSError:
            continue
    if removed:
        logger.info("Swept %d stale .tmp file(s) from %s", removed,
                    directory)
    return removed
