"""The durable write: the port's copy of ``galah_tpu/io/atomic.py``.

* Whole-file artifacts (``write_bytes``, ``write_text``,
  ``write_json``, ``write_npz``): a unique ``.tmp`` in the target's own
  directory, written, fsynced, renamed over the target with
  ``os.replace``, and the directory fsynced, so a reader sees the old
  content or the new, never a torn mix, and the rename itself survives
  a host crash.
* Append-only JSONL logs (``append_jsonl``): one ``O_APPEND`` write a
  record, framed as ``<compact-json>\\t<crc32hex>\\n`` and fsynced;
  ``read_jsonl`` checks each crc, skips torn or corrupt lines and reads
  legacy unframed lines as plain JSON; ``append_jsonl`` ends a torn
  tail with a newline first, so one crash never spoils the next record.
  The bytes are ``galah_tpu``'s, so either package reads the other's
  logs.
* ``sweep_tmp`` removes the ``.tmp`` files a killed writer left behind;
  in a directory that concurrent runs share, only those older than
  ``SHARED_TMP_MAX_AGE_S``.

Filesystem faults from ``GALAH_FI`` (``resilience/faults.py``: kinds
``enospc``, ``eio``, ``torn-write``, ``slow-io`` and ``kill``) fire
inside these primitives, at the named ``io.atomic.*`` sites.
"""

from __future__ import annotations

import errno
import io
import json
import logging
import os
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: separator between a record's JSON and its crc32: a compact JSON
#: payload never holds a raw tab, so the last tab of a line splits it
FRAME_SEP = "\t"

#: age gate of ``sweep_tmp`` in shared directories (the sketch cache): a
#: younger ``.tmp`` may belong to a live concurrent writer
SHARED_TMP_MAX_AGE_S = 3600.0


def _fs_fault(site: str) -> Optional[str]:
    """Consult the ``GALAH_FI`` injector at `site`: ``enospc``/``eio``
    raise here, ``kill`` never returns, ``slow-io`` sleeps, and
    ``torn-write`` is returned for the writer to tear its own write."""
    from galah_tpu_torch.resilience import faults

    inj = faults.get_injector()
    if inj is None:
        return None
    return inj.filesystem(site)


def _site(default_kind: str, path: str, site: Optional[str]) -> str:
    return site or f"io.atomic.{default_kind}[{os.path.basename(path)}]"


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


def _write_all(fd: int, data) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def write_bytes(path: str, data: bytes, site: Optional[str] = None) -> None:
    """Atomically and durably replace `path` with `data`. On failure the
    error propagates, the tmp file is removed (an injected torn write
    leaves its half-written tmp for ``sweep_tmp``) and `path` is
    untouched."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    action = _fs_fault(_site("write", path, site))
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        try:
            if action == "torn-write":
                # a crash mid-write: half the payload reaches the tmp,
                # no cleanup runs, and the caller sees the write fail
                _write_all(fd, memoryview(data)[:len(data) // 2])
                raise OSError(errno.EIO, f"injected torn write ({tmp})")
            _write_all(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except OSError:
        if action != "torn-write":
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    fsync_dir(parent)


def write_text(path: str, text: str, site: Optional[str] = None) -> None:
    write_bytes(path, text.encode("utf-8"), site=site)


def write_json(path: str, obj: Any, indent: Optional[int] = None,
               site: Optional[str] = None) -> None:
    write_bytes(path, (json.dumps(obj, indent=indent, sort_keys=True)
                       + "\n").encode("utf-8"), site=site)


def write_npz(path: str, arrays: Dict[str, np.ndarray],
              site: Optional[str] = None) -> None:
    """An ``.npz`` built in memory, then one durable write: a killed
    writer never leaves a half-written entry under the final name."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    write_bytes(path, buf.getbuffer(), site=site)


def frame_line(obj: Any) -> str:
    """One framed record: compact JSON, FRAME_SEP, crc32, newline."""
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    if "\n" in payload:
        raise ValueError("JSONL records must serialize to one line")
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{payload}{FRAME_SEP}{crc:08x}\n"


def append_jsonl(path: str, obj: Any, site: Optional[str] = None) -> None:
    """Durably append one framed record in a single ``write``. A torn
    tail (no final newline: the last writer died mid-append) is ended
    first, so its bytes stay on their own line, which the crc
    rejects."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    action = _fs_fault(_site("append", path, site))
    data = frame_line(obj).encode("utf-8")
    # read-write, not write-only: the torn-tail probe reads the last byte
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        size = os.fstat(fd).st_size
        if size and os.pread(fd, 1, size - 1) != b"\n":
            data = b"\n" + data
        if action == "torn-write":
            os.write(fd, data[:max(1, len(data) // 2)])
            raise OSError(errno.EIO, f"injected torn append ({path})")
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)


def read_jsonl(path: str) -> Tuple[List[Any], int]:
    """The intact records of `path` in file order, and the count of
    torn or corrupt lines skipped. A missing file is an empty log; no
    content makes it raise."""
    if not os.path.exists(path):
        return [], 0
    records: List[Any] = []
    bad = 0
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            # newlines only: a write torn just after the separator must
            # still look framed (and fail its crc)
            line = line.rstrip("\r\n")
            if not line.strip():
                continue
            if FRAME_SEP in line:
                payload, _, crc_hex = line.rpartition(FRAME_SEP)
                try:
                    want = int(crc_hex, 16)
                except ValueError:
                    bad += 1
                    continue
                if zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF != want:
                    bad += 1
                    continue
                line = payload
            try:
                records.append(json.loads(line))
            except ValueError:
                bad += 1
    return records, bad


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
