"""The persistent sketch/profile cache: the port of
``galah_tpu/io/diskcache.py``, entry for entry.

An entry is one ``.npz`` file named ``<kind>-<digest>.npz``, where the
digest is the first 32 hex digits of a SHA-256 over the genome's
absolute path, size, ``mtime_ns``, the kind and the sorted params, so
touching or replacing a FASTA file invalidates its entries. Its arrays
are those ``galah_tpu`` stores (hashes as plain uint64) plus a
``__check__`` crc32 over every array's name, dtype, shape and bytes. A
cache directory written by either package is read by the other.

Writes go through ``io/atomic.py``. An entry that cannot be read, or
whose checksum does not match, is dropped and counted as a miss, and
the caller recomputes and stores it again: a corrupt cache costs time,
never a wrong sketch. Opening a cache sweeps ``.tmp`` debris older than
``atomic.SHARED_TMP_MAX_AGE_S`` (a younger one may be a live writer's).
``CacheDir(None)`` is the disabled cache, so callers keep one path.

Counts go to the run's ``StageClock``: ``cache-hits``,
``cache-misses``, ``cache-repaired``, ``cache-bytes-read`` and
``cache-bytes-written``. The cache is enabled by ``--sketch-cache DIR``
or the ``GALAH_TPU_CACHE`` environment variable.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import zlib
from typing import Dict, Optional

import numpy as np

from galah_tpu_torch.config import env_value
from galah_tpu_torch.io import atomic
from galah_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

#: the environment variable that names the cache directory when no
#: --sketch-cache is given
CACHE_ENV = "GALAH_TPU_CACHE"

#: reserved entry member holding the content crc32 of the other arrays
_CHECK_KEY = "__check__"


def _content_crc(arrays: Dict[str, np.ndarray]) -> int:
    """crc32 over the name, dtype, shape and bytes of every array."""
    crc = 0
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        for part in (name, str(a.dtype), str(a.shape)):
            crc = zlib.crc32(part.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def entry_digest(genome_path: str, kind: str, params: dict) -> str:
    """The 32 hex digits that name a genome's entry of `kind`; the
    persistent index keys its genome records by the same digest."""
    st = os.stat(genome_path)
    ident = json.dumps({
        "path": os.path.abspath(genome_path),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "kind": kind,
        "params": {k: params[k] for k in sorted(params)},
    }, sort_keys=True)
    return hashlib.sha256(ident.encode()).hexdigest()[:32]


def default_cache_dir() -> Optional[str]:
    """The cache directory named by ``GALAH_TPU_CACHE``, or None (an
    unset or empty variable disables the cache)."""
    return env_value(CACHE_ENV) or None


#: clock count -> (metric, help, unit) of galah_tpu's cache metrics
_METRICS = {
    "cache-hits": ("cache.hits",
                   "Sketch/profile cache entries reused from disk", ""),
    "cache-misses": ("cache.misses",
                     "Sketch/profile cache lookups that recomputed", ""),
    "cache-repaired": ("cache.repaired",
                       "Corrupt cache entries dropped for recompute", ""),
    "cache-bytes-read": ("cache.bytes_read",
                         "Bytes of cache entries read back from disk",
                         "bytes"),
    "cache-bytes-written": ("cache.bytes_written",
                            "Bytes of cache entries committed to disk",
                            "bytes"),
}


class CacheDir:
    """A directory of ``.npz`` cache entries; ``CacheDir(None)``
    disables. `clock` (a ``timing.StageClock``) receives the counts."""

    def __init__(self, path: Optional[str], clock=None) -> None:
        self.path = path
        self.clock = clock
        if path:
            os.makedirs(path, exist_ok=True)
            atomic.sweep_tmp(path, max_age_s=atomic.SHARED_TMP_MAX_AGE_S)
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def _count(self, name: str, n: int = 1) -> None:
        if self.clock is not None:
            self.clock.count(name, n)
        # mirrored into the metrics registry under galah_tpu's names:
        # the run report's funnel reads its cache hit rate there; loads
        # may come from read-ahead threads, which the registry's lock
        # makes safe
        metric, help_text, unit = _METRICS[name]
        obs_metrics.counter(metric, help=help_text, unit=unit).inc(n)

    def entry_path(self, genome_path: str, kind: str, params: dict) -> str:
        digest = entry_digest(genome_path, kind, params)
        return os.path.join(self.path, f"{kind}-{digest}.npz")

    def load(self, genome_path: str, kind: str,
             params: dict) -> Optional[Dict[str, np.ndarray]]:
        """The entry's arrays, or None on a miss or when disabled."""
        if not self.enabled:
            return None
        entry = self.entry_path(genome_path, kind, params)
        try:
            with np.load(entry) as z:
                out = {name: z[name] for name in z.files}
        except FileNotFoundError:
            self.misses += 1
            self._count("cache-misses")
            return None
        except Exception as exc:  # truncated or unreadable: repair
            return self._repair(entry, f"unreadable ({exc})")
        check = out.pop(_CHECK_KEY, None)
        if check is not None and int(check[0]) != _content_crc(out):
            return self._repair(entry, "content checksum mismatch")
        self.hits += 1
        self._count("cache-hits")
        try:
            self._count("cache-bytes-read", os.stat(entry).st_size)
        except OSError:
            pass
        return out

    def _repair(self, entry: str, why: str) -> None:
        """Drop a corrupt entry and report a miss: the caller recomputes
        and ``store`` writes a good entry back."""
        logger.warning("Dropping corrupt cache entry %s (%s)", entry, why)
        try:
            os.unlink(entry)
        except OSError:
            pass
        self.misses += 1
        self._count("cache-misses")
        self._count("cache-repaired")
        return None

    def store(self, genome_path: str, kind: str, params: dict,
              arrays: Dict[str, np.ndarray]) -> None:
        """Write the entry; a failed write raises."""
        if not self.enabled:
            return
        if _CHECK_KEY in arrays:
            raise ValueError(f"{_CHECK_KEY!r} is reserved for the "
                             "cache's content checksum")
        entry = self.entry_path(genome_path, kind, params)
        payload = dict(arrays)
        payload[_CHECK_KEY] = np.array([_content_crc(arrays)],
                                       dtype=np.uint64)
        atomic.write_npz(entry, payload)
        try:
            self._count("cache-bytes-written", os.stat(entry).st_size)
        except OSError:
            pass

    def stats(self) -> str:
        return f"{self.hits} hits / {self.misses} misses"


_NONE = CacheDir(None)


def get_cache(path: Optional[str] = None, clock=None) -> CacheDir:
    """The cache at `path`, else at ``GALAH_TPU_CACHE``, else the
    disabled cache."""
    if path is None:
        path = default_cache_dir()
    return CacheDir(path, clock) if path else _NONE
