"""The out-of-core paged sketch store: the port of
``galah_tpu/io/pagestore.py``, in its page format, so a page directory
written by either package reads in the other.

Sketch rows are packed into fixed-size *pages*: flat files holding a
crc-framed JSON header line (``io/atomic.frame_line``) followed by a
raw little-endian ``uint64`` payload of ``rows x cols`` hash slots (the
unbiased hashes; rows go to biased int64, ``ops/u64.to_biased``, only
when a band's rows go up to the card). Pages are committed with the
``io/atomic.py`` discipline (tmp + fsync + rename + directory fsync),
so a reader sees a whole page or none, and the ``GALAH_FI`` sites
``io.atomic.write[pagestore.page]`` and
``io.atomic.append[pagestore.dir]`` reach the commit path.

A ``pages.jsonl`` directory file (crc-framed, a torn tail healed by
``atomic.read_jsonl``) names every committed page and the row keys it
holds. A page's record is appended only after the page file is
durable, so a committed record always names an intact page; the
payload crc in the page header is defence in depth.

Resident set
------------
Pages are mmapped on first touch and the store hands out zero-copy
``numpy`` views into the maps. An LRU list bounded by a byte budget
(``GALAH_TPU_SKETCH_RAM_MB``) decides which maps the store keeps
referenced; eviction drops the store's reference and hints the kernel
(``MADV_DONTNEED``) but never closes the map, so a view handed out
earlier stays valid. ``gather`` (``band_gather``) pins the pages of the
rows it copies for the length of the copy and returns an owned,
contiguous copy: that copy, never a mapped view, is what goes to the
card.

Concurrency: one writer a process (page names carry a per-writer
random token, so two processes sharing a directory never collide);
any number of readers. ``refresh()`` re-reads ``pages.jsonl`` to adopt
pages other writers committed.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from galah_tpu_torch import config
from galah_tpu_torch.io import atomic
from galah_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

#: Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer).
GUARDED_BY = {
    "SketchPageStore._pages": "SketchPageStore._lock",
    "SketchPageStore._order": "SketchPageStore._lock",
    "SketchPageStore._resident": "SketchPageStore._lock",
    "SketchPageStore._pins": "SketchPageStore._lock",
    "SketchPageStore._key_to_rid": "SketchPageStore._lock",
    "SketchPageStore._open_rows": "SketchPageStore._lock",
    "SketchPageStore._open_valid": "SketchPageStore._lock",
    "SketchPageStore._open_keys": "SketchPageStore._lock",
    "SketchPageStore._seq": "SketchPageStore._lock",
    "SketchPageStore._resident_bytes": "SketchPageStore._lock",
    "SketchPageStore._peak_resident_bytes": "SketchPageStore._lock",
}
# The store's lock is held while its page counters move and while a
# page commits through io/atomic.py (whose fault sites take the
# injector's locks).
LOCK_ORDER = ["SketchPageStore._lock",
              "galah_tpu_torch/obs/metrics.py:MetricsRegistry._lock",
              "galah_tpu_torch/resilience/faults.py:_LOCK",
              "galah_tpu_torch/resilience/faults.py:FaultInjector._lock"]

PAGE_MAGIC = "galah-page"
PAGE_VERSION = 1
DIR_NAME = "pages.jsonl"

#: Rows packed per page.  256 rows x 1000 u64 cols is ~2 MiB per page
#: — large enough to amortize mmap/commit overhead, small enough that
#: the two-band pin floor stays well under any sane RAM budget.
DEFAULT_PAGE_ROWS = 256

_PAGE_SITE = "io.atomic.write[pagestore.page]"
_DIR_SITE = "io.atomic.append[pagestore.dir]"


class PageStoreError(RuntimeError):
    """A page failed its integrity checks (crc/shape mismatch)."""


def ram_budget_bytes() -> int:
    """The resident-set byte budget from ``GALAH_TPU_SKETCH_RAM_MB``.

    Malformed values are logged and the registry default applies.
    """
    raw = config.env_value("GALAH_TPU_SKETCH_RAM_MB")
    try:
        mb = int(raw)  # type: ignore[arg-type]
        if mb <= 0:
            raise ValueError(raw)
    except (TypeError, ValueError):
        logger.warning("ignoring malformed GALAH_TPU_SKETCH_RAM_MB=%r", raw)
        mb = 512
    return mb * (1 << 20)


def pagestore_mode() -> str:
    """The ``GALAH_TPU_PAGESTORE`` tri-state: 'auto', '0' or '1'."""
    val = config.env_value("GALAH_TPU_PAGESTORE") or "auto"
    return val if val in ("auto", "0", "1") else "auto"


def pagestore_engaged(n_rows: int, cols: int) -> bool:
    """Whether the paged sketch path should engage for an ``n_rows`` x
    ``cols`` u64 sketch matrix.

    '1' forces it, '0' disables it, and 'auto' engages when the
    all-resident matrix would exceed half the RAM budget (leaving the
    other half for pair state and the device runtime).
    """
    mode = pagestore_mode()
    if mode == "0":
        return False
    if mode == "1":
        return n_rows >= 2
    return n_rows * cols * 8 > ram_budget_bytes() // 2


class _Page:
    """One committed page: metadata plus the (lazy) mmap view."""

    __slots__ = ("name", "rows", "cols", "row0", "keys", "valid",
                 "nbytes", "_mm", "_mat")

    def __init__(self, name: str, rows: int, cols: int, row0: int,
                 keys: Sequence[str], valid: Sequence[int]):
        self.name = name
        self.rows = rows
        self.cols = cols
        self.row0 = row0                 # global row id of this page's row 0
        self.keys = list(keys)
        self.valid = list(valid)         # per-row count of real hashes
        self.nbytes = rows * cols * 8
        self._mm: Optional[mmap.mmap] = None
        self._mat: Optional[np.ndarray] = None


class SketchPageStore:
    """Paged, mmap-backed store of fixed-width ``uint64`` sketch rows.

    ``cols`` is the padded row width (``sketch_size``); rows shorter
    than ``cols`` are zero-padded and carry their true hash count in
    the directory (``valid``), so ``hashes(rid)`` can hand back the
    exact original array as a zero-copy slice.
    """

    def __init__(self, directory: str, cols: int,
                 page_rows: int = DEFAULT_PAGE_ROWS,
                 budget_bytes: Optional[int] = None,
                 fill: int = 0):
        if cols <= 0 or page_rows <= 0:
            raise ValueError("cols and page_rows must be positive")
        self.directory = os.path.abspath(directory)
        self.cols = int(cols)
        self.page_rows = int(page_rows)
        # Pad value for short rows: the MinHash pair kernels expect
        # SENTINEL padding (ops/constants.py) so padded slots can
        # never count as common hashes — gathers must be bit-identical
        # to ops/minhash.sketch_matrix rows.
        self.fill = np.uint64(fill)
        self.budget_bytes = (ram_budget_bytes() if budget_bytes is None
                             else int(budget_bytes))
        os.makedirs(self.directory, exist_ok=True)
        atomic.sweep_tmp(self.directory,
                         max_age_s=atomic.SHARED_TMP_MAX_AGE_S)
        self._lock = threading.RLock()
        self._token = os.urandom(4).hex()    # per-writer page-name salt
        self._seq = 0
        self._pages: List[_Page] = []
        self._key_to_rid: Dict[str, int] = {}
        # LRU order of resident page indices (most recent last) and the
        # pin counts that veto their eviction.
        self._order: List[int] = []
        self._resident: Dict[int, bool] = {}
        self._pins: Dict[int, int] = {}
        self._resident_bytes = 0
        self._peak_resident_bytes = 0
        # The open (not yet committed) page under construction.
        self._open_rows: List[np.ndarray] = []
        self._open_valid: List[int] = []
        self._open_keys: List[str] = []
        self._c_page_ins = obs_metrics.counter(
            "pagestore.page_ins", help="pages mapped into the resident set")
        self._c_page_outs = obs_metrics.counter(
            "pagestore.page_outs", help="pages evicted from the resident set")
        self._g_resident = obs_metrics.gauge(
            "pagestore.resident_bytes", unit="bytes",
            help="bytes of sketch pages currently resident (mmapped + LRU)")
        self.refresh()

    # -- directory ---------------------------------------------------------

    @property
    def dir_path(self) -> str:
        return os.path.join(self.directory, DIR_NAME)

    def refresh(self) -> int:
        """Re-read ``pages.jsonl`` and adopt pages committed by other
        writers.  Returns the number of newly adopted pages."""
        records, bad = atomic.read_jsonl(self.dir_path)
        if bad:
            logger.warning("pagestore %s: healed %d torn directory line(s)",
                        self.directory, bad)
        with self._lock:
            known = {p.name for p in self._pages}
            added = 0
            for rec in records:
                if not isinstance(rec, dict) or rec.get("page") in known:
                    continue
                self._adopt_locked(rec)
                added += 1
            return added

    def _adopt_locked(self, rec: dict) -> None:
        with self._lock:
            name = rec["page"]
            keys = rec.get("keys", [])
            valid = rec.get("valid", [])
            rows = int(rec.get("rows", len(keys)))
            cols = int(rec.get("cols", self.cols))
            if cols != self.cols or rows != len(keys) or rows != len(valid):
                raise PageStoreError(
                    f"pagestore {self.directory}: directory record for "
                    f"{name!r} is inconsistent (rows={rows} cols={cols})")
            row0 = sum(p.rows for p in self._pages)
            page = _Page(name, rows, cols, row0, keys, valid)
            self._pages.append(page)
            for i, key in enumerate(keys):
                if key:
                    self._key_to_rid.setdefault(key, row0 + i)

    # -- write path --------------------------------------------------------

    def append(self, key: str, hashes: np.ndarray) -> int:
        """Append one sketch row; returns its global row id.

        The row becomes durable (and visible to other processes) at
        the next page boundary or explicit :meth:`flush`.
        """
        arr = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
        if arr.size > self.cols:
            raise ValueError(
                f"row has {arr.size} hashes but page width is {self.cols}")
        with self._lock:
            row = np.full(self.cols, self.fill, dtype=np.uint64)
            row[:arr.size] = arr
            rid = (sum(p.rows for p in self._pages)
                   + len(self._open_rows))
            self._open_rows.append(row)
            self._open_valid.append(int(arr.size))
            self._open_keys.append(key or "")
            if key:
                self._key_to_rid.setdefault(key, rid)
            if len(self._open_rows) >= self.page_rows:
                self._commit_open_locked()
            return rid

    def flush(self) -> None:
        """Commit the open partial page, if any."""
        with self._lock:
            if self._open_rows:
                self._commit_open_locked()

    def _commit_open_locked(self) -> None:
        with self._lock:
            rows = len(self._open_rows)
            payload = np.vstack(self._open_rows).astype("<u8", copy=False)
            raw = payload.tobytes()
            name = f"page-{self._token}-{self._seq:06d}.gpg"
            self._seq += 1
            header = atomic.frame_line({
                "magic": PAGE_MAGIC, "version": PAGE_VERSION,
                "rows": rows, "cols": self.cols, "dtype": "<u8",
                "payload_crc": f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}",
            }).encode("utf-8")
            path = os.path.join(self.directory, name)
            # Page body first, directory record second: a crash between the
            # two leaves an orphan page file (swept by age) but never a
            # directory record pointing at a missing/torn page.
            atomic.write_bytes(path, header + raw, site=_PAGE_SITE)
            rec = {"page": name, "rows": rows, "cols": self.cols,
                   "keys": list(self._open_keys),
                   "valid": list(self._open_valid)}
            atomic.append_jsonl(self.dir_path, rec, site=_DIR_SITE)
            self._adopt_locked(rec)
            self._open_rows = []
            self._open_valid = []
            self._open_keys = []

    # -- resident set ------------------------------------------------------

    def _map_locked(self, pi: int) -> np.ndarray:
        with self._lock:
            page = self._pages[pi]
            if page._mat is None:
                path = os.path.join(self.directory, page.name)
                with open(path, "rb") as fh:
                    head = fh.readline()
                    mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
                meta = self._check_header(page, head)
                offset = len(head)
                mat = np.frombuffer(mm, dtype="<u8",
                                    count=page.rows * page.cols,
                                    offset=offset).reshape(page.rows, page.cols)
                if meta.get("payload_crc"):
                    got = f"{zlib.crc32(mat.tobytes()) & 0xFFFFFFFF:08x}"
                    if got != meta["payload_crc"]:
                        raise PageStoreError(
                            f"pagestore page {page.name}: payload crc mismatch "
                            f"(want {meta['payload_crc']}, got {got})")
                page._mm = mm
                page._mat = mat
                self._resident[pi] = True
                self._resident_bytes += page.nbytes
                self._peak_resident_bytes = max(self._peak_resident_bytes,
                                                self._resident_bytes)
                self._c_page_ins.inc()
                self._g_resident.set(self._resident_bytes)
            if pi in self._order:
                self._order.remove(pi)
            self._order.append(pi)
            self._evict_locked()
            return page._mat

    def _check_header(self, page: _Page, head: bytes) -> dict:
        try:
            text = head.decode("utf-8").rstrip("\n")
            body, crc = text.rsplit(atomic.FRAME_SEP, 1)
            if f"{zlib.crc32(body.encode('utf-8')) & 0xFFFFFFFF:08x}" != crc:
                raise ValueError("header crc mismatch")
            meta = json.loads(body)
        except Exception as exc:
            raise PageStoreError(
                f"pagestore page {page.name}: bad header ({exc})") from exc
        if (meta.get("magic") != PAGE_MAGIC
                or int(meta.get("rows", -1)) != page.rows
                or int(meta.get("cols", -1)) != page.cols):
            raise PageStoreError(
                f"pagestore page {page.name}: header/directory mismatch "
                f"({meta})")
        return meta

    def _evict_locked(self) -> None:
        with self._lock:
            while (self._resident_bytes > self.budget_bytes
                   and any(self._pins.get(pi, 0) == 0 for pi in self._order)):
                victim = next(pi for pi in self._order
                              if self._pins.get(pi, 0) == 0)
                self._order.remove(victim)
                page = self._pages[victim]
                mm = page._mm
                page._mat = None
                page._mm = None
                self._resident.pop(victim, None)
                self._resident_bytes -= page.nbytes
                self._c_page_outs.inc()
                self._g_resident.set(self._resident_bytes)
                # Never close the map: earlier zero-copy views keep it
                # alive via .base.  Just hint the kernel to drop the pages.
                dontneed = getattr(mmap, "MADV_DONTNEED", None)
                if mm is not None and dontneed is not None \
                        and hasattr(mm, "madvise"):
                    try:
                        mm.madvise(dontneed)
                    except (ValueError, OSError):
                        pass

    # -- read path ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return (sum(p.rows for p in self._pages)
                    + len(self._open_rows))

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self), self.cols)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    @property
    def peak_resident_bytes(self) -> int:
        """The most bytes of pages resident at once so far (pins may
        take it past the budget for the length of a gather)."""
        with self._lock:
            return self._peak_resident_bytes

    def _locate_locked(self, rid: int) -> Tuple[int, int]:
        if rid < 0:
            raise IndexError(rid)
        for pi, page in enumerate(self._pages):
            if rid < page.row0 + page.rows:
                return pi, rid - page.row0
        raise IndexError(
            f"row {rid} is not committed (store has "
            f"{sum(p.rows for p in self._pages)} committed rows; call "
            "flush() first)")

    def _open_index_locked(self, rid: int) -> Optional[int]:
        """Offset into the open (uncommitted) page, or None."""
        committed = sum(p.rows for p in self._pages)
        if rid >= committed:
            off = rid - committed
            if off < len(self._open_rows):
                return off
            raise IndexError(rid)
        return None

    def row(self, rid: int) -> np.ndarray:
        """The full padded row — a zero-copy read-only view."""
        with self._lock:
            off = self._open_index_locked(rid)
            if off is not None:
                return self._open_rows[off]
            pi, off = self._locate_locked(rid)
            return self._map_locked(pi)[off]

    def n_valid(self, rid: int) -> int:
        with self._lock:
            off = self._open_index_locked(rid)
            if off is not None:
                return self._open_valid[off]
            pi, off = self._locate_locked(rid)
            return self._pages[pi].valid[off]

    def hashes(self, rid: int) -> np.ndarray:
        """The row's true (unpadded) hash array — zero-copy view."""
        with self._lock:
            off = self._open_index_locked(rid)
            if off is not None:
                return self._open_rows[off][:self._open_valid[off]]
            pi, off = self._locate_locked(rid)
            return self._map_locked(pi)[off][:self._pages[pi].valid[off]]

    def rid_for(self, key: str) -> Optional[int]:
        with self._lock:
            return self._key_to_rid.get(key)

    def get(self, key: str) -> Optional[np.ndarray]:
        """The true hash array for a content key, or None."""
        rid = self.rid_for(key)
        return None if rid is None else self.hashes(rid)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """A contiguous ``(len(indices), cols)`` submatrix copy.

        Pages covering the requested rows are pinned for the duration
        of the copy, then returned to normal LRU rotation.  This is
        the duck-typed hook ``ops/bucketing.bucketed_threshold_pairs``
        calls as ``band_gather``: the only rows materialized are the
        two bands being walked.
        """
        idx = np.asarray(indices, dtype=np.int64).ravel()
        out = np.empty((idx.size, self.cols), dtype=np.uint64)
        with self._lock:
            if self._open_rows:
                self._commit_open_locked()
            touched = sorted({self._locate_locked(int(r))[0] for r in idx})
            for pi in touched:
                self._pins[pi] = self._pins.get(pi, 0) + 1
            try:
                for pi in touched:
                    self._map_locked(pi)
                for j, r in enumerate(idx):
                    pi, off = self._locate_locked(int(r))
                    out[j] = self._pages[pi]._mat[off]
            finally:
                for pi in touched:
                    left = self._pins.get(pi, 0) - 1
                    if left <= 0:
                        self._pins.pop(pi, None)
                    else:
                        self._pins[pi] = left
                self._evict_locked()
        return out

    #: Alias the bucketed scheduler duck-types on.
    band_gather = gather

    def valid_counts(self) -> np.ndarray:
        """Per-row true-hash counts for all committed rows."""
        with self._lock:
            counts: List[int] = []
            for page in self._pages:
                counts.extend(page.valid)
            return np.asarray(counts, dtype=np.int64)

    def close(self) -> None:
        with self._lock:
            if self._open_rows:
                self._commit_open_locked()
            for pi in list(self._order):
                self._pins.pop(pi, None)
            self.budget_bytes = 0
            self._evict_locked()


class PagedRowView:
    """Position-indexed facade over a ``SketchPageStore``: maps caller
    row positions (genome-path order, duplicate paths sharing a store
    row) to store row ids. Duck-typed for
    ``ops/bucketing.bucketed_threshold_pairs``: it exposes ``shape``
    and ``band_gather`` only, so holding one is never holding a whole
    sketch matrix."""

    def __init__(self, store: SketchPageStore, rids) -> None:
        self.store = store
        self.rids = np.asarray(rids, dtype=np.int64)

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self.rids.shape[0]), self.store.cols)

    def band_gather(self, indices) -> np.ndarray:
        idx = np.asarray(indices, dtype=np.int64).ravel()
        return self.store.gather(self.rids[idx])
