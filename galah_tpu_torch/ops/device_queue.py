"""The pair queue on the device, which feeds the slab fold: the port of
``galah_tpu/ops/device_queue.py``.

A slab's hit edges go into the queue as ``(i, j, ani)`` triples and the
fold (``ops/megakernel.py``) reads them where they lie, so the edge
list of a slab is uploaded once and never comes back to the host.

Layout: a power-of-two capacity (``GALAH_TPU_QUEUE_CAP``, default 4096
pairs, rounded up, at least 8) of 16-byte records, ``(i int32, j int32,
ani float64)``. ``qi``, ``qj`` and ``qv`` are the three columns, as
strided views of the one allocation, so that an enqueue is one copy
from pinned memory of the batch's records, at the end of the prefix.

* **Compaction**: entries always fill the dense prefix ``[0, count)``,
  so the fold needs only ``count``.
* **Exact overflow**: an enqueue that would pass the capacity stores
  the prefix that fits, counts the rest in ``overflow`` and returns how
  many it stored; the caller takes the exact dense path for the slab.
* **Bits**: ``qv`` holds the IEEE bits it was given; nothing converts.

The host knows each batch's length, so ``count`` and ``overflow`` live
on the host: an enqueue reads nothing back from the device. There is
no padding to buckets, since nothing recompiles for a new length.

The queue also holds the slab fold's buffers, so that a slab costs one
upload and one readback and allocates nothing: the records lie at the
head of one device buffer with room for a slab's ``ext`` flags behind
them, and an enqueue given ``ext`` stages the batch's records and the
flags side by side in one pinned buffer and carries both in one copy
(``ext`` then lies right after the records, ``self.ext``); the fold's
device workspace (``workspace``) and a pinned host mirror
(``read_back``: one copy and one event wait). Each grows by powers of
two as slabs widen.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.config import env_value
from galah_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

#: Default queue capacity in pairs (GALAH_TPU_QUEUE_CAP).
DEFAULT_QUEUE_CAP = 4096
_MIN_CAP = 8

#: One record: i and j (int32 each) and the ANI (float64).
RECORD = np.dtype([("i", "<i4"), ("j", "<i4"), ("v", "<f8")])

# Numeric contract (GL9xx): the queue stores the decision values as
# they are, so the fold compares the same float64 bits the host would.
DETERMINISM_CONTRACT = {
    "family": "device_queue",
    "dtype": "float64",
    "functions": ["enqueue", "drain"],
}


def resolve_queue_cap() -> int:
    """The capacity from GALAH_TPU_QUEUE_CAP, rounded up to a power of
    two; a malformed or non-positive value warns and reads as the
    default (the capacity moves only the spill boundary)."""
    raw = (env_value("GALAH_TPU_QUEUE_CAP") or "").strip()
    cap = DEFAULT_QUEUE_CAP
    if raw:
        try:
            cap = int(raw)
        except ValueError:
            logger.warning("ignoring malformed GALAH_TPU_QUEUE_CAP=%r "
                           "(want a positive integer)", raw)
            cap = DEFAULT_QUEUE_CAP
        if cap < 1:
            logger.warning("ignoring non-positive GALAH_TPU_QUEUE_CAP"
                           "=%d", cap)
            cap = DEFAULT_QUEUE_CAP
    return pow2_at_least(cap)


def pow2_at_least(n: int) -> int:
    b = _MIN_CAP
    while b < n:
        b *= 2
    return b


class PairQueue:
    """The queue's records on `device` and its host-side count."""

    def __init__(self, cap: Optional[int] = None, device="cuda") -> None:
        if cap is None:
            cap = resolve_queue_cap()
        self.cap = pow2_at_least(int(cap))
        self.device = resolve_device(device)
        self._count = 0
        self._overflow = 0
        # the device buffer: the (cap, 2) int64 records, then _ext_cap
        # bytes of room for a slab's ext flags
        self._ext_cap = 0
        self._buf: Optional[torch.Tensor] = None
        self._grow(0)
        #: the ext flags of the last enqueue given them (bool, on the
        #: device), right after its records; until the next enqueue
        self.ext: Optional[torch.Tensor] = None
        self._staging: Optional[torch.Tensor] = None
        # a copy out of the staging buffer may still be running
        self._in_flight = False
        self._work: Optional[torch.Tensor] = None
        self._mirror: Optional[torch.Tensor] = None
        self._read: Optional[torch.cuda.Event] = None

    @property
    def count(self) -> int:
        return self._count

    @property
    def overflow(self) -> int:
        return self._overflow

    def _grow(self, ext_bytes: int) -> None:
        """Room for `ext_bytes` of flags behind a full queue; the stored
        records keep their contents."""
        if self._buf is not None and self._ext_cap >= ext_bytes:
            return
        ext_cap = pow2_at_least(ext_bytes) if ext_bytes else 0
        rec_bytes = 16 * self.cap
        buf = torch.empty(rec_bytes + ext_cap, dtype=torch.uint8,
                          device=self.device)
        first = self._buf is None
        if not first:
            buf[:rec_bytes].copy_(self._buf[:rec_bytes])
        self._buf, self._ext_cap = buf, ext_cap
        # (cap, 2) int64: each row one record's 16 bytes
        self.records = buf[:rec_bytes].view(torch.int64).view(self.cap, 2)
        words = self.records.view(torch.int32)
        self.qi = words[:, 0]
        self.qj = words[:, 1]
        self.qv = self.records.view(torch.float64)[:, 1]
        if first:
            self.records.zero_()
            self.qv.fill_(float("nan"))

    def _stage(self, nbytes: int) -> torch.Tensor:
        """The staging buffer's first `nbytes` (uint8): on the card
        pinned, once the copy out of it has finished."""
        size = 16 * self.cap + self._ext_cap
        if self._in_flight:
            torch.cuda.synchronize(self.device)
            self._in_flight = False
        if self._staging is None or self._staging.numel() < size:
            self._staging = torch.empty(
                size, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self._staging[:nbytes]

    def enqueue(self, i: np.ndarray, j: np.ndarray, v: np.ndarray,
                ext: Optional[np.ndarray] = None) -> int:
        """Append one batch of pairs; returns how many were stored.
        Below ``len(i)`` the queue reached its capacity: the stored
        prefix is in the queue and the rest counted in ``overflow``.
        With `ext` (a slab's bool flags) the flags go up in the same
        copy, into ``self.ext``."""
        m = len(i)
        k = min(m, self.cap - self._count)
        w = 0 if ext is None else len(ext)
        if ext is not None:
            self._grow(w)
        if k > 0 or ext is not None:
            nbytes = 16 * k + w
            staged = self._stage(nbytes)
            host = staged.numpy()
            if k > 0:
                rec = host[:16 * k].view(RECORD)
                rec["i"] = np.asarray(i[:k], dtype=np.int32)
                rec["j"] = np.asarray(j[:k], dtype=np.int32)
                rec["v"] = np.asarray(v[:k], dtype=np.float64)
            if ext is not None:
                host[16 * k:] = np.asarray(
                    ext, dtype=bool).view(np.uint8)
            start = 16 * self._count
            dst = self._buf[start:start + nbytes]
            if self.device.type == "cuda":
                dst.copy_(staged, non_blocking=True)
                self._in_flight = True
            else:
                dst.copy_(staged)
            if ext is not None:
                self.ext = dst[nbytes - w:].view(torch.bool)
        self._count += k
        self._overflow += m - k
        return k

    def workspace(self, nbytes: int) -> torch.Tensor:
        """A held uint8 buffer of at least `nbytes` on the queue's
        device (the slab fold's packed output and scratch)."""
        if self._work is None or self._work.numel() < nbytes:
            self._work = torch.empty(pow2_at_least(nbytes),
                                     dtype=torch.uint8, device=self.device)
        return self._work

    def read_back(self, src: torch.Tensor, nbytes: int) -> np.ndarray:
        """The first `nbytes` of `src` (a uint8 tensor on the queue's
        device) on the host: one copy into a held pinned mirror and one
        event wait; on the CPU `src` itself. The array is the mirror's
        until the next call."""
        if self.device.type != "cuda":
            return src[:nbytes].numpy()
        if self._mirror is None or self._mirror.numel() < nbytes:
            self._mirror = torch.empty(pow2_at_least(nbytes),
                                       dtype=torch.uint8, pin_memory=True)
        mirror = self._mirror[:nbytes]
        mirror.copy_(src[:nbytes], non_blocking=True)
        if self._read is None:
            self._read = torch.cuda.Event()
        self._read.record(torch.cuda.current_stream(self.device))
        self._read.synchronize()
        # the stream's earlier work, an upload from the staging buffer
        # included, has finished
        self._in_flight = False
        return mirror.numpy()

    def drain(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The stored ``(i, j, ani)`` as host arrays; empties the
        queue. The fold reads the records in place instead."""
        m = self._count
        self.reset()
        return tuple(col[:m].cpu().numpy().copy()
                     for col in (self.qi, self.qj, self.qv))

    def reset(self, clear_overflow: bool = False) -> None:
        """Empty the queue; the overflow count lasts the run unless
        `clear_overflow`."""
        self._count = 0
        if clear_overflow:
            self._overflow = 0
