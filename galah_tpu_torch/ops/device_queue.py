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
        # (cap, 2) int64: each row one record's 16 bytes
        self.records = torch.zeros(self.cap, 2, dtype=torch.int64,
                                   device=self.device)
        words = self.records.view(torch.int32)
        self.qi = words[:, 0]
        self.qj = words[:, 1]
        self.qv = self.records.view(torch.float64)[:, 1]
        self.qv.fill_(float("nan"))
        self._count = 0
        self._overflow = 0
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    @property
    def count(self) -> int:
        return self._count

    @property
    def overflow(self) -> int:
        return self._overflow

    def _stage(self, m: int) -> np.ndarray:
        """A host array of `m` records: on the card a view of a pinned
        buffer, once the copy out of it has finished."""
        if self.device.type != "cuda":
            return np.empty(m, dtype=RECORD)
        if self._staging is None:
            self._staging = torch.empty(self.cap, 2, dtype=torch.int64,
                                        pin_memory=True)
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        return self._staging.numpy().view(RECORD).reshape(-1)[:m]

    def enqueue(self, i: np.ndarray, j: np.ndarray, v: np.ndarray) -> int:
        """Append one batch of pairs; returns how many were stored.
        Below ``len(i)`` the queue reached its capacity: the stored
        prefix is in the queue and the rest counted in ``overflow``."""
        m = len(i)
        if m == 0:
            return 0
        k = min(m, self.cap - self._count)
        if k > 0:
            host = self._stage(k)
            host["i"] = np.asarray(i[:k], dtype=np.int32)
            host["j"] = np.asarray(j[:k], dtype=np.int32)
            host["v"] = np.asarray(v[:k], dtype=np.float64)
            src = torch.from_numpy(host.view(np.int64).reshape(k, 2))
            dst = self.records[self._count:self._count + k]
            if self.device.type == "cuda":
                dst.copy_(src, non_blocking=True)
                self._copied = torch.cuda.Event()
                self._copied.record(
                    torch.cuda.current_stream(self.device))
            else:
                dst.copy_(src)
        self._count += k
        self._overflow += m - k
        return k

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
