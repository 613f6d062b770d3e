"""Launch groups: genomes laid end to end, copied to the device at once.

The profile build (``ops/fragment_ani.build_profiles_batch``) and the
sketch stream (``ops/sketch_stream``, ``ops/hll``) hash many genomes in
one kernel launch. A group is the genomes' codes laid end to end, with
every genome start a contig start, so no window crosses from one genome
into the next (``galah_tpu`` spreads this over
``ops/hashing.iter_genome_groups`` and ``io/prefetch.iter_batches``).
Its length bucketing and 2-bit packing bound XLA recompiles and TPU
transfers; the port has neither need and copies neither. A genome's
hashes depend only on its own windows, so no result depends on where
the group boundaries fall.

On the card, a group is written once into one reused page-locked host
buffer, shared by the profile build and the sketch stream, and copied
to the device with ``non_blocking=True``; the buffer is written again
only after that copy has completed (its event). On the CPU a group is
a fresh pair of arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.io.prefetch import iter_batches

# genomes longer than this form a group of their own (the port's
# kernels take any length; ``galah_tpu`` hashes them a chunk at a time)
ALONE_ABOVE = 1 << 23

Jobs = List[Tuple[int, int]]


@dataclasses.dataclass
class Group:
    """A group on its device: the codes (uint8, 255 ambiguous), the
    sorted contig starts (int64: each genome's start and its interior
    contig starts, then the codes' length), and per genome its (first
    window, window count)."""

    codes: torch.Tensor
    starts: torch.Tensor
    jobs: Jobs


def iter_groups(genomes: Sequence[Genome], budget: int
                ) -> Iterator[List[int]]:
    """Indices of `genomes` cut in order into groups of at most `budget`
    bases (a longer genome alone; one above ``ALONE_ABOVE`` bases
    always alone)."""
    for batch in iter_batches(enumerate(genomes),
                              lambda g: g.codes.shape[0], budget,
                              ALONE_ABOVE):
        yield [i for i, _ in batch]


def host_layout(genomes: Sequence[Genome], k: int,
                codes: Optional[np.ndarray] = None,
                starts: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, Jobs]:
    """(codes, starts, jobs) of `genomes` laid end to end, written into
    `codes` and `starts` (allocated when None) and returned as their
    used prefixes; job j is genome j's (first window, window count) at
    window width `k`."""
    n_codes, n_starts = _sizes(genomes)
    if codes is None:
        codes = np.empty(n_codes, dtype=np.uint8)
    if starts is None:
        starts = np.empty(n_starts, dtype=np.int64)
    jobs: Jobs = []
    pos = si = 0
    for g in genomes:
        n = g.codes.shape[0]
        codes[pos:pos + n] = g.codes
        offs = np.asarray(g.contig_offsets[:-1], dtype=np.int64)
        starts[si:si + offs.shape[0]] = offs + pos
        si += offs.shape[0]
        jobs.append((pos, max(n - k + 1, 0)))
        pos += n
    starts[si] = pos
    return codes[:n_codes], starts[:n_starts], jobs


def _sizes(genomes: Sequence[Genome]) -> Tuple[int, int]:
    return (sum(g.codes.shape[0] for g in genomes),
            sum(len(g.contig_offsets) - 1 for g in genomes) + 1)


class GroupBuffer:
    """Loads groups onto `device`; on the card through one reused
    page-locked buffer."""

    def __init__(self, device) -> None:
        self.device = resolve_device(device)
        self._codes: Optional[torch.Tensor] = None
        self._starts: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    @staticmethod
    def _fit(buf: Optional[torch.Tensor], n: int,
             dtype: torch.dtype) -> torch.Tensor:
        """`buf`, or a larger pinned buffer (a power of two) for `n`."""
        if buf is not None and buf.shape[0] >= n:
            return buf
        return torch.empty(1 << max(n - 1, 0).bit_length(), dtype=dtype,
                           pin_memory=True)

    def load(self, genomes: Sequence[Genome], k: int) -> Group:
        if self.device.type == "cpu":
            codes, starts, jobs = host_layout(genomes, k)
            return Group(torch.from_numpy(codes), torch.from_numpy(starts),
                         jobs)
        if self._copied is not None:
            # the last group's copy still reads the buffer
            self._copied.synchronize()
        n_codes, n_starts = _sizes(genomes)
        self._codes = self._fit(self._codes, n_codes, torch.uint8)
        self._starts = self._fit(self._starts, n_starts, torch.int64)
        _, _, jobs = host_layout(genomes, k, self._codes.numpy(),
                                 self._starts.numpy())
        codes = self._codes[:n_codes].to(self.device, non_blocking=True)
        starts = self._starts[:n_starts].to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return Group(codes, starts, jobs)


_SHARED: Dict[torch.device, GroupBuffer] = {}


def load_group(genomes: Sequence[Genome], k: int, device) -> Group:
    """`genomes` as one group on `device`, through the device's shared
    buffer."""
    device = resolve_device(device)
    buf = _SHARED.get(device)
    if buf is None:
        buf = _SHARED[device] = GroupBuffer(device)
    return buf.load(genomes, k)
