"""FASTA ingestion: file -> 2-bit codes + contig offsets + stats.

The port's own copy of ``galah_tpu/io/fasta.py::read_genome_numpy``:
the same codes (A=0 C=1 G=2 T=3, case-insensitive, 255 for any other
byte), the same contig offsets and the same stats, from gzip or plain
input. The line walk is vectorized over the whole file in numpy
instead of a Python loop per line, which keeps a 1 Gbp corpus read in
seconds; the semantics stay line by line: each line is stripped of
ASCII whitespace at both ends, empty lines are skipped, a line starting
with ``>`` opens a record, and sequence lines before the first record
belong to none.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

# ASCII -> 2-bit code; 255 marks ambiguous/non-ACGT.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase

# the bytes Python's bytes.strip() removes
_WS_LUT = np.zeros(256, dtype=bool)
_WS_LUT[list(b" \t\n\r\x0b\x0c")] = True


@dataclasses.dataclass
class GenomeStats:
    """Assembly stats (reference: src/genome_stats.rs:11-51)."""

    num_contigs: int
    num_ambiguous_bases: int
    n50: int


@dataclasses.dataclass
class Genome:
    """A parsed genome ready for hashing."""

    path: str
    codes: np.ndarray           # uint8 [total_len], 0-3 valid, 255 ambiguous
    contig_offsets: np.ndarray  # int64 [num_contigs + 1]
    stats: GenomeStats

    @property
    def length(self) -> int:
        return int(self.codes.shape[0])


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def _compute_n50(lengths: np.ndarray) -> int:
    """N50: length L such that contigs >= L cover half the assembly
    (reference: src/genome_stats.rs:53-59)."""
    if lengths.size == 0:
        return 0
    s = np.sort(lengths)[::-1]
    csum = np.cumsum(s)
    half = csum[-1] / 2.0
    idx = int(np.searchsorted(csum, half))
    return int(s[idx])


def read_genome(path: str) -> Genome:
    """Parse a (possibly gzipped) FASTA into codes + offsets + stats."""
    a = np.frombuffer(_read_bytes(path), dtype=np.uint8)
    # per line: first and one-past-last non-whitespace byte; lines with
    # none are empty and drop out here. A non-newline byte's line is the
    # count of newlines before it.
    solid = np.flatnonzero(~_WS_LUT[a])
    line_of = np.cumsum(a == ord("\n"), dtype=np.int64)[solid]
    if solid.size:
        brk = np.flatnonzero(np.diff(line_of)) + 1
        first = solid[np.concatenate(([0], brk))]
        last = solid[np.concatenate((brk - 1, [solid.size - 1]))] + 1
    else:
        first = last = np.zeros(0, dtype=np.int64)
    is_header = a[first] == ord(">")
    n_contigs = int(is_header.sum())
    if n_contigs == 0:
        raise ValueError(f"no FASTA records found in {path}")
    contig = np.cumsum(is_header) - 1   # record each line belongs to
    seq = ~is_header & (contig >= 0)
    starts, ends, owner = first[seq], last[seq], contig[seq]

    # +1 at each sequence line's start, -1 past its end (each array holds
    # distinct positions, so plain fancy-index updates are exact)
    mark = np.zeros(a.shape[0] + 1, dtype=np.int32)
    mark[starts] += 1
    mark[ends] -= 1
    keep = np.cumsum(mark[:-1]) > 0
    codes = _CODE_LUT[a[keep]]

    lengths = np.bincount(owner, weights=(ends - starts),
                          minlength=n_contigs).astype(np.int64)
    offsets = np.zeros(n_contigs + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    stats = GenomeStats(
        num_contigs=n_contigs,
        num_ambiguous_bases=int((codes == 255).sum()),
        n50=_compute_n50(lengths),
    )
    return Genome(path=path, codes=codes, contig_offsets=offsets,
                  stats=stats)
