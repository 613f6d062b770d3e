"""FASTA ingestion: file -> 2-bit codes + contig offsets + stats.

``read_genome`` and ``read_genome_stats`` read the file in Python
(gzip input is decompressed by the standard library, which releases
the interpreter lock) and parse the bytes with the port's native C
parser (``io/_cingest.py``, ``csrc/ingest.c``): the codes (A=0 C=1 G=2
T=3, case-insensitive, 255 for any other byte), the contig offsets and
the stats of ``galah_tpu/io/fasta.py``. A failed build of the parser
raises; nothing falls back.

``read_genome_plain`` and ``read_genome_stats_plain`` are the plain
version the tests and ``chip_smoke.py`` hold the C parser against: the
port's own copy of ``galah_tpu``'s ``read_genome_numpy``, with the line
walk vectorized over the whole file in numpy. The semantics are line
by line: each line is stripped of ASCII whitespace at both ends, empty
lines are skipped, a line starting with ``>`` opens a record, and
sequence lines before the first record belong to none.

A read that fails with a transient OS error (a network filesystem's
flake) is retried with backoff (``resilience/policy.py``; the
``GALAH_IO_RETRY_*`` variables, 3 attempts from 0.1 s by default),
each retry a ``retry`` event of the run report, the shape of
``galah_tpu``'s dispatch retry events. A
file the parser refuses raises ``BadGenomeError`` (reason ``empty``
when it holds no record, else ``corrupt``); a damaged gzip stream
raises the standard library's error (``CORRUPT_GZIP_ERRORS``), not
retried, which ``--on-bad-genome skip`` quarantines as ``corrupt``, as
``galah_tpu`` does; a missing file raises ``FileNotFoundError``, not
retried.
"""

from __future__ import annotations

import dataclasses
import gzip
import zlib
from typing import Optional

import numpy as np

from galah_tpu_torch.io import _cingest
from galah_tpu_torch.obs import events
from galah_tpu_torch.resilience.policy import RetryPolicy, call_with_retry


class BadGenomeError(ValueError):
    """A genome file the parser refuses: ``empty`` (no record) or
    ``corrupt`` (``galah_tpu``'s ``BadGenomeError``)."""

    def __init__(self, path: str, reason: str, detail: str = "") -> None:
        self.path = path
        self.reason = reason  # "empty" | "corrupt"
        super().__init__(f"{reason} genome FASTA {path}"
                         + (f": {detail}" if detail else ""))


# ASCII -> 2-bit code; 255 marks ambiguous/non-ACGT.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase

_ACGT_LUT = _CODE_LUT != 255

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


def _parse(path: str):
    """(bytes, first and one-past-last non-whitespace byte of each
    sequence line, the contig of each, contig lengths) of a FASTA file:
    the line walk both readers share. It touches every byte only
    through two table lookups and one scan for whitespace; the rest
    works on the whitespace positions and the lines."""
    a = np.frombuffer(_read_bytes(path), dtype=np.uint8)
    n = a.shape[0]
    ws = _WS_LUT[a]
    pos = np.flatnonzero(ws)  # whitespace bytes, newlines among them
    nl = pos[a[pos] == ord("\n")]
    first = np.concatenate(([0], nl + 1))
    last = np.concatenate((nl, [n]))
    # runs of consecutive whitespace: a line's leading run ends before
    # its first non-whitespace byte, its trailing run starts after its
    # last. A run that spans the whole line leaves first > last.
    if pos.size:
        brk = np.flatnonzero(np.diff(pos) != 1) + 1
        run_first = pos[np.concatenate(([0], brk))]
        run_last = pos[np.concatenate((brk - 1, [pos.size - 1]))]
        lead = last > first
        lead[lead] = ws[first[lead]]
        r = np.searchsorted(run_first, first[lead], side="right") - 1
        first[lead] = run_last[r] + 1
        trail = last > first
        trail[trail] = ws[last[trail] - 1]
        r = np.searchsorted(run_first, last[trail] - 1, side="right") - 1
        last[trail] = run_first[r]
    solid = first < last
    first, last = first[solid], last[solid]

    is_header = a[first] == ord(">")
    n_contigs = int(is_header.sum())
    if n_contigs == 0:
        raise ValueError(f"no FASTA records found in {path}")
    contig = np.cumsum(is_header) - 1   # record each line belongs to
    seq = ~is_header & (contig >= 0)
    starts, ends, owner = first[seq], last[seq], contig[seq]
    lengths = np.bincount(owner, weights=(ends - starts),
                          minlength=n_contigs).astype(np.int64)
    return a, starts, ends, lengths


_IO_POLICY: Optional[RetryPolicy] = None


def _io_policy() -> RetryPolicy:
    """The ``GALAH_IO_RETRY`` policy, read from the environment once."""
    global _IO_POLICY
    if _IO_POLICY is None:
        _IO_POLICY = RetryPolicy.from_env(
            "GALAH_IO_RETRY", defaults=dict(max_attempts=3, base_delay=0.1))
    return _IO_POLICY


#: what a damaged gzip stream raises while it is read
CORRUPT_GZIP_ERRORS = (gzip.BadGzipFile, EOFError, zlib.error)


def _io_retryable(exc: BaseException) -> bool:
    """A transient OS error is worth a backoff; a missing path or a
    corrupt payload (gzip's errors are deterministic per content) is
    not."""
    if isinstance(exc, (FileNotFoundError, IsADirectoryError,
                        *CORRUPT_GZIP_ERRORS)):
        return False
    return isinstance(exc, (OSError, TimeoutError))


def read_genome(path: str) -> Genome:
    """Parse a (possibly gzipped) FASTA into codes + offsets + stats
    with the C parser; raises ``BadGenomeError`` on a file it
    refuses."""
    site = f"io.read[{path}]"
    data = call_with_retry(lambda: _read_bytes(path), _io_policy(),
                           site=site, classify=_io_retryable,
                           on_retry=lambda attempt, exc: events.record(
                               "retry", site=site, attempt=attempt,
                               error=f"{type(exc).__name__}: {exc}"))
    try:
        codes, offsets, n_amb, n50 = _cingest.parse_fasta(data, path)
    except ValueError as e:
        msg = str(e)
        raise BadGenomeError(
            path, "empty" if "no FASTA records" in msg else "corrupt",
            msg) from e
    stats = GenomeStats(num_contigs=int(offsets.shape[0]) - 1,
                        num_ambiguous_bases=n_amb, n50=n50)
    return Genome(path=path, codes=codes,
                  contig_offsets=offsets.astype(np.int64), stats=stats)


def read_genome_stats(path: str) -> GenomeStats:
    """The stats of ``read_genome`` (the quality formulas' read;
    ``galah_tpu``'s ``calculate_genome_stats``)."""
    return read_genome(path).stats


def read_genome_plain(path: str) -> Genome:
    """``read_genome`` in numpy: the plain version."""
    a, starts, ends, lengths = _parse(path)
    # +1 at each sequence line's start, -1 past its end: the lines are
    # disjoint and ordered, so the running sum is 1 inside a line and 0
    # outside, and int8 holds it
    mark = np.zeros(a.shape[0] + 1, dtype=np.int8)
    mark[starts] = 1
    mark[ends] -= 1
    codes = _CODE_LUT[a[np.cumsum(mark[:-1], dtype=np.int8).view(bool)]]
    offsets = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    stats = GenomeStats(
        num_contigs=int(lengths.shape[0]),
        num_ambiguous_bases=int((codes == 255).sum()),
        n50=_compute_n50(lengths),
    )
    return Genome(path=path, codes=codes, contig_offsets=offsets,
                  stats=stats)


def read_genome_stats_plain(path: str) -> GenomeStats:
    """``read_genome_stats`` in numpy, without building the codes: the
    plain version."""
    a, starts, ends, lengths = _parse(path)
    # the bytes of the sequence lines that are not ACGT (few), counted
    # per line by their positions
    odd = np.flatnonzero(~_ACGT_LUT[a])
    n_amb = int((np.searchsorted(odd, ends)
                 - np.searchsorted(odd, starts)).sum())
    return GenomeStats(
        num_contigs=int(lengths.shape[0]),
        num_ambiguous_bases=n_amb,
        n50=_compute_n50(lengths),
    )
