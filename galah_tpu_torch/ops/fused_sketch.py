"""The fused sketch's candidate file: the port of
``ops/pallas_sketch.py``'s ``fused_sketch_candidates`` together with the
preamble ``galah_tpu`` fuses into its operands
(``hashing.canonical_kmer_words_batch``).

Given a launch group's genomes' codes laid end to end (uint8: 0-3, 255
ambiguous), the sorted contig starts of that sequence (int64; every
genome start among them) and each job's (first window, window count),
``fused_sketch_candidates`` builds every window's canonical k-mer and
validity, hashes it, and keeps, per job and per position class
``p mod 2048``, the 8 smallest distinct valid hashes: a (jobs, 8, 2048)
biased int64 tensor, ascending along the register axis,
sentinel-padded. ``ops/sketch_stream`` turns it into sketches and
checks its completeness certificate. On CUDA tensors the hand-written
kernel (``kernels/fused_sketch.cu``) runs, reading the codes; on CPU
tensors the plain torch version beside it, ``fused_candidates_plain``
(``ops/hashing.canonical_key_words``, ``hash_key_words`` and a sort per
class). A CUDA failure raises; nothing falls back.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.hashing import (MAX_KMER, canonical_key_words,
                                         masked_hashes)
from galah_tpu_torch.ops.murmur3_k21 import check_codes, plain_offsets

CLASSES = 2048  # position classes per job (16 sublanes x 128 lanes)
REGS = 8        # distinct minima kept per class
_MAX_JOBS = 65535  # jobs per kernel launch (CUDA grid y limit)

Job = Tuple[int, int]  # (first window, window count) in the codes


def _check(codes: torch.Tensor, starts: torch.Tensor, jobs: Sequence[Job],
           k: int, algo: str) -> None:
    if algo not in ("murmur3", "tpufast"):
        raise ValueError(f"unknown hash algorithm {algo!r}")
    if not 1 <= k <= MAX_KMER:
        raise ValueError(f"fused {algo} sketching takes k in [1, "
                         f"{MAX_KMER}]; got k={k}")
    check_codes(codes, starts, "fused sketch")
    n = max(codes.shape[0] - k + 1, 0)
    for off, length in jobs:
        if off < 0 or length < 0 or (length and off + length > n):
            raise ValueError(f"fused sketch job ({off}, {length}) lies "
                             f"outside the {n} windows")


def fused_sketch_candidates(codes: torch.Tensor, starts: torch.Tensor,
                            jobs: Sequence[Job], k: int,
                            algo: str) -> torch.Tensor:
    """(jobs, REGS, CLASSES) biased int64 candidate files."""
    _check(codes, starts, jobs, k, algo)
    if codes.device.type == "cpu":
        return fused_candidates_plain(codes, starts, jobs, k, algo)
    return _launch(codes, starts, jobs, k, algo)


def fused_candidates_plain(codes: torch.Tensor, starts: torch.Tensor,
                           jobs: Sequence[Job], k: int,
                           algo: str) -> torch.Tensor:
    """The torch version, CPU tensors only: key words and hashes of
    every window, then per job sort each class's hashes, drop repeats
    and keep the first REGS."""
    _check(codes, starts, jobs, k, algo)
    if codes.device.type != "cpu":
        raise ValueError("fused_candidates_plain takes CPU tensors")
    c = codes.numpy()
    words, valid = canonical_key_words(
        c, plain_offsets(starts, 0, c.shape[0]), k, "cpu", algo)
    h = masked_hashes(words, valid, k, algo)
    out = torch.full((len(jobs), REGS, CLASSES), SENTINEL_BIASED,
                     dtype=torch.int64)
    for j, (off, length) in enumerate(jobs):
        rows = -(-length // CLASSES)
        x = torch.full((max(rows, 1) * CLASSES,), SENTINEL_BIASED,
                       dtype=torch.int64)
        x[:length] = h[off:off + length]
        # (classes, rows): class c holds positions c, c + 2048, ...
        x = torch.sort(x.reshape(-1, CLASSES).T, dim=1).values
        dup = torch.zeros_like(x, dtype=torch.bool)
        dup[:, 1:] = x[:, 1:] == x[:, :-1]
        x = torch.sort(torch.where(dup, SENTINEL_BIASED, x), dim=1).values
        m = min(REGS, x.shape[1])
        out[j, :m] = x[:, :m].T
    return out


def _launch(codes: torch.Tensor, starts: torch.Tensor, jobs: Sequence[Job],
            k: int, algo: str) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    device = codes.device
    out = torch.empty((len(jobs), REGS, CLASSES), dtype=torch.int64,
                      device=device)
    if not jobs:
        return out
    lib = build.load("fused_sketch")
    meta = torch.tensor(jobs, dtype=torch.int64).T.contiguous().to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for j0 in range(0, len(jobs), _MAX_JOBS):
        n = min(_MAX_JOBS, len(jobs) - j0)
        err = lib.fused_sketch_launch(
            codes.data_ptr(), starts.data_ptr(), starts.shape[0],
            meta[0, j0:].data_ptr(), meta[1, j0:].data_ptr(), n, k,
            int(algo == "tpufast"), out[j0:].data_ptr(), stream)
        build.check("fused_sketch", err)
        LAUNCHES["fused_sketch"] += 1
    return out
