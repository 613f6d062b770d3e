"""The fused sketch's candidate file: the port of
``ops/pallas_sketch.py``'s ``fused_sketch_candidates``.

Given the canonical key words and window mask of a launch group's
genomes, concatenated (``ops/hashing.canonical_key_words``), and each
job's (offset, window count) in them, ``fused_sketch_candidates``
hashes every window and keeps, per job and per position class
``p mod 2048``, the 8 smallest distinct valid hashes: a (jobs, 8, 2048)
biased int64 tensor, ascending along the register axis, sentinel-padded.
``ops/sketch_stream`` turns it into sketches and checks its
completeness certificate. On CUDA tensors the hand-written kernel
(``kernels/fused_sketch.cu``) runs; on CPU tensors the plain torch
version beside it, ``fused_candidates_plain``. A CUDA failure raises;
nothing falls back.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.hashing import hash_key_words
from galah_tpu_torch.ops.u64 import bias

CLASSES = 2048  # position classes per job (16 sublanes x 128 lanes)
REGS = 8        # distinct minima kept per class
_MAX_JOBS = 65535  # jobs per kernel launch (CUDA grid y limit)

Job = Tuple[int, int]  # (offset, window count) in the word arrays


def _check(words: Sequence[torch.Tensor], valid: torch.Tensor,
           jobs: Sequence[Job], k: int, algo: str) -> None:
    if algo not in ("murmur3", "tpufast"):
        raise ValueError(f"unknown hash algorithm {algo!r}")
    n_words = 3 if algo == "murmur3" else 1
    if len(words) != n_words or (algo == "murmur3" and k != 21):
        raise ValueError(f"{algo} fused sketching takes {n_words} key "
                         "word(s), and murmur3 takes k=21; got "
                         f"{len(words)} at k={k}")
    n = valid.shape[0]
    for t in words:
        if t.dtype != torch.int64 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous() or t.device != valid.device:
            raise ValueError(
                "fused sketch key words must be contiguous 1-D int64 "
                f"tensors of the mask's length {n} on {valid.device}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if valid.dtype != torch.bool or valid.dim() != 1 \
            or not valid.is_contiguous():
        raise ValueError("fused sketch mask must be contiguous 1-D bool")
    for off, length in jobs:
        if off < 0 or length < 0 or off + length > n:
            raise ValueError(f"fused sketch job ({off}, {length}) lies "
                             f"outside the {n} windows")


def fused_sketch_candidates(words: Sequence[torch.Tensor],
                            valid: torch.Tensor, jobs: Sequence[Job],
                            k: int, algo: str) -> torch.Tensor:
    """(jobs, REGS, CLASSES) biased int64 candidate files."""
    _check(words, valid, jobs, k, algo)
    if valid.device.type == "cpu":
        return fused_candidates_plain(words, valid, jobs, k, algo)
    return _launch(words, valid, jobs, algo)


def fused_candidates_plain(words: Sequence[torch.Tensor],
                           valid: torch.Tensor, jobs: Sequence[Job],
                           k: int, algo: str) -> torch.Tensor:
    """The torch version: hash every window, then per job sort each
    class's hashes, drop repeats and keep the first REGS."""
    h = torch.where(valid, bias(hash_key_words(words, k, algo)),
                    torch.full_like(valid, SENTINEL_BIASED,
                                    dtype=torch.int64))
    out = torch.full((len(jobs), REGS, CLASSES), SENTINEL_BIASED,
                     dtype=torch.int64, device=valid.device)
    for j, (off, length) in enumerate(jobs):
        rows = -(-length // CLASSES)
        x = torch.full((max(rows, 1) * CLASSES,), SENTINEL_BIASED,
                       dtype=torch.int64, device=valid.device)
        x[:length] = h[off:off + length]
        # (classes, rows): class c holds positions c, c + 2048, ...
        x = torch.sort(x.reshape(-1, CLASSES).T, dim=1).values
        dup = torch.zeros_like(x, dtype=torch.bool)
        dup[:, 1:] = x[:, 1:] == x[:, :-1]
        x = torch.sort(torch.where(dup, SENTINEL_BIASED, x), dim=1).values
        m = min(REGS, x.shape[1])
        out[j, :m] = x[:, :m].T
    return out


def _launch(words: Sequence[torch.Tensor], valid: torch.Tensor,
            jobs: Sequence[Job], algo: str) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    device = valid.device
    out = torch.empty((len(jobs), REGS, CLASSES), dtype=torch.int64,
                      device=device)
    if not jobs:
        return out
    lib = build.load("fused_sketch")
    meta = torch.tensor(jobs, dtype=torch.int64).T.contiguous().to(device)
    w = list(words) + [words[0]] * (3 - len(words))
    stream = torch.cuda.current_stream(device).cuda_stream
    for j0 in range(0, len(jobs), _MAX_JOBS):
        n = min(_MAX_JOBS, len(jobs) - j0)
        err = lib.fused_sketch_launch(
            w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
            valid.data_ptr(), meta[0, j0:].data_ptr(),
            meta[1, j0:].data_ptr(), n, int(algo == "tpufast"),
            out[j0:].data_ptr(), stream)
        build.check("fused_sketch", err)
        LAUNCHES["fused_sketch"] += 1
    return out
