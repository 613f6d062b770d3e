"""The k=21 murmur3 window hash: the port of ``ops/pallas_sketch.py``'s
``murmur3_k21_pallas``.

Given the canonical key words of windows (``ops/hashing
.canonical_key_words`` at k=21: bytes 0-7, 8-15 and 16-20 of the
canonical ASCII k-mer) and the window mask, ``murmur3_k21`` gives each
window its murmur3 x64_128 h1 (seed 0, length 21) as a biased int64
(``ops/u64.py``), the sentinel where the mask is false. On CUDA tensors
it launches the hand-written kernel (``kernels/murmur3_k21.cu``); on
CPU tensors the plain torch version beside it, ``murmur3_k21_plain``. A
CUDA failure raises; nothing falls back.

``galah_tpu`` runs its kernel only behind ``GALAH_TPU_PALLAS_HASH=1``,
because the TPU has no 64-bit multiply; the card has one, so on
``cuda`` every k=21 murmur3 window hash outside the fused sketch kernel
runs here: HLL sketching and the exact MinHash sketch
(``ops/hashing.positional_hashes``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.hashing import hash_key_words
from galah_tpu_torch.ops.u64 import bias


def _check(words: Sequence[torch.Tensor], valid: torch.Tensor) -> None:
    if valid.dtype != torch.bool or valid.dim() != 1 \
            or not valid.is_contiguous():
        raise ValueError("murmur3_k21 mask must be contiguous 1-D bool")
    if len(words) != 3:
        raise ValueError(f"murmur3_k21 takes 3 key words; got {len(words)}")
    n = valid.shape[0]
    for t in words:
        if t.dtype != torch.int64 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous() or t.device != valid.device:
            raise ValueError(
                "murmur3_k21 key words must be contiguous 1-D int64 "
                f"tensors of the mask's length {n} on {valid.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def murmur3_k21(words: Sequence[torch.Tensor],
                valid: torch.Tensor) -> torch.Tensor:
    """(n,) biased int64 hashes of `n` windows' key words."""
    _check(words, valid)
    if valid.device.type == "cpu":
        return murmur3_k21_plain(words, valid)
    return _launch(words, valid)


def murmur3_k21_plain(words: Sequence[torch.Tensor],
                      valid: torch.Tensor) -> torch.Tensor:
    """The torch version: ~40 elementwise int64 ops (``hash_key_words``)."""
    h = hash_key_words(words, 21, "murmur3")
    return torch.where(valid, bias(h), torch.full_like(h, SENTINEL_BIASED))


def _launch(words: Sequence[torch.Tensor],
            valid: torch.Tensor) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    out = torch.empty(valid.shape[0], dtype=torch.int64, device=valid.device)
    if valid.shape[0] == 0:
        return out
    lib = build.load("murmur3_k21")
    stream = torch.cuda.current_stream(valid.device).cuda_stream
    err = lib.murmur3_k21_launch(
        words[0].data_ptr(), words[1].data_ptr(), words[2].data_ptr(),
        valid.data_ptr(), valid.shape[0], out.data_ptr(), stream)
    build.check("murmur3_k21", err)
    LAUNCHES["murmur3_k21"] += 1
    return out
