"""The k=21 murmur3 window hash: the port of ``ops/pallas_sketch.py``'s
``murmur3_k21_pallas`` together with the key-word preamble it consumes
(``galah_tpu/ops/hashing.py``'s ``_murmur3_k21_1d``).

Given a sequence's codes (uint8: 0-3, 255 ambiguous; one genome, or a
launch group's genomes laid end to end), its sorted contig starts
(int64) and a range of windows, ``murmur3_k21`` gives each window the
murmur3 x64_128 h1 (seed 0, length 21) of its canonical ASCII 21-mer as
a biased int64 (``ops/u64.py``), the sentinel where the window holds an
ambiguous base or a contig start lies in ``(p, p + 20]``. On CUDA
tensors it launches the hand-written kernel
(``kernels/murmur3_k21.cu``), which builds each canonical k-mer and its
validity from the codes in registers; on CPU tensors the plain torch
version beside it, ``murmur3_k21_plain`` (``ops/hashing
.canonical_key_words`` and ``hash_key_words``). A CUDA failure raises;
nothing falls back.

``galah_tpu`` runs its kernel only behind ``GALAH_TPU_PALLAS_HASH=1``,
because the TPU has no 64-bit multiply; the card has one, so on
``cuda`` every k=21 murmur3 window hash outside the fused sketch kernel
runs here: HLL sketching and the exact MinHash sketch
(``ops/hashing.positional_hashes``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.hashing import canonical_key_words, hash_key_words
from galah_tpu_torch.ops.u64 import bias

K = 21

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("murmur3_k21")


def check_codes(codes: torch.Tensor, starts: torch.Tensor,
                what: str) -> None:
    """Raise unless `codes` is contiguous 1-D uint8 and `starts`
    contiguous 1-D int64 on the same device."""
    if codes.dtype != torch.uint8 or codes.dim() != 1 \
            or not codes.is_contiguous():
        raise ValueError(f"{what} codes must be contiguous 1-D uint8; got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if starts.dtype != torch.int64 or starts.dim() != 1 \
            or not starts.is_contiguous() or starts.device != codes.device:
        raise ValueError(
            f"{what} contig starts must be contiguous 1-D int64 on "
            f"{codes.device}; got {starts.dtype} {tuple(starts.shape)} on "
            f"{starts.device}")


def plain_offsets(starts: torch.Tensor, lo: int, n: int) -> np.ndarray:
    """The contig offsets of codes[lo:lo + n] in ``_window_chunks``'
    form (0, the starts strictly inside, n) from sorted absolute
    `starts`."""
    s = starts.numpy() - lo
    return np.concatenate(([0], s[(s > 0) & (s < n)], [n])).astype(np.int64)


def window_range(codes: torch.Tensor, k: int, win0: int,
                 n_win: Optional[int], what: str) -> int:
    """The window count of [win0, win0 + n_win) (n_win None: to the
    end); raise unless the range lies inside the codes' windows of
    width `k`."""
    total = max(codes.shape[0] - k + 1, 0)
    if n_win is None:
        n_win = total - win0
    if win0 < 0 or n_win < 0 or win0 + n_win > total:
        raise ValueError(f"{what} windows [{win0}, {win0 + n_win}) lie "
                         f"outside the {total} windows of the codes")
    return n_win


def murmur3_k21(codes: torch.Tensor, starts: torch.Tensor, win0: int = 0,
                n_win: Optional[int] = None) -> torch.Tensor:
    """(n_win,) biased int64 hashes of windows [win0, win0 + n_win) of
    `codes` (default: all of them from win0)."""
    check_codes(codes, starts, "murmur3_k21")
    n_win = window_range(codes, K, win0, n_win, "murmur3_k21")
    if codes.device.type == "cpu":
        PROFILE.plain_call(("uint8", n_win),
                           lambda: _cost(n_win, starts.shape[0]))
        return murmur3_k21_plain(codes, starts, win0, n_win)
    return _launch(codes, starts, win0, n_win)


def _cost(n_win: int, n_starts: int) -> costs.Cost:
    return costs.window_hashes(n_win, K, n_starts,
                               costs.MURMUR3_K21_OPS_PER_WINDOW)


def murmur3_k21_plain(codes: torch.Tensor, starts: torch.Tensor,
                      win0: int = 0,
                      n_win: Optional[int] = None) -> torch.Tensor:
    """The torch version, CPU tensors only: the canonical key words of
    ``ops/hashing.canonical_key_words`` hashed by ``hash_key_words``."""
    check_codes(codes, starts, "murmur3_k21")
    if codes.device.type != "cpu":
        raise ValueError("murmur3_k21_plain takes CPU tensors")
    n_win = window_range(codes, K, win0, n_win, "murmur3_k21")
    piece = codes[win0:win0 + n_win + K - 1].numpy()
    words, valid = canonical_key_words(
        piece, plain_offsets(starts, win0, piece.shape[0]), K, "cpu",
        "murmur3")
    h = hash_key_words(words, K, "murmur3")
    return torch.where(valid, bias(h), torch.full_like(h, SENTINEL_BIASED))


def _launch(codes: torch.Tensor, starts: torch.Tensor, win0: int,
            n_win: int) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    out = torch.empty(n_win, dtype=torch.int64, device=codes.device)
    if n_win == 0:
        return out
    lib = build.load("murmur3_k21")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with PROFILE.launch(codes.device, ("uint8", n_win),
                        lambda: _cost(n_win, starts.shape[0])):
        # the library launches on the current device: make it the codes'
        with torch.cuda.device(codes.device):
            err = lib.murmur3_k21_launch(
                codes.data_ptr(), starts.data_ptr(), starts.shape[0], win0,
                n_win, out.data_ptr(), stream)
        build.check("murmur3_k21", err)
    LAUNCHES["murmur3_k21"] += 1
    return out
