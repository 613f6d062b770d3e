"""The k=15 positional window hash of the profiles, from a group's codes.

Given a sequence's codes (uint8: 0-3, 255 ambiguous; one genome, or a
profile group's genomes laid end to end by ``io/group.py``), its sorted
contig starts (int64) and a range of windows, ``positional_hashes``
gives each window the hash of its canonical 15-mer as a biased int64
(``ops/u64.py``): murmur3 x64_128 h1 (seed 0) of its ASCII string, or
the tpufast mixer of its 2-bit pack; the sentinel where the window
holds an ambiguous base or a contig start lies in ``(p, p + 14]``. This
is ``galah_tpu/ops/hashing.py``'s ``_hash_core`` at k=15, which
``galah_tpu`` runs in XLA; no TPU kernel is its counterpart.

On CUDA tensors it launches the hand-written kernel
(``kernels/positional_hashes.cu``), which builds each canonical k-mer,
its validity and its hash from the codes in registers; on CPU tensors
the plain torch version beside it, ``positional_hashes_plain`` (the
route of ``ops/hashing``: ``_window_chunks``, ``_key_words`` and
``masked_hashes``). A CUDA failure raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled
from galah_tpu_torch.ops.hashing import (DEFAULT_CHUNK, _key_words,
                                         _window_chunks, masked_hashes)
from galah_tpu_torch.ops.murmur3_k21 import (check_codes, plain_offsets,
                                             window_range)

K = 15

_ALGOS = {"murmur3": 0, "tpufast": 1}

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("positional_hashes")


def _check_algo(algo: str) -> None:
    if algo not in _ALGOS:
        raise ValueError(f"unknown hash algorithm {algo!r}")


def positional_hashes(codes: torch.Tensor, starts: torch.Tensor,
                      win0: int = 0, n_win: Optional[int] = None,
                      algo: str = "murmur3") -> torch.Tensor:
    """(n_win,) biased int64 hashes of windows [win0, win0 + n_win) of
    `codes` (default: all of them from win0)."""
    check_codes(codes, starts, "positional_hashes")
    _check_algo(algo)
    n_win = window_range(codes, K, win0, n_win, "positional_hashes")
    if codes.device.type == "cpu":
        PROFILE.plain_call(("uint8", n_win, algo),
                           lambda: _cost(n_win, starts.shape[0], algo))
        return positional_hashes_plain(codes, starts, win0, n_win, algo)
    return _launch(codes, starts, win0, n_win, algo)


def _cost(n_win: int, n_starts: int, algo: str) -> costs.Cost:
    return costs.window_hashes(n_win, K, n_starts,
                               costs.K15_OPS_PER_WINDOW[algo])


def positional_hashes_plain(codes: torch.Tensor, starts: torch.Tensor,
                            win0: int = 0, n_win: Optional[int] = None,
                            algo: str = "murmur3",
                            chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The torch version, CPU tensors only: the canonical key words of
    ``ops/hashing._key_words`` over ``_window_chunks``' chunks, hashed
    and masked by ``masked_hashes``."""
    check_codes(codes, starts, "positional_hashes")
    _check_algo(algo)
    if codes.device.type != "cpu":
        raise ValueError("positional_hashes_plain takes CPU tensors")
    n_win = window_range(codes, K, win0, n_win, "positional_hashes")
    out = torch.empty(n_win, dtype=torch.int64)
    if n_win == 0:
        return out
    piece = codes[win0:win0 + n_win + K - 1].numpy()
    for s, e, cs, valid in _window_chunks(
            piece, plain_offsets(starts, win0, piece.shape[0]), K,
            codes.device, chunk):
        out[s:e] = masked_hashes(_key_words(cs, K, algo), valid, K, algo)
    return out


def _launch(codes: torch.Tensor, starts: torch.Tensor, win0: int,
            n_win: int, algo: str) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    out = torch.empty(n_win, dtype=torch.int64, device=codes.device)
    if n_win == 0:
        return out
    lib = build.load("positional_hashes")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with PROFILE.launch(codes.device, ("uint8", n_win, algo),
                        lambda: _cost(n_win, starts.shape[0], algo)):
        # the library launches on the current device: make it the codes'
        with torch.cuda.device(codes.device):
            err = lib.positional_hashes_launch(
                codes.data_ptr(), starts.data_ptr(), starts.shape[0], win0,
                n_win, _ALGOS[algo], out.data_ptr(), stream)
        build.check("positional_hashes", err)
    LAUNCHES["positional_hashes"] += 1
    return out
