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

``group_hashes`` hashes a profile group (``io/group.py``) into one
tensor a genome, from the group's per-genome (first window, window
count) jobs, with the ``--ani-subsample`` cut applied in the same pass:
a hash at or above 2^64 / c becomes the sentinel, as
``ops/fragment_ani.subsample_mask`` does. The windows that straddle two
genomes are not hashed.

On CUDA tensors both launch the hand-written kernel
(``kernels/positional_hashes.cu``), which stages each tile's codes in
shared memory, builds its 2-bit pack and ambiguity and contig-start bits
there, and hashes two neighbouring windows a thread; on CPU tensors the
plain torch
versions beside them, ``positional_hashes_plain`` (the route of
``ops/hashing``: ``_window_chunks``, ``_key_words`` and
``masked_hashes``) and ``group_hashes_plain``. A CUDA failure raises;
nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.u64 import biased_scalar
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


def subsample_cut(subsample_c: int) -> int:
    """The biased cut of ``--ani-subsample c``: hashes at or above it
    become the sentinel. c = 1 keeps every hash (the cut is the
    sentinel itself, which no other biased hash reaches)."""
    if subsample_c == 1:
        return SENTINEL_BIASED
    return biased_scalar((1 << 64) // subsample_c)


def apply_cut(hashes: torch.Tensor, cut: int) -> torch.Tensor:
    """`hashes` with every value at or above `cut` the sentinel."""
    if cut == SENTINEL_BIASED:
        return hashes
    return torch.where(hashes < cut, hashes,
                       torch.full_like(hashes, SENTINEL_BIASED))


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


Jobs = Sequence[Tuple[int, int]]


def group_hashes(codes: torch.Tensor, starts: torch.Tensor, jobs: Jobs,
                 algo: str = "murmur3",
                 subsample_c: int = 1) -> List[torch.Tensor]:
    """One (n,) biased int64 tensor a job (first window, window count n)
    of `codes`: its windows' hashes, those at or above 2^64 / c the
    sentinel. Jobs lie in order, each inside the codes' windows."""
    check_codes(codes, starts, "positional_hashes")
    _check_algo(algo)
    _check_jobs(codes, jobs)
    cut = subsample_cut(subsample_c)
    n_win = sum(n for _, n in jobs)
    if codes.device.type == "cpu":
        PROFILE.plain_call(("group", n_win, algo),
                           lambda: _group_cost([n for _, n in jobs],
                                               starts.shape[0], algo))
        return group_hashes_plain(codes, starts, jobs, algo, subsample_c)
    plan = plan_group(codes, jobs)
    run_group(codes, starts, plan, algo, cut)
    return plan.outs


def _check_jobs(codes: torch.Tensor, jobs: Jobs) -> None:
    end = 0
    for w0, n in jobs:
        if n < 0 or (n > 0 and w0 < end):
            raise ValueError("positional_hashes jobs must be in order and "
                             "not overlap")
        if n > 0:
            window_range(codes, K, w0, n, "positional_hashes")
            end = w0 + n


def _group_cost(counts: Sequence[int], n_starts: int,
                algo: str) -> costs.Cost:
    return costs.group_hashes(counts, K, n_starts,
                              costs.K15_OPS_PER_WINDOW[algo])


def group_hashes_plain(codes: torch.Tensor, starts: torch.Tensor,
                       jobs: Jobs, algo: str = "murmur3",
                       subsample_c: int = 1) -> List[torch.Tensor]:
    """The torch version, CPU tensors only: ``positional_hashes_plain``
    over each job's windows, then the cut."""
    cut = subsample_cut(subsample_c)
    return [apply_cut(positional_hashes_plain(codes, starts, w0, n, algo),
                      cut) if n > 0 else torch.empty(0, dtype=torch.int64)
            for w0, n in jobs]


@dataclasses.dataclass
class GroupLaunch:
    """A group launch's outputs (one tensor a job) and its device table
    (4, genomes with windows): running tile counts, first windows,
    window counts, output addresses."""

    outs: List[torch.Tensor]
    table: Optional[torch.Tensor]
    n_jobs: int
    n_tiles: int
    n_win: int


def plan_group(codes: torch.Tensor, jobs: Jobs) -> GroupLaunch:
    """The outputs and the table of a group launch over `jobs` on the
    codes' (CUDA) device; the table goes up from pinned memory."""
    from galah_tpu_torch.kernels import build

    outs = [torch.empty(n, dtype=torch.int64, device=codes.device)
            for _, n in jobs]
    live = [j for j, (_, n) in enumerate(jobs) if n > 0]
    if not live:
        return GroupLaunch(outs, None, 0, 0, 0)
    # the kernel stores windows in 16-byte pairs, and the group entry
    # cannot see the outputs' addresses (they are in the table)
    if any(outs[j].data_ptr() % 16 for j in live):
        raise ValueError("positional_hashes: a group output is not "
                         "16-byte aligned")
    tile = build.load("positional_hashes").positional_hashes_tile()
    counts = np.array([jobs[j][1] for j in live], dtype=np.int64)
    table = np.stack([np.cumsum(-(-counts // tile)),
                      np.array([jobs[j][0] for j in live], dtype=np.int64),
                      counts,
                      np.array([outs[j].data_ptr() for j in live],
                               dtype=np.int64)])
    dev_table = torch.from_numpy(table).pin_memory().to(codes.device,
                                                        non_blocking=True)
    return GroupLaunch(outs, dev_table, len(live), int(table[0, -1]),
                       int(counts.sum()))


def run_group(codes: torch.Tensor, starts: torch.Tensor,
              plan: GroupLaunch, algo: str, cut: int) -> None:
    """Launch the kernel over a planned group (nothing when no genome
    has a window)."""
    from galah_tpu_torch.kernels import build

    if plan.n_jobs == 0:
        return
    lib = build.load("positional_hashes")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with PROFILE.launch(codes.device, ("group", plan.n_win, algo),
                        lambda: _group_cost(
                            [o.shape[0] for o in plan.outs],
                            starts.shape[0], algo)):
        with torch.cuda.device(codes.device):
            err = lib.positional_hashes_group_launch(
                codes.data_ptr(), starts.data_ptr(), starts.shape[0],
                plan.table.data_ptr(), plan.n_jobs, plan.n_tiles,
                _ALGOS[algo], cut, stream)
        build.check("positional_hashes", err)
    LAUNCHES["positional_hashes"] += 1


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
