"""Merged-bottom-k statistics over an explicit pair list: the port of
``ops/pallas_pairlist.py``.

For a sorted, sentinel-padded (N, K) biased-int64 sketch matrix and
index lists ``pi``, ``pj``, int32 ``(common, total)`` per pair, the
integers ``tile_stats``' full form gives for that (row, col)
(``galah_tpu/ops/pairwise._pair_stats``). The rows are read where they
lie in the matrix; no gathered copies are made on the card. On CUDA
tensors ``pair_stats_pairs`` launches the hand-written kernel
(``kernels/pairlist.cu``, a warp per pair over the merge path of
``kernels/merge_walk.cuh``); on CPU tensors it runs the plain torch
version beside it. A CUDA failure raises; nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled
from galah_tpu_torch.ops.constants import SENTINEL_BIASED

# Numeric contract (GL9xx): the pair statistics are int32 counts, the
# kernel's and the plain version's equal (galah_tpu's pallas_pairlist).
DETERMINISM_CONTRACT = {
    "family": "pairlist",
    "dtype": "int32",
    "functions": ["pair_stats_pairs", "pair_stats_pairs_plain",
                  "run_launch"],
}

# widest sketch a pair list may carry (galah_tpu's pairlist contract)
MAX_K = 16384

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("pairlist")


def _check(mat: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor) -> None:
    if mat.dtype != torch.int64 or mat.dim() != 2 \
            or not mat.is_contiguous():
        raise ValueError("pair_stats_pairs takes a contiguous 2-D int64 "
                         f"matrix; got {mat.dtype} {tuple(mat.shape)}")
    if mat.shape[1] > MAX_K:
        raise ValueError(f"sketch width {mat.shape[1]} exceeds {MAX_K}")
    for t in (pi, pj):
        if t.dtype != torch.int64 or t.dim() != 1 \
                or not t.is_contiguous() or t.device != mat.device \
                or t.shape != pi.shape:
            raise ValueError(
                "pair_stats_pairs takes equal-length contiguous 1-D int64 "
                f"index lists on {mat.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if pi.numel():
        lo, hi = torch.stack(torch.aminmax(torch.cat((pi, pj)))).tolist()
        if lo < 0 or hi >= mat.shape[0]:
            raise ValueError(f"pair index outside [0, {mat.shape[0]})")


def valid_lengths(mat: torch.Tensor) -> torch.Tensor:
    """int32 (N,): each row's valid prefix, the values before the
    sentinel padding."""
    return (mat != SENTINEL_BIASED).sum(dim=1, dtype=torch.int32)


def pair_stats_pairs(mat: torch.Tensor, pi: torch.Tensor,
                     pj: torch.Tensor, sketch_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(common, total) int32 (B,) for the pairs (mat[pi[p]], mat[pj[p]])."""
    _check(mat, pi, pj)
    common = torch.empty(pi.shape[0], dtype=torch.int32, device=mat.device)
    total = torch.empty_like(common)
    return run_launch(mat, valid_lengths(mat), pi, pj, sketch_size,
                      common, total)


def pair_stats_pairs_plain(mat: torch.Tensor, pi: torch.Tensor,
                           pj: torch.Tensor, sketch_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch version: the pairs' rows gathered, a batched
    ``searchsorted`` of a in b, and the union ranks by cumulative sum."""
    a, b = mat[pi], mat[pj]
    k = mat.shape[1]
    pos = torch.searchsorted(b, a)
    hit = torch.gather(b, 1, pos.clamp(max=k - 1)) == a
    match = (pos < k) & hit & (a != SENTINEL_BIASED)
    m = match.to(torch.int32)
    na = (a != SENTINEL_BIASED).sum(dim=1, dtype=torch.int32)
    nb = (b != SENTINEL_BIASED).sum(dim=1, dtype=torch.int32)
    total = torch.clamp(na + nb - m.sum(dim=1, dtype=torch.int32),
                        max=sketch_size)
    cexcl = torch.cumsum(m, dim=1, dtype=torch.int32) - m
    idx = torch.arange(k, dtype=torch.int32, device=mat.device)
    urank = idx + pos.to(torch.int32) - cexcl
    common = (match & (urank < total[:, None])).sum(dim=1,
                                                     dtype=torch.int32)
    return common, total


def run_launch(mat: torch.Tensor, lens: torch.Tensor, pi: torch.Tensor,
               pj: torch.Tensor, sketch_size: int, common: torch.Tensor,
               total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone, on checked tensors: one launch that fills the
    contiguous int32 (B,) ``common`` and ``total`` for the in-range
    int64 (B,) ``pi``, ``pj``, with ``lens = valid_lengths(mat)``. On
    CPU tensors the plain version fills them."""
    b = pi.shape[0]
    if b == 0:
        return common, total
    signature = ("int64", mat.shape[0], mat.shape[1], b)
    if mat.device.type == "cpu":
        c, t = pair_stats_pairs_plain(mat, pi, pj, sketch_size)
        common.copy_(c)
        total.copy_(t)
        PROFILE.plain_call(signature,
                           lambda: _cost(mat, pi, pj, common, total))
        return common, total
    from galah_tpu_torch.kernels import build

    lib = build.load("pairlist")
    stream = torch.cuda.current_stream(mat.device).cuda_stream
    with PROFILE.launch(mat.device, signature,
                        lambda: _cost(mat, pi, pj, common, total)):
        # the library launches on the current device: make it the
        # matrix's
        with torch.cuda.device(mat.device):
            err = lib.pairlist_launch(mat.data_ptr(), mat.shape[1],
                                      lens.data_ptr(), pi.data_ptr(),
                                      pj.data_ptr(), b, int(sketch_size),
                                      common.data_ptr(), total.data_ptr(),
                                      stream)
        build.check("pairlist", err)
    LAUNCHES["pairlist"] += 1
    return common, total


def _cost(mat: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
          common: torch.Tensor, total: torch.Tensor) -> costs.Cost:
    """(bytes, operations) of one launch as device scalars, queued after
    it on its stream (no host wait): the distinct rows the list uses
    and the merge items its results take."""
    used = torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    used[pi] = True
    used[pj] = True
    items = common.sum(dtype=torch.int64) + total.sum(dtype=torch.int64)
    return (costs.pairlist_bytes(used.sum(), pi.shape[0], mat.shape[1]),
            costs.pairlist_ops(items))
