"""Pairwise sketch statistics: the port of ``ops/pallas_pairwise.py``.

For sorted, sentinel-padded biased-int64 rows and columns of width K,
int32 ``(common, total)`` per (row, col) pair of the merged bottom-k
distinct union (``galah_tpu/ops/pairwise._pair_stats``), or with
``intersect`` the raw ``|row ∩ col|`` and the row's valid count (the
marker screen's count, ``tile_intersect_counts``). On CUDA tensors
``tile_stats`` launches the hand-written kernel
(``kernels/tile_stats.cu``); on CPU tensors it runs the plain torch
versions beside it. A CUDA failure raises; nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED


def _check(rows: torch.Tensor, cols: torch.Tensor) -> None:
    for t in (rows, cols):
        if t.dtype != torch.int64 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(
                "tile_stats takes contiguous 2-D int64 tensors; got "
                f"{t.dtype} {tuple(t.shape)}")
    if rows.device != cols.device or rows.shape[1] != cols.shape[1]:
        raise ValueError(
            f"tile_stats rows {tuple(rows.shape)} on {rows.device} and "
            f"cols {tuple(cols.shape)} on {cols.device} do not match")


def tile_stats(rows: torch.Tensor, cols: torch.Tensor, sketch_size: int,
               intersect: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(common, total) int32 (Br, Bc)."""
    _check(rows, cols)
    if rows.device.type == "cpu":
        if intersect:
            return (tile_intersect_plain(rows, cols),
                    _valid_counts(rows)[:, None].expand(
                        -1, cols.shape[0]).contiguous())
        return tile_stats_plain(rows, cols, sketch_size)
    return _launch(rows, cols, sketch_size, intersect)


def _valid_counts(m: torch.Tensor) -> torch.Tensor:
    return (m != SENTINEL_BIASED).sum(dim=1, dtype=torch.int32)


def _row_match(a: torch.Tensor, cols: torch.Tensor):
    """(pos_b, match) of row `a` against every column: pos_b = #(b <
    a_i), match = a_i valid and present in b."""
    k = cols.shape[1]
    pos = torch.searchsorted(cols, a.expand(cols.shape[0], k).contiguous())
    hit = torch.gather(cols, 1, pos.clamp(max=k - 1)) == a
    return pos, (pos < k) & hit & (a != SENTINEL_BIASED)


def tile_intersect_plain(rows: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """|row ∩ col| int32 (Br, Bc) (``pairwise.tile_intersect_counts``)."""
    out = torch.zeros(rows.shape[0], cols.shape[0], dtype=torch.int32,
                      device=rows.device)
    for i in range(rows.shape[0]):
        _pos, match = _row_match(rows[i], cols)
        out[i] = match.sum(dim=1, dtype=torch.int32)
    return out


def tile_stats_plain(rows: torch.Tensor, cols: torch.Tensor,
                     sketch_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(common, total) int32 (Br, Bc) (``pairwise.tile_stats``)."""
    br, k = rows.shape
    common = torch.zeros(br, cols.shape[0], dtype=torch.int32,
                         device=rows.device)
    total = torch.zeros_like(common)
    nb = _valid_counts(cols)
    na = _valid_counts(rows)
    idx = torch.arange(k, dtype=torch.int32, device=rows.device)
    for i in range(br):
        pos, match = _row_match(rows[i], cols)
        m = match.to(torch.int32)
        n_common = m.sum(dim=1, dtype=torch.int32)
        tot = torch.clamp(na[i] + nb - n_common, max=sketch_size)
        cexcl = torch.cumsum(m, dim=1, dtype=torch.int32) - m
        urank = idx + pos.to(torch.int32) - cexcl
        common[i] = (match & (urank < tot[:, None])).sum(
            dim=1, dtype=torch.int32)
        total[i] = tot
    return common, total


def _launch(rows: torch.Tensor, cols: torch.Tensor, sketch_size: int,
            intersect: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    common = torch.empty(rows.shape[0], cols.shape[0], dtype=torch.int32,
                         device=rows.device)
    total = torch.empty_like(common)
    return run_launch(rows, cols, sketch_size, intersect, common, total)


def run_launch(rows: torch.Tensor, cols: torch.Tensor, sketch_size: int,
               intersect: bool, common: torch.Tensor, total: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone: one launch that fills every entry of the
    contiguous int32 (Br, Bc) ``common`` and ``total``."""
    from galah_tpu_torch.kernels import build

    br, k = rows.shape
    bc = cols.shape[0]
    if br == 0 or bc == 0:
        return common, total
    lib = build.load("tile_stats")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.tile_stats_launch(
        rows.data_ptr(), cols.data_ptr(), br, bc, k, int(sketch_size),
        int(bool(intersect)), common.data_ptr(), total.data_ptr(), stream)
    build.check("tile_stats", err)
    LAUNCHES["tile_stats"] += 1
    return common, total
