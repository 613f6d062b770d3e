"""Pairwise sketch statistics: the port of ``ops/pallas_pairwise.py``.

For sorted, sentinel-padded biased-int64 rows and columns of width K,
int32 ``(common, total)`` per (row, col) pair of the merged bottom-k
distinct union (``galah_tpu/ops/pairwise._pair_stats``), or with
``intersect`` the raw ``|row ∩ col|`` and the row's valid count (the
marker screen's count, ``tile_intersect_counts``). On CUDA tensors
``tile_stats`` launches the hand-written kernel
(``kernels/tile_stats.cu``); on CPU tensors it runs the plain torch
versions beside it. A CUDA failure raises; nothing falls back.

``gather_stats`` is the gathered-tile form (the survivor strategy
``gather`` of ``ops/sparse_device.py``): the full form's integers for
listed cells of 64 x 128 tiles whose rows are named by index into an
(N, K) matrix, the rows read from the matrix in place of a gathered
copy. On the card every segment's tiles go in one launch of the
kernel's gathered entry; ``gather_stats_plain`` gathers the rows, runs
``tile_stats_plain`` over each tile and picks the cells.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled
from galah_tpu_torch.ops.constants import SENTINEL_BIASED

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("tile_stats")
#: the gathered entry's, apart from the full form's
GATHER_PROFILE = profiled("tile_stats_gather")

#: a gathered segment's a rows and b rows (``galah_tpu``'s GATHER_ROWS
#: and GATHER_COLS), and the kernel's tiles of cells within it
GATHER_ROWS = 64
GATHER_COLS = 128
GATHER_TILE = (4, 8)
TILES_PER_SEGMENT = (GATHER_ROWS // GATHER_TILE[0]) * (
    GATHER_COLS // GATHER_TILE[1])

# Numeric contract (GL9xx): the gathered cells are the full form's
# int32 integers, the kernel's and the plain version's equal.
DETERMINISM_CONTRACT = {
    "family": "pairlist",
    "dtype": "int32",
    "functions": ["gather_stats", "gather_stats_plain",
                  "run_gather_launch"],
}


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
        br, k = rows.shape
        PROFILE.plain_call(("int64", br, cols.shape[0], k, bool(intersect)),
                           lambda: costs.tile_stats(br, cols.shape[0], k))
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
    with PROFILE.launch(rows.device, ("int64", br, bc, k, bool(intersect)),
                        lambda: costs.tile_stats(br, bc, k)):
        # the library launches on the current device: make it the rows'
        with torch.cuda.device(rows.device):
            err = lib.tile_stats_launch(
                rows.data_ptr(), cols.data_ptr(), br, bc, k,
                int(sketch_size), int(bool(intersect)), common.data_ptr(),
                total.data_ptr(), stream)
        build.check("tile_stats", err)
    LAUNCHES["tile_stats"] += 1
    return common, total


# -- the gathered-tile form ---------------------------------------------


def _check_gather(mat: torch.Tensor, ua: np.ndarray, ub: np.ndarray,
                  seg: np.ndarray, ra: np.ndarray, rb: np.ndarray) -> None:
    if mat.dtype != torch.int64 or mat.dim() != 2 \
            or not mat.is_contiguous():
        raise ValueError("gather_stats takes a contiguous 2-D int64 "
                         f"matrix; got {mat.dtype} {tuple(mat.shape)}")
    n_seg = ua.shape[0]
    if ua.shape != (n_seg, GATHER_ROWS) or ub.shape != (n_seg, GATHER_COLS):
        raise ValueError(f"gather_stats segment tables {ua.shape} and "
                         f"{ub.shape} are not (S, {GATHER_ROWS}) and "
                         f"(S, {GATHER_COLS})")
    if not seg.shape == ra.shape == rb.shape or seg.ndim != 1:
        raise ValueError("gather_stats cell lists differ in shape")
    if seg.shape[0] >= 1 << 31:
        raise ValueError(f"gather_stats takes fewer than 2^31 cells; got "
                         f"{seg.shape[0]}")
    if n_seg and (min(ua.min(), ub.min()) < 0
                  or max(ua.max(), ub.max()) >= mat.shape[0]):
        raise ValueError(f"gathered row index outside [0, {mat.shape[0]})")
    if seg.shape[0] and (seg.min() < 0 or seg.max() >= n_seg
                         or ra.min() < 0 or ra.max() >= GATHER_ROWS
                         or rb.min() < 0 or rb.max() >= GATHER_COLS):
        raise ValueError("gathered cell outside its segment")


def gather_stats(mat: torch.Tensor, ua: np.ndarray, ub: np.ndarray,
                 seg: np.ndarray, ra: np.ndarray, rb: np.ndarray,
                 sketch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(common, total) int32 numpy arrays, one entry a listed cell: cell
    p is (row ``ua[seg[p], ra[p]]``, col ``ub[seg[p], rb[p]]``) of the
    (N, K) biased matrix `mat`. `ua` is (S, 64) and `ub` (S, 128) int
    row indices. On the card: the plan uploaded in one copy, one launch
    of the gathered entry over every segment, the results read back in
    one copy; on the CPU, ``gather_stats_plain``."""
    ua, ub = np.asarray(ua), np.asarray(ub)
    seg, ra, rb = np.asarray(seg), np.asarray(ra), np.asarray(rb)
    _check_gather(mat, ua, ub, seg, ra, rb)
    n_pairs = seg.shape[0]
    if n_pairs == 0:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    if mat.device.type == "cpu":
        GATHER_PROFILE.plain_call(
            ("int64", ua.shape[0], n_pairs, mat.shape[1]),
            lambda: costs.tile_stats_gather(
                costs.named_rows(ua, ub, seg, ra, rb), ua.shape[0],
                n_pairs, mat.shape[1]))
        c, t = gather_stats_plain(mat, ua, ub, seg, ra, rb, sketch_size)
        return c.numpy(), t.numpy()
    from galah_tpu_torch.ops.pairlist import valid_lengths

    launch = plan_gather(mat.device, ua, ub, seg, ra, rb)
    out = torch.empty((2, n_pairs), dtype=torch.int32, device=mat.device)
    run_gather_launch(mat, valid_lengths(mat), launch, sketch_size, out[0],
                      out[1])
    host = torch.empty((2, n_pairs), dtype=torch.int32, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(mat.device).synchronize()
    got = host.numpy()
    common = np.empty(n_pairs, dtype=np.int32)
    total = np.empty(n_pairs, dtype=np.int32)
    common[launch.order] = got[0]
    total[launch.order] = got[1]
    return common, total


def gather_stats_plain(mat: torch.Tensor, ua: np.ndarray, ub: np.ndarray,
                       seg: np.ndarray, ra: np.ndarray, rb: np.ndarray,
                       sketch_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch version: each segment's rows gathered, the full form's
    plain version over its 64 x 128 cells, the listed cells picked."""
    common = torch.empty(seg.shape[0], dtype=torch.int32)
    total = torch.empty_like(common)
    for s in np.unique(seg).tolist():
        sel = np.flatnonzero(seg == s)
        rows = mat[torch.from_numpy(np.asarray(ua[s], dtype=np.int64))]
        cols = mat[torch.from_numpy(np.asarray(ub[s], dtype=np.int64))]
        c, t = tile_stats_plain(rows.contiguous(), cols.contiguous(),
                                sketch_size)
        a = torch.from_numpy(np.asarray(ra[sel], dtype=np.int64))
        b = torch.from_numpy(np.asarray(rb[sel], dtype=np.int64))
        idx = torch.from_numpy(sel)
        common[idx] = c[a, b].cpu()
        total[idx] = t[a, b].cpu()
    return common, total


@dataclasses.dataclass
class GatherLaunch:
    """A gathered launch's plan on the device: one int32 buffer of the
    segments' a rows (S, 64), b rows (S, 128), the tiles' pair offsets
    (S * 256 + 1) and each pair's cell ``ra * 128 + rb``, in tile
    order; `order[q]` is the input position of the q-th pair of that
    order; `n_rows` the distinct matrix rows the pairs name (the
    bound's bytes, ``costs.tile_stats_gather``)."""

    packed: torch.Tensor
    n_seg: int
    n_pairs: int
    order: np.ndarray
    n_rows: int

    def parts(self) -> Tuple[torch.Tensor, ...]:
        s = self.n_seg
        sizes = [s * GATHER_ROWS, s * GATHER_COLS, s * TILES_PER_SEGMENT + 1,
                 self.n_pairs]
        return tuple(torch.split(self.packed, sizes))


def plan_gather(device: torch.device, ua: np.ndarray, ub: np.ndarray,
                seg: np.ndarray, ra: np.ndarray, rb: np.ndarray
                ) -> GatherLaunch:
    """The launch's plan (``GatherLaunch``): the pairs sorted into tile
    order on the host (stable, so a tile's pairs keep their input
    order), its offsets counted, and the whole plan copied to `device`
    at once from pinned memory."""
    tr, tc = GATHER_TILE
    seg = np.asarray(seg, dtype=np.int64)
    ra = np.asarray(ra, dtype=np.int64)
    rb = np.asarray(rb, dtype=np.int64)
    n_seg = int(np.asarray(ua).shape[0])
    tile = (seg * TILES_PER_SEGMENT + (ra // tr) * (GATHER_COLS // tc)
            + rb // tc)
    order = np.argsort(tile, kind="stable")
    off = np.zeros(n_seg * TILES_PER_SEGMENT + 1, dtype=np.int64)
    np.cumsum(np.bincount(tile, minlength=n_seg * TILES_PER_SEGMENT),
              out=off[1:])
    cells = (ra * GATHER_COLS + rb)[order]
    on_card = device.type == "cuda"
    host = torch.empty(n_seg * (GATHER_ROWS + GATHER_COLS
                                + TILES_PER_SEGMENT) + 1 + cells.shape[0],
                       dtype=torch.int32, pin_memory=on_card)
    flat = np.concatenate([np.asarray(ua).reshape(-1),
                           np.asarray(ub).reshape(-1), off, cells])
    host.copy_(torch.from_numpy(flat.astype(np.int32)))
    return GatherLaunch(host.to(device, non_blocking=True), n_seg,
                        int(cells.shape[0]), order,
                        costs.named_rows(np.asarray(ua), np.asarray(ub),
                                         seg, ra, rb))


def run_gather_launch(mat: torch.Tensor, lens: torch.Tensor,
                      launch: GatherLaunch, sketch_size: int,
                      common: torch.Tensor, total: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered entry alone: one launch over every segment's tiles
    that fills the contiguous int32 (P,) ``common`` and ``total`` in
    the plan's tile order, with ``lens = pairlist.valid_lengths(mat)``."""
    from galah_tpu_torch.kernels import build

    if launch.n_pairs == 0:
        return common, total
    k = mat.shape[1]
    ua, ub, off, cells = launch.parts()
    lib = build.load("tile_stats")
    stream = torch.cuda.current_stream(mat.device).cuda_stream
    with GATHER_PROFILE.launch(
            mat.device, ("int64", launch.n_seg, launch.n_pairs, k),
            lambda: costs.tile_stats_gather(launch.n_rows, launch.n_seg,
                                            launch.n_pairs, k)):
        # the library launches on the current device: make it the
        # matrix's
        with torch.cuda.device(mat.device):
            err = lib.tile_stats_gather_launch(
                mat.data_ptr(), k, lens.data_ptr(), ua.data_ptr(),
                ub.data_ptr(), off.data_ptr(), cells.data_ptr(),
                launch.n_seg, int(sketch_size), common.data_ptr(),
                total.data_ptr(), stream)
        build.check("tile_stats", err)
    LAUNCHES["tile_stats_gather"] += 1
    return common, total
