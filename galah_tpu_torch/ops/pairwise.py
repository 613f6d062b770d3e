"""All-pairs passes over sorted, sentinel-padded hash rows: the port of
``galah_tpu/ops/pairwise.py``'s ``screen_pairs`` and ``threshold_pairs``.

``screen_pairs`` is the marker-containment screen: the i<j pairs whose
containment ``|M_i ∩ M_j| / min(|M_i|, |M_j|)`` reaches the floor (the
skani-equivalent candidate screen, reference: src/skani.rs:54-70).
``threshold_pairs`` is the finch pass: the i<j pairs whose merged-bottom-k
Mash ANI reaches the threshold, with that ANI (reference:
src/finch.rs:69-71).

Below ``collision.SPARSE_SCREEN_MIN_N`` genomes the screen runs the
dense row-block pass: per block of rows, the stripe against every
column at or right of the block's diagonal tile comes from
``tile_stats``' intersect form (the CUDA kernel on the card), a
conservative float64 mask and the compaction run on the device, and the
host applies the exact float64 check. The finch pass runs
``threshold_pairs_streamed``: per block of sketch rows, which may still
be arriving (``ops/sketch_stream.iter_sketch_row_blocks``), one stripe
of every row seen so far against the block's columns through
``tile_stats``' full form, and the exact float64 check on the host.
From the crossover up, both take the host collision screen
(``ops/collision.py``) instead: the screen's counts are its exact
containment numerators, and finch evaluates the collision survivors
with the pairlist kernel (``ops/sparse_device.py``). Either way the
result is the same.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops import collision
from galah_tpu_torch.ops.compact import iter_blocks
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

ROW_TILE = 64
COL_TILE = 256
CAP_PER_ROW = 256


def ani_to_jaccard(min_ani: float, k: int) -> float:
    """Invert Mash ANI to the equivalent Jaccard threshold (f64, exact)."""
    q = math.exp(-float(k) * (1.0 - float(min_ani)))
    return q / (2.0 - q)


def stats_to_ani_f64(common: np.ndarray, total: np.ndarray,
                     k: int) -> np.ndarray:
    """Host-side f64 Mash ANI from integer (common, total)."""
    j = common.astype(np.float64) / np.maximum(total.astype(np.float64), 1.0)
    with np.errstate(divide="ignore"):
        d = -np.log(2.0 * j / (1.0 + j)) / float(k)
    return np.where(common > 0, 1.0 - d, 0.0)


def note_survival(candidates: int, kept: int) -> None:
    """The ``screen.survival_rate`` gauge: the kept share of the last
    screening pass's candidate pairs."""
    obs_metrics.gauge(
        "screen.survival_rate",
        help="Fraction of screened candidate pairs the threshold "
             "kept (last screening pass)", unit="fraction").set(
        kept / candidates if candidates else 0.0)


def _pad_rows(mat: torch.Tensor, quantum: int) -> torch.Tensor:
    """`mat` with sentinel rows appended up to a multiple of `quantum`."""
    n_pad = -(-mat.shape[0] // quantum) * quantum
    out = torch.full((n_pad, mat.shape[1]), SENTINEL_BIASED,
                     dtype=torch.int64, device=mat.device)
    out[:mat.shape[0]] = mat
    return out


def _rowblock_screen(mat: torch.Tensor, counts: torch.Tensor, r0: int,
                     c_floor_lo: float, n: int, row_tile: int,
                     col_tile: int, cap: int):
    """One row block: the (row_tile, n_pad) intersection stripe,
    containment-thresholded and compacted on the device.

    Returns (flat_idx, inter, count): up to `cap` flat indices into the
    stripe and their raw intersection counts, and the true number of
    passing entries. Column tiles wholly below the block's diagonal
    hold no i<j pair and are not computed.
    """
    n_pad = mat.shape[0]
    c0 = (r0 // col_tile) * col_tile
    rows = mat[r0:r0 + row_tile]
    inter = torch.zeros(row_tile, n_pad, dtype=torch.int32,
                        device=mat.device)
    inter[:, c0:], _ = tile_stats(rows, mat[c0:], mat.shape[1],
                                  intersect=True)
    rcnt = counts[r0:r0 + row_tile]
    denom = torch.minimum(rcnt[:, None], counts[None, :])
    gi = r0 + torch.arange(row_tile, device=mat.device)[:, None]
    gj = torch.arange(n_pad, device=mat.device)[None, :]
    mask = inter.to(torch.float64) >= c_floor_lo * denom.to(torch.float64)
    mask &= (inter > 0) & (gi < gj) & (gj < n)
    flat_idx = torch.nonzero(mask.reshape(-1))[:, 0]
    count = int(flat_idx.shape[0])
    flat_idx = flat_idx[:cap]
    return flat_idx, inter.reshape(-1)[flat_idx], count


def screen_pairs(marker_mat: torch.Tensor, counts: np.ndarray,
                 c_floor: float, row_tile: int = ROW_TILE,
                 col_tile: int = COL_TILE,
                 cap_per_row: int = CAP_PER_ROW,
                 clock: Optional[StageClock] = None
                 ) -> List[Tuple[int, int]]:
    """i<j pairs whose marker containment >= c_floor, in row-major
    order. `marker_mat` is (N, M) biased int64 on the device, sorted
    and sentinel-padded; `counts` the per-genome marker counts.
    `clock` gets the count ``screen-possible-pairs``, and on the
    collision route ``screen-candidates`` and ``screen-kept-pairs``
    (``galah_tpu`` counts the three on that route only)."""
    clock = clock or StageClock(marker_mat.device)
    n = marker_mat.shape[0]
    counts64 = np.asarray(counts, dtype=np.int64)
    clock.count("screen-possible-pairs", n * (n - 1) // 2)
    if n >= collision.SPARSE_SCREEN_MIN_N:
        # the collision counts ARE the containment numerators (marker
        # sets are distinct), so the exact check needs no second pass
        pi, pj, inter = collision.collision_pair_counts(
            from_biased(marker_mat), counts64)
        denom = np.minimum(counts64[pi], counts64[pj]).astype(np.float64)
        keep = (denom > 0) & (inter.astype(np.float64) >= c_floor * denom)
        clock.count("screen-candidates", int(pi.shape[0]))
        clock.count("screen-kept-pairs", int(keep.sum()))
        note_survival(int(pi.shape[0]), int(keep.sum()))
        return list(zip(pi[keep].tolist(), pj[keep].tolist()))
    device = marker_mat.device
    mat = _pad_rows(marker_mat, math.lcm(row_tile, col_tile))
    n_pad = mat.shape[0]
    cnt = torch.zeros(n_pad, dtype=torch.int32, device=device)
    cnt[:n] = torch.from_numpy(counts64).to(device=device,
                                            dtype=torch.int32)
    c_floor_lo = c_floor * (1.0 - 1e-12) - 1e-300

    out: List[Tuple[int, int]] = []
    for r0, (flat_idx, inter, count) in iter_blocks(
            n, row_tile, cap_per_row,
            lambda r0, cap: _rowblock_screen(
                mat, cnt, r0, c_floor_lo, n, row_tile, col_tile, cap)):
        flat_idx = flat_idx[:count].cpu().numpy()
        inter = inter[:count].cpu().numpy().astype(np.int64)
        gi = r0 + flat_idx // n_pad
        gj = flat_idx % n_pad
        # exact host-side containment check (denom > 0 keeps it
        # self-contained; the device mask already requires inter > 0)
        denom = np.minimum(counts64[gi], counts64[gj]).astype(np.float64)
        keep = (denom > 0) & (inter.astype(np.float64) >= c_floor * denom)
        out.extend(zip(gi[keep].tolist(), gj[keep].tolist()))
    return out


def threshold_pairs(sketch_mat: torch.Tensor, k: int, min_ani: float,
                    sketch_size: Optional[int] = None,
                    clock: Optional[StageClock] = None
                    ) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} for i<j pairs whose float64 Mash ANI reaches
    `min_ani`, over an (N, K) biased sketch matrix on the device: the
    streamed pass over its blocks of COL_TILE rows below the sparse
    crossover, the collision screen and pairlist pass
    (``sparse_device``) from it up. `clock` gets the stages
    (`pair-stats`, and `collision-screen` when sparse)."""
    clock = clock or StageClock(sketch_mat.device)
    if sketch_size is None:
        sketch_size = sketch_mat.shape[1]
    n = sketch_mat.shape[0]
    if n >= collision.SPARSE_SCREEN_MIN_N:
        from galah_tpu_torch.ops.sparse_device import threshold_pairs_sparse

        return threshold_pairs_sparse(sketch_mat, k, min_ani, sketch_size,
                                      clock)
    blocks = ((r0, sketch_mat[r0:r0 + COL_TILE])
              for r0 in range(0, n, COL_TILE))
    return threshold_pairs_streamed(blocks, n, k, min_ani, sketch_size,
                                    clock)


def threshold_pairs_streamed(
    blocks: Iterable[Tuple[int, torch.Tensor]],
    n: int,
    k: int,
    min_ani: float,
    sketch_size: int,
    clock: Optional[StageClock] = None,
    block: int = COL_TILE,
) -> Dict[Tuple[int, int], float]:
    """``threshold_pairs`` below the sparse crossover, over ``(r0,
    rows)`` blocks of at most `block` biased sketch rows on the device
    that may still be arriving (``ops/sketch_stream
    .iter_sketch_row_blocks``): the rows come in order, r0 = 0, then
    each block's end.

    Per block, one stripe: every row seen so far, padded with sentinel
    rows to a power of two (at least ``ROW_TILE``), against the block
    padded to `block` columns, in one launch of ``tile_stats``' full
    form. Every pair i < j is covered once (rows [0, r1) x columns
    [r0, r1)), and the exact float64 check runs on the host over the
    integers. ``common > 0`` drops the sentinel padding (a sentinel row
    shares nothing). `clock` gets the `pair-stats` stage and the
    `pairs-streamed-stripes` and `screen-possible-pairs` counts."""
    clock = clock or StageClock(torch.device("cpu"))
    clock.count("screen-possible-pairs", n * (n - 1) // 2)
    j_thr = ani_to_jaccard(min_ani, k)
    r_cap = ROW_TILE
    while r_cap < n:
        r_cap <<= 1
    done: Optional[torch.Tensor] = None
    r1 = 0
    out: Dict[Tuple[int, int], float] = {}
    for r0, rows in blocks:
        bsz = rows.shape[0]
        if r0 != r1 or bsz > block or r0 + bsz > n:
            raise ValueError(f"streamed sketch block of {bsz} rows at "
                             f"{r0} does not follow row {r1} of {n}")
        if done is None:
            done = torch.full((r_cap, rows.shape[1]), SENTINEL_BIASED,
                              dtype=torch.int64, device=rows.device)
        done[r0:r0 + bsz] = rows
        r1 = r0 + bsz
        r_pad = ROW_TILE
        while r_pad < r1:
            r_pad <<= 1
        with clock.stage("pair-stats"):
            cols = torch.full((block, rows.shape[1]), SENTINEL_BIASED,
                              dtype=torch.int64, device=rows.device)
            cols[:bsz] = rows
            common, total = tile_stats(done[:r_pad], cols, sketch_size)
            common = common.cpu().numpy().astype(np.int64)
            total = total.cpu().numpy().astype(np.int64)
        clock.count("pairs-streamed-stripes", 1)
        gi = np.arange(r_pad)[:, None]
        gj = r0 + np.arange(block)[None, :]
        keep = ((gi < gj) & (gj < r1) & (common > 0)
                & (common.astype(np.float64) >= j_thr * total))
        ki, kj = np.nonzero(keep)
        ani = stats_to_ani_f64(common[keep], total[keep], k)
        out.update(zip(zip(ki.tolist(), (r0 + kj).tolist()), ani.tolist()))
    if r1 != n:
        raise ValueError(f"streamed pair pass saw {r1} rows, expected {n}")
    return out
