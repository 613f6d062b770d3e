"""The marker-containment screen: the port of the dense row-block path
of ``galah_tpu/ops/pairwise.py`` (``screen_pairs`` ->
``_screen_pairs_single`` -> ``_rowblock_screen``).

For N genomes with sorted, sentinel-padded marker rows, the i<j pairs
whose containment ``|M_i ∩ M_j| / min(|M_i|, |M_j|)`` reaches the
floor (the skani-equivalent candidate screen, reference:
src/skani.rs:54-70). Per row block, the intersection stripe comes from
``tile_stats`` in its intersect form (the CUDA kernel on the card), a
conservative float64 mask and the compaction run on the device, and
the host applies the exact float64 check. The port runs this dense
screen at every N; ``galah_tpu``'s sparse collision screen above 1024
genomes gives the same pair list and is not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.compact import iter_blocks
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats

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
                 cap_per_row: int = CAP_PER_ROW) -> List[Tuple[int, int]]:
    """i<j pairs whose marker containment >= c_floor, in row-major
    order. `marker_mat` is (N, M) biased int64 on the device, sorted
    and sentinel-padded; `counts` the per-genome marker counts."""
    n = marker_mat.shape[0]
    device = marker_mat.device
    quantum = math.lcm(row_tile, col_tile)
    n_pad = -(-n // quantum) * quantum
    mat = torch.full((n_pad, marker_mat.shape[1]), SENTINEL_BIASED,
                     dtype=torch.int64, device=device)
    mat[:n] = marker_mat
    counts64 = np.asarray(counts, dtype=np.int64)
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
