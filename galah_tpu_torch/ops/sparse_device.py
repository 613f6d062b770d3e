"""The screened all-pairs MinHash pass: the port of
``galah_tpu/ops/sparse_device.py`` (its kernel, "blocked", strategy).

The host finds the candidate pairs by exact collision counting
(``ops/collision.candidate_pairs_minhash``, conservative for
merged-bottom-k Mash), the card computes the exact ``(common, total)``
of the survivors only, ``PAIR_BATCH`` pairs per launch of the pairlist
kernel (``ops/pairlist``), and the host applies the exact float64
integer-Jaccard keep-check and reports the float64 ANI. The integers
are those of the dense pass, so the pair dict is the dense pass's,
at O(NK log NK + survivors) instead of O(N^2) tiles.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.collision import candidate_pairs_minhash
from galah_tpu_torch.ops.constants import SENTINEL_U64
from galah_tpu_torch.ops.pairlist import pair_stats_pairs
from galah_tpu_torch.ops.pairwise import ani_to_jaccard, stats_to_ani_f64
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

# candidate pairs per kernel launch
PAIR_BATCH = 8192



def pair_stats_for_pairs(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
                         sketch_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact merged-bottom-k (common, total) int32 for an explicit pair
    list over the (N, K) biased sketch matrix on the device."""
    n_pairs = int(pi.shape[0])
    common = np.empty(n_pairs, dtype=np.int32)
    total = np.empty(n_pairs, dtype=np.int32)
    for s in range(0, n_pairs, PAIR_BATCH):
        e = min(s + PAIR_BATCH, n_pairs)
        bi, bj = (torch.from_numpy(np.ascontiguousarray(x[s:e],
                                                        dtype=np.int64)
                                   ).to(mat.device) for x in (pi, pj))
        c, t = pair_stats_pairs(mat, bi, bj, sketch_size)
        common[s:e] = c.cpu().numpy()
        total[s:e] = t.cpu().numpy()
    return common, total


def threshold_pairs_sparse(mat: torch.Tensor, k: int, min_ani: float,
                           sketch_size: Optional[int] = None,
                           clock: Optional[StageClock] = None
                           ) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} for i<j pairs with ani >= min_ani: collision
    screen on the host, pair stats on the device, exact check on the
    host. `clock` gets the `collision-screen` and `pair-stats` stages
    and the screen's counts."""
    clock = clock or StageClock(mat.device)
    if sketch_size is None:
        sketch_size = mat.shape[1]
    j_thr = ani_to_jaccard(min_ani, k)
    with clock.stage("collision-screen"):
        host = from_biased(mat)
        lens = (host != SENTINEL_U64).sum(axis=1).astype(np.int64)
        pi, pj = candidate_pairs_minhash(host, lens, j_thr, sketch_size)
    clock.count("screen-candidates", int(pi.shape[0]))
    with clock.stage("pair-stats"):
        common, total = pair_stats_for_pairs(mat, pi, pj, sketch_size)
    common = common.astype(np.int64)
    total = total.astype(np.int64)
    keep = common.astype(np.float64) >= j_thr * total
    clock.count("screen-kept-pairs", int(keep.sum()))
    ani = stats_to_ani_f64(common[keep], total[keep], k)
    return {(int(a), int(b)): float(v)
            for a, b, v in zip(pi[keep], pj[keep], ani)}
