"""The screened all-pairs MinHash pass: the port of
``galah_tpu/ops/sparse_device.py`` (its kernel, "blocked", strategy).

The host finds the candidate pairs by exact collision counting
(``ops/collision.candidate_pairs_minhash``, conservative for
merged-bottom-k Mash), the card computes the exact ``(common, total)``
of the survivors only (the list uploaded once, one launch of the
pairlist kernel, ``ops/pairlist``, the results downloaded once), and the host applies the exact float64
integer-Jaccard keep-check and reports the float64 ANI. The integers
are those of the dense pass, so the pair dict is the dense pass's,
at O(NK log NK + survivors) instead of O(N^2) tiles. Over a device mesh
(``parallel/mesh.py``) the candidate list is split into one chunk a
slot, one pairlist launch each (``galah_tpu/ops/sparse_device.py``'s
sharded batch).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.collision import candidate_pairs_minhash
from galah_tpu_torch.ops.constants import SENTINEL_U64
from galah_tpu_torch.ops.pairlist import run_launch, valid_lengths
from galah_tpu_torch.ops.pairwise import (ani_to_jaccard, note_survival,
                                          stats_to_ani_f64)
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

# Numeric contract (GL9xx): int32 pair statistics whatever the batch
# cut, then the exact float64 check on the host.
DETERMINISM_CONTRACT = {
    "family": "pairlist",
    "dtype": "int32",
    "functions": ["pair_stats_for_pairs", "enqueue_pair_stats",
                  "collect_pair_stats", "threshold_pairs_sparse"],
}

# candidate pairs per call of the plain version on the CPU (the card
# takes the whole list in one launch)
PAIR_BATCH = 1 << 16


def pair_stats_for_pairs(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
                         sketch_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact merged-bottom-k (common, total) int32 for an explicit pair
    list over the (N, K) biased sketch matrix on the device.

    The indices are checked once, on the host, and go to the device in
    one copy, from pinned memory; one launch of the pairlist kernel
    takes the whole list (on the CPU, the plain version takes it
    PAIR_BATCH pairs at a time), and the results come back in one copy.
    The host side runs in torch, whose copies and reductions of large
    CPU tensors use every core."""
    return collect_pair_stats(enqueue_pair_stats(mat, pi, pj, sketch_size))


def enqueue_pair_stats(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
                     sketch_size: int) -> Tuple[torch.Tensor, torch.device]:
    """``pair_stats_for_pairs`` up to its wait: the checked list
    uploaded, the launch enqueued and the results' copy to the host
    queued. Returns (the (2, B) int32 host buffer, the device to wait
    for) for ``collect_pair_stats``."""
    hpi = torch.from_numpy(np.ascontiguousarray(pi, dtype=np.int64))
    hpj = torch.from_numpy(np.ascontiguousarray(pj, dtype=np.int64))
    if hpi.shape != hpj.shape or hpi.dim() != 1:
        raise ValueError(f"pair lists differ in shape: {tuple(pi.shape)} "
                         f"{tuple(pj.shape)}")
    n_pairs = hpi.shape[0]
    if n_pairs:
        (lo_i, hi_i), (lo_j, hi_j) = torch.aminmax(hpi), torch.aminmax(hpj)
        if min(lo_i, lo_j) < 0 or max(hi_i, hi_j) >= mat.shape[0]:
            raise ValueError(f"pair index outside [0, {mat.shape[0]})")
    on_card = mat.device.type == "cuda"
    staged = torch.empty((2, n_pairs), dtype=torch.int64,
                         pin_memory=on_card)
    staged[0].copy_(hpi)
    staged[1].copy_(hpj)
    idx = staged.to(mat.device, non_blocking=True)
    lens = valid_lengths(mat)
    out = torch.empty((2, n_pairs), dtype=torch.int32, device=mat.device)
    step = n_pairs if on_card else PAIR_BATCH
    for s in range(0, n_pairs, max(step, 1)):
        e = min(s + step, n_pairs)
        run_launch(mat, lens, idx[0, s:e], idx[1, s:e], sketch_size,
                   out[0, s:e], out[1, s:e])
    host = torch.empty((2, n_pairs), dtype=torch.int32, pin_memory=on_card)
    host.copy_(out, non_blocking=True)
    return host, mat.device


def collect_pair_stats(enqueued: Tuple[torch.Tensor, torch.device]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Wait for an ``enqueue_pair_stats`` and return (common, total)."""
    host, device = enqueued
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return host.numpy()[0], host.numpy()[1]


def threshold_pairs_sparse(mat: torch.Tensor, k: int, min_ani: float,
                           sketch_size: Optional[int] = None,
                           clock: Optional[StageClock] = None,
                           mesh=None) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} for i<j pairs with ani >= min_ani: collision
    screen on the host, pair stats on the device, exact check on the
    host. With a `mesh` of more than one slot the candidate list is
    split over the slots (``parallel/mesh.sharded_pair_stats_for_pairs``,
    one pairlist launch a slot); the integers are the same. `clock`
    gets the `collision-screen` and `pair-stats` stages and the
    screen's counts (possible pairs, candidates, kept pairs)."""
    clock = clock or StageClock(mat.device)
    if sketch_size is None:
        sketch_size = mat.shape[1]
    j_thr = ani_to_jaccard(min_ani, k)
    with clock.stage("collision-screen"):
        host = from_biased(mat)
        lens = (host != SENTINEL_U64).sum(axis=1).astype(np.int64)
        pi, pj = candidate_pairs_minhash(host, lens, j_thr, sketch_size)
    n = mat.shape[0]
    clock.count("screen-candidates", int(pi.shape[0]))
    clock.count("screen-possible-pairs", n * (n - 1) // 2)
    with clock.stage("pair-stats"):
        if mesh is not None and mesh.size > 1:
            from galah_tpu_torch.parallel.mesh import \
                sharded_pair_stats_for_pairs

            common, total = sharded_pair_stats_for_pairs(
                mat, pi, pj, sketch_size, mesh)
        else:
            common, total = pair_stats_for_pairs(mat, pi, pj, sketch_size)
    common = common.astype(np.int64)
    total = total.astype(np.int64)
    keep = common.astype(np.float64) >= j_thr * total
    clock.count("screen-kept-pairs", int(keep.sum()))
    note_survival(int(pi.shape[0]), int(keep.sum()))
    ani = stats_to_ani_f64(common[keep], total[keep], k)
    return {(int(a), int(b)): float(v)
            for a, b, v in zip(pi[keep], pj[keep], ani)}
