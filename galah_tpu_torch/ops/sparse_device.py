"""The screened all-pairs MinHash pass: the port of
``galah_tpu/ops/sparse_device.py`` and its survivor strategies.

The host finds the candidate pairs by exact collision counting
(``ops/collision.candidate_pairs_minhash``, conservative for
merged-bottom-k Mash), the card computes the exact ``(common, total)``
of the survivors only, and the host applies the exact float64
integer-Jaccard keep-check and reports the float64 ANI. The integers
are those of the dense pass, so the pair dict is the dense pass's,
at O(NK log NK + survivors) instead of O(N^2) tiles.

The survivors go one of two ways on the card (``GALAH_TPU_PAIRLIST_
STRATEGY`` pins one; unpinned, ``resolve_pairlist_strategy`` takes
``blocked``):

- ``blocked``: the list uploaded once, launches of the pairlist kernel
  (``ops/pairlist``; one launch, or ``GALAH_TPU_PAIR_BATCH`` pairs a
  launch), the results downloaded once. Over a device mesh
  (``parallel/mesh.py``: every card of the process, or the ranks of a
  job) the list is split into one chunk a slot, a chunk a card.
- ``gather``: the pairs, sorted by (i, j), are planned into segments of
  at most 64 distinct a rows by 128 distinct b rows
  (``plan_gather_segments``, ``galah_tpu``'s ``_plan_gather_segments``)
  and every segment's used cells go through one launch of
  ``tile_stats.cu``'s gathered entry (``ops/tile_stats.gather_stats``),
  which reads the rows by index from the matrix.

On the CPU the unpinned route is ``xla``, as ``galah_tpu``'s on its CPU
backend, and ``blocked``, ``xla`` and ``cpu`` all run the pairlist
kernel's plain version, while ``gather`` runs the planner and
``tile_stats``' plain version. On the card ``xla`` and ``cpu`` are
refused: they would put a plain version or the host on a card run.
Every route gives the same integers (``DETERMINISM_CONTRACT``), so no
pick changes a pair dict. ``galah_tpu``'s counters
``pairlist-pad-slots`` and ``pairlist-blocked-pad-pairs`` count the
padding of its fixed-shape batches and Mosaic programs; the port pads
nothing and has neither.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch import config
from galah_tpu_torch.device import CUDA_REFUSED_PINS, pinned
from galah_tpu_torch.ops.collision import candidate_pairs_minhash
from galah_tpu_torch.ops.constants import SENTINEL_U64
from galah_tpu_torch.ops.pairlist import run_launch, valid_lengths
from galah_tpu_torch.ops.pairwise import (ani_to_jaccard, note_survival,
                                          stats_to_ani_f64)
from galah_tpu_torch.ops.tile_stats import (GATHER_COLS, GATHER_ROWS,
                                            gather_stats)
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

# Numeric contract (GL9xx): int32 pair statistics whatever the route or
# the batch cut, then the exact float64 check on the host.
DETERMINISM_CONTRACT = {
    "family": "pairlist",
    "dtype": "int32",
    "functions": ["pair_stats_for_pairs", "enqueue_pair_stats",
                  "collect_pair_stats", "threshold_pairs_sparse",
                  "gather_pair_stats"],
}

# candidate pairs per call of the plain version on the CPU (the card
# takes the whole list in one launch) unless GALAH_TPU_PAIR_BATCH says
PAIR_BATCH = 1 << 16

#: the survivor routes ``GALAH_TPU_PAIRLIST_STRATEGY`` may pin (the
#: card refuses xla and cpu: ``device.CUDA_REFUSED_PINS``)
PAIRLIST_STRATEGIES = ("blocked", "gather", "xla", "cpu")

# AUTO on the card is `blocked`. galah_tpu's AUTO plans the segments
# of a list with at least 4 pairs a distinct row and takes `gather`
# where the planned tile fill times the gathered route's rate beats the
# blocked route's. On an H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# kernels/rehearse_gather.py at K = 1000 over 128 segments, PERF.md §6)
# the whole gathered route ran 3,718,520 cells a second at tile fill 1.0
# (1,048,576 pairs in 281.99 ms, most of it the host planner) and the
# blocked route 83,174,325 pairs a second (the median over fills
# 0.1-1.0): no fill lets `gather` win, and the test itself would cost
# the planner's time on every duplicated list (the index pass's 5 M
# pairs among them). The gathered entry alone ran 276 M cells a second
# and pairlist.cu 209 M pairs a second, so a faster planner would
# reopen the choice.


def plan_gather_segments(spi: np.ndarray, spj: np.ndarray,
                         rows_cap: int = GATHER_ROWS,
                         cols_cap: int = GATHER_COLS):
    """``galah_tpu``'s plan of the gather strategy: split a (pi,
    pj)-sorted pair list into segments of at most `rows_cap` distinct a
    rows by `cols_cap` distinct b rows, each table padded with row 0.

    Returns (segments, cells): segments is a list of (ua, ub, ra, rb,
    idx), the (rows_cap,) and (cols_cap,) int32 row indices, each pair's
    cell in its segment and the pairs' positions in the sorted list;
    cells is the planned tile area (the fill's denominator). O(S log S)
    numpy, no per-pair Python."""
    n = spi.shape[0]
    # dense rank of each pair's a row (the list is a-sorted, so ranks
    # are a prefix sum over boundaries) -> blocks of rows_cap a rows
    a_rank = np.zeros(n, dtype=np.int64)
    if n > 1:
        a_rank[1:] = np.cumsum(spi[1:] != spi[:-1])
    block = a_rank // rows_cap
    starts = np.flatnonzero(np.r_[True, block[1:] != block[:-1]])
    bounds = np.r_[starts, n]
    segments = []
    for bi in range(len(starts)):
        s, e = int(bounds[bi]), int(bounds[bi + 1])
        ua_vals = np.unique(spi[s:e])
        ub_all = np.unique(spj[s:e])
        ra_all = (a_rank[s:e] - a_rank[s]).astype(np.int32)
        pos_b = np.searchsorted(ub_all, spj[s:e]).astype(np.int64)
        piece = pos_b // cols_cap
        for t in range(int(piece.max()) + 1 if e > s else 0):
            mask = piece == t
            idx = np.flatnonzero(mask) + s
            ua = np.zeros(rows_cap, dtype=np.int32)
            ua[:ua_vals.size] = ua_vals
            ub_piece = ub_all[t * cols_cap:(t + 1) * cols_cap]
            ub = np.zeros(cols_cap, dtype=np.int32)
            ub[:ub_piece.size] = ub_piece
            segments.append((ua, ub, ra_all[mask],
                             (pos_b[mask] - t * cols_cap).astype(np.int32),
                             idx))
    cells = len(segments) * rows_cap * cols_cap
    return segments, cells


def segment_tables(segments):
    """``plan_gather_segments``' segments as the gathered entry takes
    them (``tile_stats.gather_stats``): (ua (S, 64), ub (S, 128), and
    for each pair its segment, ra and rb, then its position in the
    sorted list)."""
    seg = np.concatenate([np.full(s[2].shape[0], n, dtype=np.int64)
                          for n, s in enumerate(segments)])
    return (np.stack([s[0] for s in segments]),
            np.stack([s[1] for s in segments]), seg,
            np.concatenate([s[2] for s in segments]),
            np.concatenate([s[3] for s in segments]),
            np.concatenate([s[4] for s in segments]))


def pinned_strategy(device_type: str) -> Optional[str]:
    """The route ``GALAH_TPU_PAIRLIST_STRATEGY`` pins, or None (unset,
    or a value that names no route, which ``galah_tpu`` ignores too).
    On `device_type` ``cuda`` a pin of ``xla`` or ``cpu`` raises."""
    env = pinned("GALAH_TPU_PAIRLIST_STRATEGY",
                 config.env_value("GALAH_TPU_PAIRLIST_STRATEGY"),
                 device_type)
    return env if env in PAIRLIST_STRATEGIES else None


def resolve_pairlist_strategy(device_type: str, mesh=None) -> str:
    """The survivor route (``galah_tpu``'s ``_resolve_pairlist_
    strategy`` on this card's rates, above): a pin wins; a mesh of more
    than one slot keeps ``blocked``; AUTO is ``xla`` on the CPU, as
    ``galah_tpu``'s on its CPU backend, and ``blocked`` on the card."""
    pin = pinned_strategy(device_type)
    if pin is not None:
        return pin
    if device_type == "cuda" or (mesh is not None and mesh.size > 1):
        return "blocked"
    return "xla"


def pair_batch() -> Optional[int]:
    """``GALAH_TPU_PAIR_BATCH``: pairs a pairlist launch, or None."""
    raw = config.env_value("GALAH_TPU_PAIR_BATCH")
    return max(1, int(raw)) if raw else None


def pair_stats_for_pairs(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
                         sketch_size: int,
                         clock: Optional[StageClock] = None,
                         strategy: Optional[str] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact merged-bottom-k (common, total) int32 for an explicit pair
    list over the (N, K) biased sketch matrix on the device, by the
    survivor route `strategy` names, else the one
    ``resolve_pairlist_strategy`` picks. `clock` gets the pick's count,
    ``pairlist-strategy-<route>``, and on ``gather`` the planned and
    used cells.

    ``blocked`` (and on the CPU ``xla`` and ``cpu``): the indices
    checked once, on the host, and sent to the device in one copy, from
    pinned memory; one launch of the pairlist kernel takes the whole
    list (or GALAH_TPU_PAIR_BATCH pairs a launch; on the CPU, the plain
    version takes PAIR_BATCH pairs a call), and the results come back
    in one copy. ``gather``: ``gather_pair_stats``."""
    hpi, hpj = _checked(mat, pi, pj)
    if hpi.shape[0] == 0:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    device_type = mat.device.type
    if strategy is None:
        strategy = resolve_pairlist_strategy(device_type)
    elif strategy not in PAIRLIST_STRATEGIES or (
            device_type == "cuda" and strategy in
            CUDA_REFUSED_PINS["GALAH_TPU_PAIRLIST_STRATEGY"]):
        raise ValueError(f"survivor route {strategy!r} cannot run on "
                         f"{device_type}")
    if clock is not None:
        clock.count(f"pairlist-strategy-{strategy}", 1)
    if strategy == "gather":
        return gather_pair_stats(mat, hpi.numpy(), hpj.numpy(), sketch_size,
                                 clock)
    return collect_pair_stats(_enqueue(mat, hpi, hpj, sketch_size))


def _checked(mat: torch.Tensor, pi, pj) -> Tuple[torch.Tensor, torch.Tensor]:
    """The index lists as int64 host tensors, checked once: equal 1-D
    shapes, every index a row of `mat`."""
    hpi = torch.as_tensor(np.ascontiguousarray(pi, dtype=np.int64))
    hpj = torch.as_tensor(np.ascontiguousarray(pj, dtype=np.int64))
    if hpi.shape != hpj.shape or hpi.dim() != 1:
        raise ValueError(f"pair lists differ in shape: {tuple(hpi.shape)} "
                         f"{tuple(hpj.shape)}")
    if hpi.shape[0]:
        (lo_i, hi_i), (lo_j, hi_j) = torch.aminmax(hpi), torch.aminmax(hpj)
        if min(lo_i, lo_j) < 0 or max(hi_i, hi_j) >= mat.shape[0]:
            raise ValueError(f"pair index outside [0, {mat.shape[0]})")
    return hpi, hpj


def gather_pair_stats(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
                      sketch_size: int, clock: Optional[StageClock] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``gather`` route over integer index arrays `pi` and `pj`
    (checked rows of `mat`): the pairs sorted by (i, j), planned into
    segments (``plan_gather_segments``), and every segment's used cells
    evaluated at once by ``tile_stats.gather_stats`` (one launch of the
    gathered entry on the card, reading the rows by index). `clock`
    gets ``pairlist-gather-cells`` (the planned tile area) and
    ``pairlist-gather-used`` (the pairs), ``galah_tpu``'s counters."""
    n_pairs = pi.shape[0]
    order = np.lexsort((pj, pi))
    segments, cells = plan_gather_segments(pi[order], pj[order])
    if clock is not None:
        clock.count("pairlist-gather-cells", int(cells))
        clock.count("pairlist-gather-used", int(n_pairs))
    ua, ub, seg, ra, rb, idx = segment_tables(segments)
    pos = order[idx]
    c, t = gather_stats(mat, ua, ub, seg, ra, rb, sketch_size)
    common = np.empty(n_pairs, dtype=np.int32)
    total = np.empty(n_pairs, dtype=np.int32)
    common[pos] = c
    total[pos] = t
    return common, total


def enqueue_pair_stats(mat: torch.Tensor, pi, pj, sketch_size: int
                       ) -> Tuple[torch.Tensor, torch.device]:
    """The blocked route up to its wait: the checked list uploaded, the
    launches enqueued (one, or GALAH_TPU_PAIR_BATCH pairs each) and the
    results' copy to the host queued. Returns (the (2, B) int32 host
    buffer, the device to wait for) for ``collect_pair_stats``."""
    hpi, hpj = _checked(mat, pi, pj)
    return _enqueue(mat, hpi, hpj, sketch_size)


def _enqueue(mat: torch.Tensor, hpi: torch.Tensor, hpj: torch.Tensor,
             sketch_size: int) -> Tuple[torch.Tensor, torch.device]:
    """``enqueue_pair_stats`` on lists ``_checked`` has passed."""
    n_pairs = hpi.shape[0]
    on_card = mat.device.type == "cuda"
    staged = torch.empty((2, n_pairs), dtype=torch.int64,
                         pin_memory=on_card)
    staged[0].copy_(hpi)
    staged[1].copy_(hpj)
    idx = staged.to(mat.device, non_blocking=True)
    lens = valid_lengths(mat)
    out = torch.empty((2, n_pairs), dtype=torch.int32, device=mat.device)
    step = pair_batch() or (n_pairs if on_card else PAIR_BATCH)
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
    screen on the host, pair stats on the device by the resolved
    survivor route, exact check on the host. With a `mesh` of more
    than one slot the blocked route splits the candidate list over the
    slots (``parallel/mesh.sharded_pair_stats_for_pairs``, one pairlist
    launch a slot); a pinned ``gather`` runs whole on this process's
    device. The integers are the same. `clock` gets the
    `collision-screen` and `pair-stats` stages and the screen's counts
    (possible pairs, candidates, kept pairs)."""
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
        strategy = resolve_pairlist_strategy(mat.device.type, mesh) \
            if pi.shape[0] else None
        if strategy == "blocked" and mesh is not None and mesh.size > 1:
            from galah_tpu_torch.parallel.mesh import \
                sharded_pair_stats_for_pairs

            clock.count("pairlist-strategy-blocked", 1)
            common, total = sharded_pair_stats_for_pairs(
                mat, pi, pj, sketch_size, mesh)
        else:
            common, total = pair_stats_for_pairs(
                mat, pi, pj, sketch_size, clock, strategy=strategy)
    common = common.astype(np.int64)
    total = total.astype(np.int64)
    keep = common.astype(np.float64) >= j_thr * total
    clock.count("screen-kept-pairs", int(keep.sum()))
    note_survival(int(pi.shape[0]), int(keep.sum()))
    ani = stats_to_ani_f64(common[keep], total[keep], k)
    return {(int(a), int(b)): float(v)
            for a, b, v in zip(pi[keep], pj[keep], ani)}

