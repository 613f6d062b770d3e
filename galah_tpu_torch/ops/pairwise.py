"""All-pairs passes over sorted, sentinel-padded hash rows: the port of
``galah_tpu/ops/pairwise.py``'s ``screen_pairs`` and ``threshold_pairs``.

``screen_pairs`` is the marker-containment screen: the i<j pairs whose
containment ``|M_i ∩ M_j| / min(|M_i|, |M_j|)`` reaches the floor (the
skani-equivalent candidate screen, reference: src/skani.rs:54-70).
``threshold_pairs`` is the finch pass: the i<j pairs whose merged-bottom-k
Mash ANI reaches the threshold, with that ANI (reference:
src/finch.rs:69-71).

Below the sparse crossover (``collision.sparse_screen_min_n()``, 1024
genomes unless ``GALAH_TPU_SPARSE_MIN_N`` moves it), and at any size
under ``GALAH_TPU_DENSE_PAIRS``, the screen runs the
dense row-block pass: per block of rows, the stripe against every
column at or right of the block's diagonal tile comes from
``tile_stats``' intersect form (the CUDA kernel on the card), a
conservative float64 mask and the compaction run on the device, and the
host applies the exact float64 check. The finch pass runs
``iter_threshold_pairs_streamed`` (drained by
``threshold_pairs_streamed``, or consumed block by block by the
overlapped engine): per block of sketch rows, which may still
be arriving (``ops/sketch_stream.iter_sketch_row_blocks``), one stripe
of every row seen so far against the block's columns through
``tile_stats``' full form, and the exact float64 check on the host.
From the crossover up, both take the host collision screen
(``ops/collision.py``) instead: the screen's counts are its exact
containment numerators, and finch evaluates the collision survivors
with the pairlist kernel (``ops/sparse_device.py``). Either way the
result is the same. Over every card of one process, or the ranks of a
multi-process job (one slot a rank), each pass is sharded over a mesh
(``parallel/mesh.py``, on ``GALAH_TPU_MESH_SHAPE``'s grid), again with
the same result.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.obs import flow as obs_flow
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops import collision
from galah_tpu_torch.ops.compact import iter_blocks
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock, Stopwatch

# The streamed finch pass is a pipeline stage (GL10xx, obs/flow.py)
# that feeds the pairs stage's occupancy gauge.
PIPELINE_STAGE = {
    "streaming": ["iter_threshold_pairs_streamed",
                  "threshold_pairs_streamed"],
    "occupancy_gauge": "workload.pipeline_occupancy",
}

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
                 clock: Optional[StageClock] = None,
                 mesh=None) -> List[Tuple[int, int]]:
    """i<j pairs whose marker containment >= c_floor, in row-major
    order. `marker_mat` is (N, M) biased int64 on the device, sorted
    and sentinel-padded; `counts` the per-genome marker counts.
    Below the crossover, over more than one slot (`mesh`, by default
    ``parallel/mesh.auto_mesh`` of the device: every card of the
    process, or the ranks of a multi-process job, on its grid) the
    dense pass is sharded (``sharded_screen_pairs``); an explicit
    `mesh` pins the dense pass at any size, as in ``galah_tpu``.
    `clock` gets the count ``screen-possible-pairs``, and on the
    collision route ``screen-candidates`` and ``screen-kept-pairs``
    (``galah_tpu`` counts the three on that route only)."""
    clock = clock or StageClock(marker_mat.device)
    n = marker_mat.shape[0]
    counts64 = np.asarray(counts, dtype=np.int64)
    clock.count("screen-possible-pairs", n * (n - 1) // 2)
    if (mesh is None and n >= collision.sparse_screen_min_n()
            and not collision.dense_pairs_pinned()):
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
    from galah_tpu_torch.parallel import mesh as pmesh

    if mesh is None:
        mesh = pmesh.auto_mesh(marker_mat.device)
    if mesh is not None and mesh.size > 1:
        return pmesh.sharded_screen_pairs(
            marker_mat, counts64, c_floor, mesh, row_tile=row_tile,
            col_tile=col_tile, cap_per_row=cap_per_row)
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
                    clock: Optional[StageClock] = None,
                    mesh=None) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} for i<j pairs whose float64 Mash ANI reaches
    `min_ani`, over an (N, K) biased sketch matrix on the device: the
    streamed pass over its blocks of COL_TILE rows below the sparse
    crossover, the collision screen and pairlist pass
    (``sparse_device``) from it up. Over more than one slot (`mesh`, by
    default ``parallel/mesh.auto_mesh`` of the device) the pass below
    the crossover is ``sharded_threshold_pairs`` on the mesh's grid,
    and the pair list from it up is split over the same slots in a
    row, as ``galah_tpu`` splits it over a 1-D mesh of every device
    under any shape. `clock` gets the stages
    (`pair-stats`, and `collision-screen` when sparse)."""
    from galah_tpu_torch.parallel import mesh as pmesh

    clock = clock or StageClock(sketch_mat.device)
    if sketch_size is None:
        sketch_size = sketch_mat.shape[1]
    n = sketch_mat.shape[0]
    if mesh is None:
        mesh = pmesh.auto_mesh(sketch_mat.device)
    if (n >= collision.sparse_screen_min_n()
            and not collision.dense_pairs_pinned()):
        from galah_tpu_torch.ops.sparse_device import threshold_pairs_sparse

        return threshold_pairs_sparse(
            sketch_mat, k, min_ani, sketch_size, clock,
            mesh=mesh.flat() if mesh is not None else None)
    if mesh is not None and mesh.size > 1:
        clock.count("screen-possible-pairs", n * (n - 1) // 2)
        with clock.stage("pair-stats"):
            return pmesh.sharded_threshold_pairs(
                sketch_mat, k, min_ani, mesh, sketch_size=sketch_size)
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
    mesh=None,
) -> Dict[Tuple[int, int], float]:
    """``threshold_pairs`` below the sparse crossover over arriving
    sketch blocks: ``iter_threshold_pairs_streamed`` drained into one
    dict, which equals ``threshold_pairs`` over the whole matrix."""
    out: Dict[Tuple[int, int], float] = {}
    for _r1, inc in iter_threshold_pairs_streamed(
            blocks, n, k, min_ani, sketch_size, clock, block=block,
            mesh=mesh):
        out.update(inc)
    return out


def iter_threshold_pairs_streamed(
    blocks: Iterable[Tuple[int, torch.Tensor]],
    n: int,
    k: int,
    min_ani: float,
    sketch_size: int,
    clock: Optional[StageClock] = None,
    block: int = COL_TILE,
    mesh=None,
) -> Iterator[Tuple[int, Dict[Tuple[int, int], float]]]:
    """The streamed finch pass as a generator (``galah_tpu``'s
    ``iter_threshold_pairs_streamed``): over ``(r0, rows)`` blocks of
    at most `block` biased sketch rows on the device that may still be
    arriving (``ops/sketch_stream.iter_sketch_row_blocks``; rows in
    order, r0 = 0, then each block's end), it yields ``(r1, increment)``
    per block, `increment` holding the pairs (i, j), j in [r0, r1),
    that pass. At each yield the pair neighbourhood of the prefix
    [0, r1) is complete, which lets the overlapped engine
    (``cluster/engine.py``) decide greedy windows over it while later
    genomes are still read and sketched; the increments together equal
    ``threshold_pairs`` over the whole matrix.

    Per block, one stripe: every row seen so far, padded with sentinel
    rows to a power of two (at least ``ROW_TILE``), against the block
    padded to `block` columns, in one launch of ``tile_stats``' full
    form. Every pair i < j is covered once (rows [0, r1) x columns
    [r0, r1)), and the exact float64 check runs on the host over the
    integers. ``common > 0`` drops the sentinel padding (a sentinel row
    shares nothing). Over a `mesh` whose slot count is a power of two
    each stripe is sharded (``parallel/mesh.sharded_stripe_stats``: the
    rows over the mesh rows, the block over the mesh columns of a
    grid), the padding starting at slots x ``ROW_TILE`` rows; any other
    mesh leaves the stripe on one device, as in ``galah_tpu``.
    `clock` gets the `pair-stats` stage and the
    `pairs-streamed-stripes` and `screen-possible-pairs` counts. Flow
    (``obs/flow.py``): each wait for a block is the ``pairs`` stage's
    upstream-empty wait on ``sketch``, each stripe's launch and download
    a ``device-dispatch`` wait, the rest its service, and each stripe
    leaves as an ``edge_stripe``. The ``pairs`` stage's
    ``workload.pipeline_occupancy`` gauge, one less its upstream-empty
    wait over the pass's wall, is set after each stripe and at the
    end."""
    watch = Stopwatch()
    waits = obs_flow.WaitTotal()
    clock = clock or StageClock(torch.device("cpu"))
    clock.count("screen-possible-pairs", n * (n - 1) // 2)
    j_thr = ani_to_jaccard(min_ani, k)
    n_dev = mesh.size if mesh is not None else 1
    if n_dev > 1 and n_dev & (n_dev - 1):
        # the power-of-two row padding needs a power-of-two mesh
        mesh, n_dev = None, 1
    quantum = ROW_TILE * n_dev
    r_cap = quantum
    while r_cap < n:
        r_cap <<= 1
    done: Optional[torch.Tensor] = None
    r1 = 0
    for r0, rows in obs_flow.waited(blocks, "pairs", waits):
        obs_flow.absorb("sketch", "pairs")
        block_watch = Stopwatch()
        bsz = rows.shape[0]
        if r0 != r1 or bsz > block or r0 + bsz > n:
            raise ValueError(f"streamed sketch block of {bsz} rows at "
                             f"{r0} does not follow row {r1} of {n}")
        if done is None:
            done = torch.full((r_cap, rows.shape[1]), SENTINEL_BIASED,
                              dtype=torch.int64, device=rows.device)
        done[r0:r0 + bsz] = rows
        r1 = r0 + bsz
        r_pad = quantum
        while r_pad < r1:
            r_pad <<= 1
        with clock.stage("pair-stats"):
            cols = torch.full((block, rows.shape[1]), SENTINEL_BIASED,
                              dtype=torch.int64, device=rows.device)
            cols[:bsz] = rows
            # the stripe's launch and its download: device time
            with obs_flow.blocked("pairs", "device-dispatch") as bdev:
                if mesh is not None:
                    from galah_tpu_torch.parallel.mesh import \
                        sharded_stripe_stats

                    common, total = sharded_stripe_stats(
                        done[:r_pad], cols, sketch_size, mesh,
                        row_tile=ROW_TILE, r_pad=r_pad)
                else:
                    common, total = tile_stats(done[:r_pad], cols,
                                               sketch_size)
                    common, total = (common.cpu().numpy(),
                                     total.cpu().numpy())
            common = common.astype(np.int64)
            total = total.astype(np.int64)
        clock.count("pairs-streamed-stripes", 1)
        gi = np.arange(r_pad)[:, None]
        gj = r0 + np.arange(block)[None, :]
        keep = ((gi < gj) & (gj < r1) & (common > 0)
                & (common.astype(np.float64) >= j_thr * total))
        ki, kj = np.nonzero(keep)
        ani = stats_to_ani_f64(common[keep], total[keep], k)
        inc = dict(zip(zip(ki.tolist(), (r0 + kj).tolist()),
                       ani.tolist()))
        # the stripe's host work, its device bracket excluded
        obs_flow.record_service(
            "pairs", max(block_watch.seconds() - bdev.seconds, 0.0))
        obs_flow.emit("pairs", obs_flow.begin("edge_stripe"))
        yield r1, inc
        # set after the consumer's turn too: the heartbeat samples it
        _emit_pairs_occupancy(watch, waits)
    if r1 != n:
        raise ValueError(f"streamed pair pass saw {r1} rows, expected {n}")
    if done is not None:
        _emit_pairs_occupancy(watch, waits)


def _emit_pairs_occupancy(watch: Stopwatch,
                          waits: obs_flow.WaitTotal) -> None:
    wall = watch.seconds()
    if wall > 0:
        obs_metrics.pipeline_occupancy(1.0 - waits.seconds / wall,
                                       stage="pairs")
