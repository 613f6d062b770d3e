"""Bytes and 32-bit operations of one launch of each kernel, from its
shapes: the rule of PERF.md's Bound column, in one place.

Bytes count each input read once and each output written once, whatever
the kernel reads again. Operations are 32-bit integer or float
operations, with a 64-bit compare or add at two; the per-item counts are
the kernels' source notes (``chip_smoke.py`` holds the same numbers for
its bounds). Where the work depends on the data, the shape's count is
taken: every window of a hash launch as valid (ambiguous bases and
contig starts drop a few), every sketch row of a ``tile_stats`` launch
as full. ``pairlist`` and ``slab_fold`` are the exceptions: ``pairlist``'s items
are the sums of its own outputs, so its operations are device scalars
that ``obs/profile.py`` reads once the run has synchronized
(``rehearse_pairlist.work``'s formula; no host wait at the launch);
``slab_fold``'s iterations are an output of the launch, which
``ops/megakernel.slab_select`` reads back with the flags and then adds
its operations on the host.

``obs/profile.py`` adds these up per kernel into the run report's
``device_costs``; none of them touch the device but ``pairlist``'s.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

# 32-bit operations of one window or item of each kernel (the kernels'
# source notes)
FUSED_OPS_PER_WINDOW_TPUFAST = 70
MURMUR3_K21_OPS_PER_WINDOW = 170
# positional_hashes: 4 x the SASS window loop's integer-ALU instructions
# a window (kernels/positional_hashes.cu's source note), which bind it
K15_OPS_PER_WINDOW = {"murmur3": 202, "tpufast": 116}
HLL_UNION_OPS_PER_REGISTER = 4
PAIRLIST_OPS_PER_ITEM = 3
# slab_fold, an iteration: an edge's compare and two flag reads and
# stores, a position's clear, tests and update
SLAB_FOLD_OPS_PER_EDGE = 6
SLAB_FOLD_OPS_PER_POSITION = 6

# fused_sketch's candidate file: REGS x CLASSES int64 a job, and the
# job's (first window, count) pair read
FUSED_OUT_BYTES_PER_JOB = 8 * 2048 * 8
FUSED_META_BYTES_PER_JOB = 16

Cost = Tuple[float, float]  # (bytes, operations)


def fused_murmur3_ops(k: int) -> int:
    """32-bit operations a valid window of the fused sketch kernel with
    murmur3 at k: the roll, select and compare (~94), ~12 a key word,
    ~35 a 16-byte block and ~15 a tail word; 180 at k = 21."""
    rem = k % 16
    return (94 + 12 * -(-k // 8) + 35 * (k // 16) + 15 * (rem > 0)
            + 15 * (rem > 8))


def window_hits(q_len: Sequence[int], r_len: Sequence[int],
                q_ptr: Sequence[int], r_ptr: Sequence[int]) -> Cost:
    """Each distinct query and reference array (by address) read once,
    an int32 flag a query element written; a binary search of the
    reference set a query element, two operations a step."""
    uq = dict(zip(q_ptr, q_len))
    ur = dict(zip(r_ptr, r_len))
    n_elem = sum(int(q) for q in q_len)
    nbytes = 8 * (sum(uq.values()) + sum(ur.values())) + 4 * n_elem
    ops = 2 * sum(int(q) * math.ceil(math.log2(int(r) + 1))
                  for q, r in zip(q_len, r_len))
    return float(nbytes), float(ops)


def tile_stats(br: int, bc: int, k: int) -> Cost:
    """The (br, K) and (bc, K) int64 rows read once, two int32 (br, bc)
    outputs written; each pair walks both (full) rows once, an int64
    compare an item."""
    return (float(8 * k * (br + bc) + 2 * 4 * br * bc),
            float(2 * br * bc * 2 * k))


def pairlist_bytes(rows, n_pairs: int, k: int):
    """The `rows` distinct int64 sketch rows a pair list uses read once,
    and 24 bytes a pair in (two int64 indices) and out (two int32).
    `rows` may be a device scalar: the result is one too."""
    return 8 * k * rows + n_pairs * (16 + 8)


def pairlist_ops(items):
    """PAIRLIST_OPS_PER_ITEM for each item a merge of the two rows takes
    to emit the union's first `total` values: total + common a pair.
    `items` may be a device scalar: the result is one too."""
    return PAIRLIST_OPS_PER_ITEM * items


def fused_sketch(n_codes: int, n_starts: int, n_windows: int,
                 n_jobs: int, k: int, algo: str) -> Cost:
    """The codes and contig starts read once, each job's meta read and
    its candidate file written; every window hashed."""
    per_window = (FUSED_OPS_PER_WINDOW_TPUFAST if algo == "tpufast"
                  else fused_murmur3_ops(k))
    nbytes = (n_codes + 8 * n_starts
              + n_jobs * (FUSED_META_BYTES_PER_JOB + FUSED_OUT_BYTES_PER_JOB))
    return float(nbytes), float(n_windows * per_window)


def window_hashes(n_windows: int, k: int, n_starts: int,
                  ops_per_window: int) -> Cost:
    """A hash launch over `n_windows` windows of width k: their codes
    (n_windows + k - 1) and the contig starts read once, an int64 hash a
    window written."""
    if n_windows <= 0:
        return 0.0, 0.0
    nbytes = (n_windows + k - 1) + 8 * n_starts + 8 * n_windows
    return float(nbytes), float(n_windows * ops_per_window)


def group_hashes(counts: Sequence[int], k: int, n_starts: int,
                 ops_per_window: int) -> Cost:
    """A group hash launch over genomes of `counts` windows: each
    genome's codes (count + k - 1; no window between two genomes is
    hashed), the contig starts and the 32-byte table row of each genome
    read once, an int64 hash a window written (the subsample cut adds
    no bytes)."""
    live = [int(n) for n in counts if n > 0]
    if not live:
        return 0.0, 0.0
    n_win = sum(live)
    nbytes = (n_win + (k - 1) * len(live) + 8 * n_starts + 32 * len(live)
              + 8 * n_win)
    return float(nbytes), float(n_win * ops_per_window)


def hll_union(br: int, bc: int, m: int) -> Cost:
    """The uint8 (br, m) and (bc, m) registers read once, two float32
    (br, bc) outputs written; HLL_UNION_OPS_PER_REGISTER a register
    pair."""
    return (float(m * (br + bc) + 2 * 4 * br * bc),
            float(HLL_UNION_OPS_PER_REGISTER * br * bc * m))


def slab_fold_bytes(count: int, width: int) -> int:
    """The queue's `count` 16-byte records and the ext flags read once,
    the rep and undecided flags written once."""
    return 16 * count + 3 * width


def slab_fold_ops(iters, count: int, width: int):
    """Every iteration run passes over the edges and the positions (the
    recurrence's work: the kernel's live-edge compaction skips some)."""
    return iters * (SLAB_FOLD_OPS_PER_EDGE * count
                    + SLAB_FOLD_OPS_PER_POSITION * width)
