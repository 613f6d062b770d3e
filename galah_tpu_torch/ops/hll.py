"""HyperLogLog on the device: the port of ``galah_tpu/ops/hll.py``.

The dashing-equivalent precluster (reference: src/dashing.rs:33-100):

* sketching: every canonical k=21 window hash h (murmur3 or tpufast, as
  for the MinHash sketches) updates register ``h >> (64 - p)`` with
  ``rho = min(clz(h << p) + 1, 64 - p + 1)`` by a scatter-max; windows
  whose hash is the all-ones sentinel (invalid windows, and a valid one
  that hashes to all ones, as in ``galah_tpu``) leave the registers
  alone. A launch group's genomes are laid end to end as for the finch
  sketches (``io/group.load_group``: one pinned buffer, one copy to the
  device), hashed at once (the
  murmur3_k21 kernel on the card), and folded by genome; registers are
  a max over a set, so grouping cannot change them;
* cardinality: the classic estimate ``alpha_m m^2 / sum 2^-reg`` with
  linear counting below ``2.5 m``, in float32 and ``galah_tpu``'s
  formulas;
* pairs: the union estimate from the register-wise max of two rows,
  Jaccard by inclusion-exclusion, Mash ANI ``1 + ln(2j / (1 + j)) / k``,
  over the upper triangle in row blocks: the union statistics from
  ``ops/hll_union`` (the hll_union kernel on the card), the estimate,
  the threshold and the compaction on the device, and only the passing
  pairs to the host.

Hashes are biased int64 (``ops/u64.py``); the register index and
``clz`` read the unbiased bits. Torch has no ``clz``, and ``log2`` in
float64 rounds wrongly above 2^53, so ``clz64`` is a binary search
over logical shifts. Over every card of one process, or the ranks of
a multi-process job (one slot a rank), the pair pass is sharded
(``parallel/mesh.sharded_hll_threshold_pairs``, on the mesh's grid)
with the same values.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.io.group import host_layout, iter_groups, load_group
from galah_tpu_torch.ops.compact import iter_blocks
from galah_tpu_torch.ops.hashing import canonical_key_words, masked_hashes
from galah_tpu_torch.ops.hll_union import hll_union_stats, pow2_neg
from galah_tpu_torch.ops.murmur3_k21 import murmur3_k21
from galah_tpu_torch.ops.sketch_stream import FUSED_BUDGET
from galah_tpu_torch.ops.u64 import bias, lsr
from galah_tpu_torch.timing import StageClock

DEFAULT_P = 12  # 4096 registers: ~1.6% cardinality error, 4 KiB a genome

ROW_TILE = 64
COL_TILE = 256
CAP_PER_ROW = 64

# windows folded at once: bounds the fold's int64 temporaries
FOLD_CHUNK = 1 << 23


def _alpha(m: int) -> float:
    if m >= 128:
        return 0.7213 / (1.0 + 1.079 / m)
    if m == 64:
        return 0.709
    if m == 32:
        return 0.697
    return 0.673


def _estimate(powsum: torch.Tensor, zeros: torch.Tensor,
              m: int) -> torch.Tensor:
    """HLL estimate from sum(2^-reg) and the zero-register count (f32)."""
    f32 = dict(dtype=torch.float32, device=powsum.device)
    raw = torch.tensor(_alpha(m) * m * m, **f32) / powsum
    small = raw <= torch.tensor(2.5 * m, **f32)
    fm = torch.tensor(float(m), **f32)
    lc = fm * torch.log(fm / torch.clamp(zeros, min=1.0))
    return torch.where(small & (zeros > 0), lc, raw)


def hll_cardinality(regs: torch.Tensor) -> torch.Tensor:
    """Cardinality estimates: (..., m) uint8 registers -> (...) f32."""
    m = regs.shape[-1]
    powsum = pow2_neg(regs.device)[regs.long()].sum(-1).float()
    zeros = (regs == 0).sum(-1).float()
    return _estimate(powsum, zeros, m)


def _ani_from_union_stats(powsum: torch.Tensor, zeros: torch.Tensor,
                          row_cards: torch.Tensor, col_cards: torch.Tensor,
                          k: int, m: int) -> torch.Tensor:
    """(Br, Bc) f32 Mash ANI from the union statistics and the rows' and
    columns' cardinalities; 0 where the estimated intersection is
    empty."""
    u = _estimate(powsum, zeros, m)
    inter = row_cards[:, None] + col_cards[None, :] - u
    j = torch.clamp(inter / torch.clamp(u, min=1.0), 0.0, 1.0)
    ani = 1.0 + torch.log(2.0 * j / (1.0 + j)) / k
    return torch.where(j > 0, ani, torch.zeros_like(ani))


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of int64 `x` read as u64 (64 for 0)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = lsr(x, 64 - s) == 0
        n += top_zero.long() * s
        x = torch.where(top_zero, x << s, x)
    return n + (x == 0).long()


def _fold(regs: torch.Tensor, rows: torch.Tensor, hashes: torch.Tensor,
          p: int) -> None:
    """Scatter-max biased `hashes` into (G, 2^p) int32 `regs`, hash i
    into row ``rows[i]``."""
    h = bias(hashes)  # the u64 bits; the sentinel becomes all ones
    idx = lsr(h, 64 - p)
    rho = torch.clamp(clz64(h << p) + 1, max=64 - p + 1)
    rho = torch.where(h == -1, torch.zeros_like(rho), rho)
    regs.view(-1).scatter_reduce_(0, rows * (1 << p) + idx,
                                  rho.to(torch.int32), "amax")


def hll_update(regs: torch.Tensor, hashes: torch.Tensor,
               p: int) -> torch.Tensor:
    """(2^p,) uint8 registers with biased `hashes` folded in (the port
    of ``galah_tpu``'s ``_hll_update``)."""
    out = regs.to(torch.int32)[None, :].contiguous()
    _fold(out, torch.zeros_like(hashes), hashes, p)
    return out[0].to(torch.uint8)


def fold_group(regs: torch.Tensor, hashes: torch.Tensor, jobs,
               rows_of_jobs: Sequence[int], p: int) -> None:
    """Fold a launch group's window hashes (biased, over the genomes
    laid end to end) into rows `rows_of_jobs` of `regs`, job j's
    windows into row ``rows_of_jobs[j]``; windows across a genome start
    are the sentinel and fold nothing."""
    device = regs.device
    starts = torch.tensor([off for off, _ in jobs[1:]],
                          dtype=torch.int64, device=device)
    row_of = torch.tensor(list(rows_of_jobs), dtype=torch.int64,
                          device=device)
    for s in range(0, hashes.shape[0], FOLD_CHUNK):
        e = min(s + FOLD_CHUNK, hashes.shape[0])
        pos = torch.arange(s, e, dtype=torch.int64, device=device)
        rows = row_of[torch.bucketize(pos, starts, right=True)]
        _fold(regs, rows, hashes[s:e], p)


def hll_sketch_genomes(genomes: Sequence[Genome], p: int = DEFAULT_P,
                       k: int = 21, algo: str = "murmur3", device="cuda",
                       clock: Optional[StageClock] = None,
                       k21_hash=murmur3_k21) -> torch.Tensor:
    """(G, 2^p) uint8 registers of `genomes` on `device`, bit-identical
    per genome to ``galah_tpu.ops.hll.hll_sketch_genome``. Genomes are
    hashed in groups of at most ``FUSED_BUDGET`` bases (a longer genome
    alone). At k=21 with murmur3 a group's codes and contig starts go
    to the device and to `k21_hash(codes, starts, win0, n_win)`
    (``ops/murmur3_k21``: its kernel on cuda); other k and hashes build
    key words in torch (``ops/hashing.canonical_key_words``)."""
    device = resolve_device(device)
    regs = torch.zeros(len(genomes), 1 << p, dtype=torch.int32,
                       device=device)
    # galah-lint: ignore[GL1001] index lists of genomes already in memory; the count is reported
    groups = list(iter_groups(genomes, FUSED_BUDGET))
    for group in groups:
        if algo == "murmur3" and k == 21:
            loaded = load_group([genomes[i] for i in group], k, device)
            jobs = loaded.jobs
            hashes = k21_hash(loaded.codes, loaded.starts, 0,
                              max(loaded.codes.shape[0] - k + 1, 0))
        else:
            codes, offsets, jobs = host_layout(
                [genomes[i] for i in group], k)
            words, valid = canonical_key_words(codes, offsets, k, device,
                                               algo)
            hashes = masked_hashes(words, valid, k, algo)
            del words, valid
        fold_group(regs, hashes, jobs, group, p)
    if clock is not None:
        clock.count("hll-launch-groups", len(groups))
    return regs.to(torch.uint8)


def _rowblock(mat: torch.Tensor, cards: torch.Tensor, r0: int,
              min_ani: torch.Tensor, n: int, k: int, row_tile: int,
              col_tile: int, cap: int, union_stats):
    """One row block: the (row_tile, n_pad) ANI stripe, thresholded and
    compacted on the device. Returns (flat_idx, ani, count): up to
    `cap` flat indices into the stripe with their ANI, and the true
    number of passing entries. Column tiles wholly below the block's
    diagonal hold no i<j pair and are not computed."""
    n_pad, m = mat.shape
    c0 = (r0 // col_tile) * col_tile
    ani = torch.zeros(row_tile, n_pad, dtype=torch.float32,
                      device=mat.device)
    powsum, zeros = union_stats(mat[r0:r0 + row_tile], mat[c0:])
    ani[:, c0:] = _ani_from_union_stats(
        powsum, zeros, cards[r0:r0 + row_tile], cards[c0:], k, m)
    gi = r0 + torch.arange(row_tile, device=mat.device)[:, None]
    gj = torch.arange(n_pad, device=mat.device)[None, :]
    mask = (ani >= min_ani) & (gi < gj) & (gj < n)
    flat_idx = torch.nonzero(mask.reshape(-1))[:, 0]
    count = int(flat_idx.shape[0])
    flat_idx = flat_idx[:cap]
    return flat_idx, ani.reshape(-1)[flat_idx], count


def hll_threshold_pairs(regs: torch.Tensor, k: int, min_ani: float,
                        row_tile: int = ROW_TILE, col_tile: int = COL_TILE,
                        cap_per_row: int = CAP_PER_ROW,
                        union_stats=hll_union_stats, mesh=None
                        ) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} over the i<j pairs of an (N, 2^p) uint8
    register matrix whose f32 HLL Mash ANI reaches `min_ani` (compared
    in f32, as ``galah_tpu`` does). `union_stats` is
    ``hll_union_stats`` (the kernel on cuda) or its plain version. Over
    more than one slot (`mesh`, by default ``parallel/mesh.auto_mesh``
    of the device: every card of the process on its grid, or the ranks
    of a job) the pass is ``sharded_hll_threshold_pairs``."""
    from galah_tpu_torch.parallel import mesh as pmesh

    n, m = regs.shape
    if n == 0:
        return {}
    if mesh is None:
        mesh = pmesh.auto_mesh(regs.device)
    if mesh is not None and mesh.size > 1:
        return pmesh.sharded_hll_threshold_pairs(
            regs, k, min_ani, mesh, row_tile=row_tile, col_tile=col_tile,
            cap_per_row=cap_per_row, union_stats=union_stats)
    quantum = math.lcm(row_tile, col_tile)
    n_pad = -(-n // quantum) * quantum
    mat = torch.zeros(n_pad, m, dtype=torch.uint8, device=regs.device)
    mat[:n] = regs
    cards = hll_cardinality(mat)
    thr = torch.tensor(min_ani, dtype=torch.float32, device=regs.device)

    out: Dict[Tuple[int, int], float] = {}
    for r0, (flat_idx, vals, count) in iter_blocks(
            n, row_tile, cap_per_row,
            lambda r0, cap: _rowblock(mat, cards, r0, thr, n, k, row_tile,
                                      col_tile, cap, union_stats)):
        flat_idx = flat_idx[:count].cpu().numpy()
        vals = vals[:count].cpu().numpy()
        gi = r0 + flat_idx // n_pad
        gj = flat_idx % n_pad
        for a, b, v in zip(gi.tolist(), gj.tolist(), vals.tolist()):
            out[(int(a), int(b))] = float(v)
    return out
