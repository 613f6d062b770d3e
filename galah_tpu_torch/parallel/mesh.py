"""Device meshes and the all-pairs passes sharded over them: the port of
``galah_tpu/parallel/mesh.py``'s 1-D mesh.

A mesh is a row of slots, each with a device and an owning rank.
Several cards are several ranks (``parallel/distributed.py``, one
process a card under ``torchrun``): ``auto_mesh`` gives a multi-process
job one slot a rank, on that rank's device; each rank computes the
slots it owns and one exchange gives every rank what they found. One
process drives one card and takes the single-device passes. A device
may repeat: ``make_mesh(["cpu"] * 4)`` or ``make_mesh([cuda0] * 4)``
runs every index computation of a 4-slot mesh on one device, which is
how the tests and ``chip_smoke.py`` exercise the sharding in one
process.

``galah_tpu``'s 2D tiled mesh (``GALAH_TPU_MESH_SHAPE``) is not ported.
It shards rows over mesh rows and columns over mesh columns so that a
device holds less than the whole matrix; here every rank holds every
row (``allgather_host_rows``), so a grid would copy no fewer bytes, and
its pair sets are the 1-D mesh's.

The passes (``sharded_screen_pairs``, ``sharded_threshold_pairs``,
``sharded_hll_threshold_pairs``) share one blocked extraction: per row
block, each slot computes its column range with one launch of the
kernel the pass uses (``tile_stats``' intersect or full form,
``hll_union``), skips the tiles wholly below the diagonal, masks and
compacts its candidates on its device to a capacity that
``ops/compact.iter_blocks`` raises on overflow, and every slot's
launches for a row block are enqueued before any count is read back:
one host wait a row block. The host applies the exact float64 check.
``sharded_stripe_stats`` shards the streamed finch pass's stripes by
rows, and ``sharded_pair_stats_for_pairs`` splits a candidate pair list
over the slots, one pairlist launch each.

Every pair set is bit-identical to one device's whatever the mesh
(``galah_tpu``'s ``DETERMINISM_CONTRACT``): the statistics are
integers (or an elementwise float32 function of per-pair sums), the
device prefilter is conservative and the host check exact, and the
candidates come back in ``galah_tpu``'s order: per (row block, slot),
row-major within a slot. Ranks on different cards are written but have
not run on more than one card.
"""

from __future__ import annotations

import logging
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops.compact import iter_blocks
from galah_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)

# Numeric contract (GL9xx; module docstring): every sharded pass gives
# one device's pair set bit for bit, its exact check in float64.
DETERMINISM_CONTRACT = {
    "family": "mesh",
    "dtype": "float64",
    "functions": ["sharded_threshold_pairs", "sharded_stripe_stats",
                  "sharded_pair_stats_for_pairs"],
}


class Mesh:
    """Slots in a row: each slot's device (`devices`) and owning rank
    (`owners`, all 0 in one process)."""

    def __init__(self, devices: Sequence,
                 owners: Optional[Sequence[int]] = None) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.owners = ([0] * len(self.devices) if owners is None
                       else [int(o) for o in owners])
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} slots")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Tuple[int]:
        return (self.size,)

    def device(self, slot: int) -> torch.device:
        return self.devices[slot]

    def owned(self, slot: int) -> bool:
        """Whether this rank computes slot `slot`."""
        return self.owners[slot] == distributed.process_index()


def make_mesh(devices: Sequence,
              owners: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over `devices` (torch devices or their names)."""
    return Mesh(devices, owners)


def auto_mesh(device) -> Optional[Mesh]:
    """The mesh a run on `device` shards its pair passes over: in a
    multi-process job one slot a rank, on that rank's device (every
    rank must call this: it is an exchange); None in one process, which
    takes the single-device passes."""
    if distributed.process_count() < 2:
        return None
    names = distributed.rank_devices(device)
    return make_mesh(names, owners=range(len(names)))


def _row_copies(mesh: Mesh) -> int:
    """The places beyond the first that hold each operand row in one
    sharded pass: one a distinct (rank, device) among the slots. Every
    rank holds every row (``allgather_host_rows``), and a rank copies
    the operands once to each device its slots use."""
    return len({(o, str(d)) for o, d in zip(mesh.owners,
                                           mesh.devices)}) - 1


def _emit_copy_gauge(mesh: Mesh, row_bytes: int) -> None:
    obs_metrics.gauge(
        "mesh.dcn_bytes_per_row",
        help="Bytes of each operand row that one sharded pair pass "
             "holds beyond its first place: row bytes x (the distinct "
             "(rank, device) places of the mesh's slots - 1)",
        unit="bytes").set(float(_row_copies(mesh) * row_bytes))


# ---------------------------------------------------------------------------
# the blocked extraction
# ---------------------------------------------------------------------------


class Tile(NamedTuple):
    """One slot's share of one row block: rows [r0, r1) against columns
    [c_lo, c_hi)."""
    slot: int
    r0: int
    r1: int
    c_lo: int
    c_hi: int


def tile_schedule(n: int, n_slots: int, row_tile: int,
                  col_tile: int) -> Callable[[int], List[Tile]]:
    """The blocked extraction's work over n rows on `n_slots` slots: a
    function from a row block's first row to its tiles in slot order.

    As in ``galah_tpu``'s 1-D mesh: the columns are padded to a quantum
    that every slot's range divides, and slot d owns the d-th column
    range. A slot computes its columns from the block's diagonal tile
    on (the tiles wholly below it hold no i < j pair), cut at column n;
    a tile left empty is dropped."""
    q = math.lcm(n_slots * col_tile, row_tile)
    cols_per = -(-n // q) * q // n_slots

    def tiles(r0: int) -> List[Tile]:
        out = []
        for slot in range(n_slots):
            c_lo = max(slot * cols_per, (r0 // col_tile) * col_tile)
            c_hi = min((slot + 1) * cols_per, n)
            if c_lo < c_hi:
                out.append(Tile(slot, r0, min(r0 + row_tile, n), c_lo,
                                c_hi))
        return out

    return tiles


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of `t` to the host (pinned from a card); it
    holds `t` once the device of `t` has been synchronized."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _sync(devices) -> None:
    for key in sorted({str(d) for d in devices}):
        d = torch.device(key)
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def _compact(tile: Tile, stripes: Sequence[torch.Tensor],
             mask: torch.Tensor, cap: int) -> torch.Tensor:
    """One float64 vector on the tile's device: [count, cap flat
    indices into the (rows, cols) tile (-1 past the count), each
    payload at those indices]. No host wait: the indices are scattered
    to their ranks among the passing entries. float64 holds the int32
    and float32 payloads and the indices exactly."""
    dev = mask.device
    gi = torch.arange(tile.r0, tile.r1, device=dev)[:, None]
    gj = torch.arange(tile.c_lo, tile.c_hi, device=dev)[None, :]
    flat = (mask & (gi < gj)).reshape(-1)
    pos = torch.cumsum(flat, 0) - 1
    target = torch.where(flat & (pos < cap), pos,
                         torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    idx.scatter_(0, target, torch.arange(flat.numel(), device=dev))
    idx = idx[:cap]
    safe = idx.clamp(min=0)
    return torch.cat([flat.sum().reshape(1).double(), idx.double(),
                      *(s.reshape(-1)[safe].double() for s in stripes)])


def _extract(mesh: Mesh, n: int, row_tile: int, col_tile: int,
             cap_per_row: int, operands: Dict[str, torch.Tensor],
             tile_fn, payload_dtypes: Sequence[np.dtype], tag: str):
    """The blocked extraction core: (gi, gj, payloads)
    numpy arrays of every passing i < j entry, in ``galah_tpu``'s order.

    `tile_fn(arrays, tile)` returns the tile's payload stripes and its
    pass mask on the arrays' device. In a multi-process job each rank
    computes its own slots, and one exchange at the end gives every
    rank every slot's candidates."""
    tiles_of = tile_schedule(n, mesh.size, row_tile, col_tile)
    n_pay = len(payload_dtypes)

    def run_block(r0: int, cap: int):
        mine = [t for t in tiles_of(r0) if mesh.owned(t.slot)]
        bufs = []
        for t in mine:  # enqueue every slot's work, then wait once
            dev = mesh.device(t.slot)
            # a no-op on the operands' own device
            arrays = {k: v.to(dev) for k, v in operands.items()}
            stripes, mask = tile_fn(arrays, t)
            bufs.append(_to_host(_compact(t, stripes, mask, cap)))
        _sync(mesh.device(t.slot) for t in mine)
        bufs = [b.numpy() for b in bufs]
        return mine, bufs, [int(b[0]) for b in bufs] or [0]

    records = []  # (block, slot, gi, gj, *payloads)
    for b_i, (_lb, (mine, bufs, _counts)) in enumerate(
            iter_blocks(n, row_tile, cap_per_row, run_block)):
        for t, buf in zip(mine, bufs):
            cnt = int(buf[0])
            cap = (buf.shape[0] - 1) // (1 + n_pay)
            fi = buf[1:1 + cnt].astype(np.int64)
            w = t.c_hi - t.c_lo
            pays = [buf[1 + cap * (1 + p):1 + cap * (1 + p) + cnt]
                    for p in range(n_pay)]
            records.append(np.stack(
                [np.full(cnt, b_i, np.float64), np.full(cnt, t.slot,
                                                        np.float64),
                 (t.r0 + fi // w).astype(np.float64),
                 (t.c_lo + fi % w).astype(np.float64), *pays], axis=1))
    rows = (np.concatenate(records) if records
            else np.zeros((0, 4 + n_pay), np.float64))
    if distributed.process_count() > 1:
        gathered = distributed.exchange(f"mesh-{tag}", rows, fill=-1.0)
        rows = gathered.reshape(-1, 4 + n_pay)
        rows = rows[rows[:, 0] >= 0]
        rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    gi = rows[:, 2].astype(np.int64)
    gj = rows[:, 3].astype(np.int64)
    return gi, gj, [rows[:, 4 + p].astype(dt)
                    for p, dt in enumerate(payload_dtypes)]


def _gather_slots(tag: str, mesh: Mesh, local: Dict[int, np.ndarray],
                  sizes: Sequence[int], dtype) -> List[np.ndarray]:
    """Every slot's flat array on every rank, from this rank's owned
    slots (`local`); slot s holds sizes[s] values."""
    if distributed.process_count() == 1:
        return [local[s] for s in range(mesh.size)]
    mine = [local[s] for s in range(mesh.size) if mesh.owned(s)]
    flat = (np.concatenate(mine) if mine else np.zeros(0, dtype)).astype(
        dtype, copy=False)
    gathered = distributed.exchange(f"mesh-{tag}", flat)
    out: List[np.ndarray] = [np.zeros(0, dtype)] * mesh.size
    for rank in range(gathered.shape[0]):
        off = 0
        for s in range(mesh.size):
            if mesh.owners[s] == rank:
                out[s] = gathered[rank, off:off + sizes[s]]
                off += sizes[s]
    return out


# ---------------------------------------------------------------------------
# the sharded passes
# ---------------------------------------------------------------------------


def sharded_screen_pairs(marker_mat: torch.Tensor, counts: np.ndarray,
                         c_floor: float, mesh: Mesh, row_tile: int = 64,
                         col_tile: int = 256, cap_per_row: int = 256
                         ) -> List[Tuple[int, int]]:
    """i < j pairs whose marker containment reaches `c_floor`, sorted,
    over the (N, M) biased marker matrix: the mesh twin of
    ``ops/pairwise.screen_pairs`` (``tile_stats``' intersect form a
    tile, min-count containment as the threshold)."""
    from galah_tpu_torch.ops.tile_stats import tile_stats

    n, width = marker_mat.shape
    counts64 = np.asarray(counts, dtype=np.int64)
    cnt = torch.from_numpy(counts64.astype(np.int32)).to(marker_mat.device)
    c_floor_lo = c_floor * (1.0 - 1e-12) - 1e-300
    _emit_copy_gauge(mesh, width * marker_mat.element_size())

    def tile_fn(arrs, t: Tile):
        mat, ct = arrs["mat"], arrs["cnt"]
        inter, _ = tile_stats(mat[t.r0:t.r1], mat[t.c_lo:t.c_hi], width,
                              intersect=True)
        denom = torch.minimum(ct[t.r0:t.r1, None], ct[None, t.c_lo:t.c_hi])
        mask = (inter.to(torch.float64)
                >= c_floor_lo * denom.to(torch.float64)) & (inter > 0)
        return (inter, denom), mask

    gi, gj, (inter, denom) = _extract(
        mesh, n, row_tile, col_tile, cap_per_row,
        {"mat": marker_mat, "cnt": cnt}, tile_fn,
        (np.int32, np.int32), "screen")
    denom = denom.astype(np.float64)
    keep = (denom > 0) & (inter.astype(np.float64) >= c_floor * denom)
    out = list(zip(gi[keep].tolist(), gj[keep].tolist()))
    out.sort()
    return out


def sharded_threshold_pairs(sketch_mat: torch.Tensor, k: int,
                            min_ani: float, mesh: Mesh,
                            sketch_size: Optional[int] = None,
                            row_tile: int = 64, col_tile: int = 128,
                            cap_per_row: int = 64
                            ) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} of the i < j pairs whose float64 Mash ANI
    reaches `min_ani`, over the (N, K) biased sketch matrix: the mesh
    twin of ``ops/pairwise.threshold_pairs`` (``tile_stats``' full form
    a tile, a conservative float64 threshold on the device, the exact
    integer-Jaccard check on the host)."""
    from galah_tpu_torch.ops.pairwise import ani_to_jaccard, stats_to_ani_f64
    from galah_tpu_torch.ops.tile_stats import tile_stats

    n, width = sketch_mat.shape
    if sketch_size is None:
        sketch_size = width
    j_thr = ani_to_jaccard(min_ani, k)
    j_thr_lo = j_thr * (1.0 - 1e-12) - 1e-300
    _emit_copy_gauge(mesh, width * sketch_mat.element_size())

    def tile_fn(arrs, t: Tile):
        mat = arrs["mat"]
        common, total = tile_stats(mat[t.r0:t.r1], mat[t.c_lo:t.c_hi],
                                   sketch_size)
        mask = (common.to(torch.float64)
                >= j_thr_lo * total.to(torch.float64)) & (common > 0)
        return (common, total), mask

    gi, gj, (common, total) = _extract(
        mesh, n, row_tile, col_tile, cap_per_row,
        {"mat": sketch_mat}, tile_fn, (np.int32, np.int32),
        "threshold")
    common = common.astype(np.int64)
    total = total.astype(np.int64)
    keep = common.astype(np.float64) >= j_thr * total
    ani = stats_to_ani_f64(common[keep], total[keep], k)
    return {(int(a), int(b)): float(v) for a, b, v in
            zip(gi[keep].tolist(), gj[keep].tolist(), ani.tolist())}


def sharded_hll_threshold_pairs(regs: torch.Tensor, k: int, min_ani: float,
                                mesh: Mesh, row_tile: int = 64,
                                col_tile: int = 128, cap_per_row: int = 64,
                                union_stats=None
                                ) -> Dict[Tuple[int, int], float]:
    """Sparse {(i, j): ani} over (N, 2^p) uint8 HLL registers, the f32
    ANI compared in f32: the mesh twin of ``ops/hll
    .hll_threshold_pairs`` (its `union_stats`, the ``hll_union`` kernel
    on the card, a tile). ``galah_tpu`` computes the union statistics
    with XLA here; the kernel computes the same function."""
    from galah_tpu_torch.ops import hll as hll_ops
    from galah_tpu_torch.ops.hll_union import hll_union_stats

    union_stats = union_stats or hll_union_stats
    n, m = regs.shape
    cards = hll_ops.hll_cardinality(regs)
    thr = torch.tensor(min_ani, dtype=torch.float32, device=regs.device)
    _emit_copy_gauge(mesh, m * regs.element_size())

    def tile_fn(arrs, t: Tile):
        mat, cd = arrs["mat"], arrs["cards"]
        powsum, zeros = union_stats(mat[t.r0:t.r1], mat[t.c_lo:t.c_hi])
        ani = hll_ops._ani_from_union_stats(
            powsum, zeros, cd[t.r0:t.r1], cd[t.c_lo:t.c_hi], k, m)
        return (ani,), ani >= arrs["thr"]

    gi, gj, (vals,) = _extract(
        mesh, n, row_tile, col_tile, cap_per_row,
        {"mat": regs, "cards": cards, "thr": thr}, tile_fn,
        (np.float32,), "hll")
    return {(int(a), int(b)): float(v) for a, b, v in
            zip(gi.tolist(), gj.tolist(), vals.tolist())}


def sharded_stripe_stats(rows_mat: torch.Tensor, cols_mat: torch.Tensor,
                         sketch_size: int, mesh: Mesh, row_tile: int = 64,
                         r_pad: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(common, total) int32 (r_pad, block) numpy arrays of every row of
    `rows_mat` (sentinel-padded to `r_pad` rows) against the column
    block `cols_mat`, the rows sharded over the slots: the mesh twin of
    the streamed pass's one-launch stripe. `r_pad` must be a multiple
    of slots x `row_tile`. One full-form ``tile_stats`` launch a slot
    over its row shard, every launch enqueued before any result is
    read."""
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED
    from galah_tpu_torch.ops.tile_stats import tile_stats

    n_dev = mesh.size
    q = n_dev * row_tile
    if r_pad is None:
        r_pad = -(-rows_mat.shape[0] // q) * q
    if r_pad % q:
        raise ValueError(f"r_pad {r_pad} not a multiple of mesh size "
                         f"{n_dev} x row_tile {row_tile}")
    block, width = cols_mat.shape
    if rows_mat.shape[0] < r_pad:
        pad = torch.full((r_pad - rows_mat.shape[0], width),
                         SENTINEL_BIASED, dtype=torch.int64,
                         device=rows_mat.device)
        rows_mat = torch.cat([rows_mat, pad])
    rs = r_pad // n_dev
    _emit_copy_gauge(mesh, width * cols_mat.element_size())
    local, devs = {}, []
    for slot in range(n_dev):
        if not mesh.owned(slot):
            continue
        dev = mesh.device(slot)
        common, total = tile_stats(rows_mat[slot * rs:(slot + 1) * rs]
                                   .to(dev), cols_mat.to(dev), sketch_size)
        local[slot] = _to_host(torch.stack([common, total]))
        devs.append(dev)
    _sync(devs)
    local = {s: t.numpy().reshape(-1) for s, t in local.items()}
    shards = _gather_slots("stripe", mesh, local, [2 * rs * block] * n_dev,
                           np.int32)
    stats = np.concatenate([flat.reshape(2, rs, block) for flat in shards],
                           axis=1)
    return stats[0], stats[1]


def sharded_pair_stats_for_pairs(mat: torch.Tensor, pi: np.ndarray,
                                 pj: np.ndarray, sketch_size: int,
                                 mesh: Mesh
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(common, total) int32 of an explicit pair list, the list split
    into one contiguous chunk a slot and each chunk one pairlist pass
    on its slot's device, every pass enqueued before any is read: the
    same integers as ``ops/sparse_device.pair_stats_for_pairs`` over
    the whole list."""
    from galah_tpu_torch.ops.sparse_device import (collect_pair_stats,
                                                   enqueue_pair_stats)

    n_pairs = int(np.asarray(pi).shape[0])
    per = -(-n_pairs // mesh.size)
    bounds = [(min(s * per, n_pairs), min((s + 1) * per, n_pairs))
              for s in range(mesh.size)]
    enqueued = {}
    for slot, (a, b) in enumerate(bounds):
        if mesh.owned(slot):
            enqueued[slot] = enqueue_pair_stats(
                mat.to(mesh.device(slot)), pi[a:b], pj[a:b],
                sketch_size)
    local = {s: np.concatenate(collect_pair_stats(h))
             for s, h in enqueued.items()}
    got = _gather_slots("pairlist", mesh, local,
                        [2 * (b - a) for a, b in bounds], np.int32)
    common = np.concatenate([g[:len(g) // 2] for g in got]) \
        if got else np.zeros(0, np.int32)
    total = np.concatenate([g[len(g) // 2:] for g in got]) \
        if got else np.zeros(0, np.int32)
    return common.astype(np.int32), total.astype(np.int32)
