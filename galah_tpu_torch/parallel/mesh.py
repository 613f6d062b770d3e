"""Device meshes and the all-pairs passes sharded over them: the port of
``galah_tpu/parallel/mesh.py``'s 1-D mesh and its 2D tiled mesh.

A mesh holds slots, each with a device and an owning rank, in a row
(shape ``(n,)``) or on an R x C grid (shape ``(r, c)``, slot s at mesh
row s // c and mesh column s % c). ``auto_mesh(device)`` gives:

- a multi-process job (``parallel/distributed.py``, one process a card
  under ``torchrun``) one slot a rank, on that rank's device; each rank
  computes the slots it owns and one exchange gives every rank what
  they found;
- one process on the card with two or more local cards
  (``local_devices``: ``cuda:0`` ... ``cuda:D-1``, as
  ``CUDA_VISIBLE_DEVICES`` leaves them) one slot a card;
- anything else None: one device takes the single-device passes.

The slots' layout is ``resolve_mesh_shape``'s, from
``GALAH_TPU_MESH_SHAPE`` as in ``galah_tpu``: ``auto`` (the default)
the squarest R x C grid, ``1d`` the row, ``RxC`` that grid; a count
with no non-trivial factorization, or a shape that does not cover the
count, takes the row with a ``mesh-demoted`` event. A demotion keeps
every device and kernel: it is a layout, not a fallback. A device may
repeat: ``make_mesh(["cpu"] * 4, shape=(2, 2))`` runs every index
computation of a 2 x 2 grid on one device, which is how the tests and
``chip_smoke.py`` exercise the sharding on one device.

The passes (``sharded_screen_pairs``, ``sharded_threshold_pairs``,
``sharded_hll_threshold_pairs``) share one blocked extraction,
``_extract``, over ``grid_schedule``: on a grid, slot (i, j) owns the
tile of row band i x column band j of the pair lattice and works local
row block lb, global rows ``i * rows_per_slot + lb ...``, against its
column band; the row is the grid (1, n), every slot working every row
block against its column range. Each slot launches the pass's kernel
(``tile_stats``' intersect or full form, ``hll_union``) once a tile,
skips the tiles wholly below the diagonal, masks and compacts its
candidates on its device to a capacity that ``ops/compact.iter_blocks``
raises on overflow, and every slot's launches for a row block are
enqueued before any count is read back: one host wait a row block. The
host applies the exact float64 check. Each operand is placed on each
slot's device once a pass, before the first row block: the row band and
the column band on a grid, the whole rows on the row; a placement on
the operands' own device is a view. ``sharded_stripe_stats`` shards the
streamed finch pass's stripes (done rows over mesh rows, the column
block over mesh columns), and ``sharded_pair_stats_for_pairs`` splits a
candidate pair list over the slots, one pairlist launch each.
``galah_tpu``'s ``sharded_pair_count`` has no counterpart: only its
benchmarks and dry run call it.

Every pair set is bit-identical to one device's whatever the mesh
(``galah_tpu``'s ``DETERMINISM_CONTRACT``): the statistics are
integers (or an elementwise float32 function of per-pair sums), the
device prefilter is conservative and the host check exact, and the
candidates come back in ``galah_tpu``'s order: per (row block, slot),
row-major within a slot. On a grid the slots whose tile lies wholly
below the diagonal (on 2 x 2, slot (1, 0)) get no work in the blocked
passes, as in ``galah_tpu``. Slots on distinct cards run in
``chip_smoke.py``'s phase 4q (c) (``--cards-only`` runs it alone).
"""

from __future__ import annotations

import logging
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from galah_tpu_torch import config
from galah_tpu_torch.obs import events as obs_events
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
    """Slots, each with a device (`devices`) and an owning rank
    (`owners`, all 0 in one process), in a row or on an R x C grid
    (`shape`, slots in row-major order)."""

    def __init__(self, devices: Sequence,
                 owners: Optional[Sequence[int]] = None,
                 shape: Optional[Tuple[int, ...]] = None) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.owners = ([0] * len(self.devices) if owners is None
                       else [int(o) for o in owners])
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} slots")
        self.shape = (len(self.devices),) if shape is None else \
            tuple(int(x) for x in shape)
        if len(self.shape) not in (1, 2) or \
                math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{len(self.devices)} slots")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def grid(self) -> Tuple[int, int]:
        """(mesh rows, mesh columns) of the blocked extraction: the
        shape of a grid, (1, n) for the row."""
        return self.shape if len(self.shape) == 2 else (1, self.size)

    def device(self, slot: int) -> torch.device:
        return self.devices[slot]

    def owned(self, slot: int) -> bool:
        """Whether this rank computes slot `slot`."""
        return self.owners[slot] == distributed.process_index()

    def flat(self) -> "Mesh":
        """The same slots in a row (``galah_tpu``'s 1-D mesh of every
        device, which its sparse survivor pass takes under any shape)."""
        return Mesh(self.devices, self.owners)


def make_mesh(devices: Sequence, owners: Optional[Sequence[int]] = None,
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over `devices` (torch devices or their names), in a row
    or on the grid `shape`."""
    return Mesh(devices, owners, shape)


def mesh_is_2d(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and len(mesh.shape) == 2


# ---------------------------------------------------------------------------
# the shape (GALAH_TPU_MESH_SHAPE) and the automatic mesh
# ---------------------------------------------------------------------------


def _squarest_factorization(n: int) -> Tuple[int, int]:
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def _demote_mesh_shape(raw: str, n: int, reason: str) -> None:
    obs_events.record("mesh-demoted", shape=raw, n_devices=n, reason=reason)
    obs_metrics.counter(
        "mesh.demoted_1d",
        help="2D mesh requests demoted to the 1-D fallback "
             "(non-factorable device count or a shape that does not "
             "cover it)").inc()
    logger.warning("mesh shape %r demoted to 1-D over %d devices: %s",
                   raw, n, reason)


def resolve_mesh_shape(n: int) -> Optional[Tuple[int, int]]:
    """(rows, cols) of the grid over `n` slots, or None for the row:
    ``galah_tpu``'s ``resolve_mesh_shape``. ``GALAH_TPU_MESH_SHAPE``
    ``auto`` takes the squarest factorization (the row at 1, and at a
    prime with a ``mesh-demoted`` event), ``1d`` (or ``1``) the row,
    ``RxC`` that grid; a shape that does not parse or cover `n`
    demotes to the row with the event."""
    raw = (config.env_value("GALAH_TPU_MESH_SHAPE") or "auto").strip().lower()
    if raw in ("1d", "1"):
        return None
    if raw == "auto":
        if n < 2:
            return None
        r, c = _squarest_factorization(n)
        if r == 1:
            _demote_mesh_shape(
                raw, n, "device count has no non-trivial factorization")
            return None
        return r, c
    try:
        r_s, _, c_s = raw.partition("x")
        r, c = int(r_s), int(c_s)
    except ValueError:
        _demote_mesh_shape(
            raw, n, "unparseable shape (want 'auto', '1d' or 'RxC')")
        return None
    if r < 1 or c < 1 or r * c != n:
        _demote_mesh_shape(raw, n, f"{r}x{c} does not cover {n} devices")
        return None
    return r, c


def local_devices(device) -> List[torch.device]:
    """The cards one process drives for `device`: every visible card,
    ``cuda:0`` ... ``cuda:D-1``, for the card (``torch.cuda
    .device_count()`` respects ``CUDA_VISIBLE_DEVICES``), `device`
    alone otherwise. Tests and ``chip_smoke.py`` stand this in."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def auto_mesh(device) -> Optional[Mesh]:
    """The mesh a run on `device` shards its pair passes over, on
    ``resolve_mesh_shape``'s layout: in a multi-process job one slot a
    rank, on that rank's device (every rank must call this: it is an
    exchange); in one process one slot a card of ``local_devices``
    when there are two or more; else None, the single-device
    passes."""
    if distributed.process_count() > 1:
        names = distributed.rank_devices(device)
        return make_mesh(names, owners=range(len(names)),
                         shape=resolve_mesh_shape(len(names)))
    cards = local_devices(device)
    if len(cards) < 2:
        return None
    return make_mesh(cards, shape=resolve_mesh_shape(len(cards)))


def _row_copies(mesh: Mesh) -> int:
    """The places beyond the first that hold an operand row in one
    sharded pass: the distinct (rank, device) places among the slots
    that hold it, every slot on the row, a row's mesh row and mesh
    column on a grid. On distinct cards that is ``galah_tpu``'s
    ``_dcn_crossings``: n - 1 on the row, (r - 1) + (c - 1) on a
    grid."""
    if mesh_is_2d(mesh):
        _r, c = mesh.shape
        slots = [s for s in range(mesh.size) if s // c == 0 or s % c == 0]
    else:
        slots = list(range(mesh.size))
    return len({(mesh.owners[s], str(mesh.devices[s])) for s in slots}) - 1


def _emit_copy_gauge(mesh: Mesh, row_bytes: int) -> None:
    obs_metrics.gauge(
        "mesh.dcn_bytes_per_row",
        help="Bytes of each operand row that one sharded pair pass "
             "holds beyond its first place: row bytes x the distinct "
             "(rank, device) places of the slots holding it beyond the "
             "first ((r-1)+(c-1) on a grid of distinct cards)",
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


class Schedule(NamedTuple):
    """The blocked extraction's work over n rows on a grid of `cols`
    mesh columns: `rows_per` rows a mesh row and `cols_per` columns a
    mesh column (of the padded count), `extent` the local row blocks'
    range, and `tiles(lb)` local row block lb's tiles in slot order."""
    n: int
    cols: int
    rows_per: int
    cols_per: int
    extent: int
    tiles: Callable[[int], List[Tile]]

    def row_span(self, slot: int) -> Tuple[int, int]:
        """The rows slot `slot`'s tiles take theirs from, cut at n."""
        i = slot // self.cols
        return (min(i * self.rows_per, self.n),
                min((i + 1) * self.rows_per, self.n))

    def col_span(self, slot: int) -> Tuple[int, int]:
        """The columns slot `slot`'s tiles take theirs from, cut at n."""
        j = slot % self.cols
        return (min(j * self.cols_per, self.n),
                min((j + 1) * self.cols_per, self.n))


def grid_schedule(n: int, grid: Tuple[int, int], row_tile: int,
                  col_tile: int) -> Schedule:
    """As in ``galah_tpu``'s tiled extractions: the rows are padded to
    a quantum that both bands divide, slot (i, j) works global rows
    ``i * rows_per + lb ...`` of each local row block lb against column
    band j from the block's diagonal tile on (the tiles wholly below it
    hold no i < j pair), cut at row and column n; a tile left empty is
    dropped. The grid (1, n) is ``galah_tpu``'s 1-D mesh."""
    r, c = grid
    q = math.lcm(r * row_tile, c * col_tile)
    n_pad = -(-n // q) * q
    rows_per, cols_per = n_pad // r, n_pad // c

    def tiles(lb: int) -> List[Tile]:
        out = []
        for slot in range(r * c):
            i, j = divmod(slot, c)
            r0 = i * rows_per + lb
            if r0 >= n:
                continue
            c_lo = max(j * cols_per, (r0 // col_tile) * col_tile)
            c_hi = min((j + 1) * cols_per, n)
            if c_lo < c_hi:
                out.append(Tile(slot, r0, min(r0 + row_tile, n), c_lo,
                                c_hi))
        return out

    return Schedule(n, c, rows_per, cols_per, min(rows_per, n), tiles)


def tile_schedule(n: int, n_slots: int, row_tile: int,
                  col_tile: int) -> Callable[[int], List[Tile]]:
    """The 1-D mesh's work over n rows on `n_slots` slots: a function
    from a row block's first row to its tiles in slot order
    (``grid_schedule`` on the grid (1, n_slots))."""
    return grid_schedule(n, (1, n_slots), row_tile, col_tile).tiles


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: one operand span's one copy to a slot's device
    in a pass (`t` itself on its own device)."""
    return t.to(device)


class _Placement:
    """The operands' spans of rows on the slots' devices, each placed
    once a pass: a span inside one already placed on a device is a view
    of it."""

    def __init__(self, operands: Dict[str, torch.Tensor]) -> None:
        self.operands = operands
        self.placed: Dict[Tuple[str, str], List[Tuple[int, int,
                                                      torch.Tensor]]] = {}

    def get(self, name: str, device: torch.device,
            span: Tuple[int, int]) -> torch.Tensor:
        """Rows [a, b) of operand `name` on `device`."""
        a, b = span
        held = self.placed.setdefault((name, str(device)), [])
        for a0, b0, t in held:
            if a0 <= a and b <= b0:
                return t[a - a0:b - a0]
        t = _place(self.operands[name][a:b], device)
        held.append((a, b, t))
        return t


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
    """The blocked extraction core: (gi, gj, payloads) numpy arrays of
    every passing i < j entry, in ``galah_tpu``'s order.

    `operands` are (N, ...) tensors indexed by row; `tile_fn(rows,
    cols, tile)` gets each operand's rows [r0, r1) and [c_lo, c_hi) on
    the slot's device and returns the tile's payload stripes and its
    pass mask there. In a multi-process job each rank computes its own
    slots, and one exchange at the end gives every rank every slot's
    candidates."""
    sched = grid_schedule(n, mesh.grid, row_tile, col_tile)
    n_pay = len(payload_dtypes)
    place = _Placement(operands)
    spans = {}
    # every working slot's spans placed before the first row block: a
    # slot with a tile anywhere has one in the first block
    for t in sched.tiles(0):
        if mesh.owned(t.slot):
            dev = mesh.device(t.slot)
            rs, cs = sched.row_span(t.slot), sched.col_span(t.slot)
            spans[t.slot] = (rs, {k: place.get(k, dev, rs) for k in operands},
                             cs, {k: place.get(k, dev, cs) for k in operands})

    def run_block(lb: int, cap: int):
        mine = [t for t in sched.tiles(lb) if mesh.owned(t.slot)]
        bufs = []
        for t in mine:  # enqueue every slot's work, then wait once
            (ra, _), rows, (ca, _), cols = spans[t.slot]
            stripes, mask = tile_fn(
                {k: v[t.r0 - ra:t.r1 - ra] for k, v in rows.items()},
                {k: v[t.c_lo - ca:t.c_hi - ca] for k, v in cols.items()}, t)
            bufs.append(_to_host(_compact(t, stripes, mask, cap)))
        _sync(mesh.device(t.slot) for t in mine)
        bufs = [b.numpy() for b in bufs]
        return mine, bufs, [int(b[0]) for b in bufs] or [0]

    records = []  # (block, slot, gi, gj, *payloads)
    for b_i, (_lb, (mine, bufs, _counts)) in enumerate(
            iter_blocks(sched.extent, row_tile, cap_per_row, run_block)):
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

    def tile_fn(rows, cols, t: Tile):
        inter, _ = tile_stats(rows["mat"], cols["mat"], width,
                              intersect=True)
        denom = torch.minimum(rows["cnt"][:, None], cols["cnt"][None, :])
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

    def tile_fn(rows, cols, t: Tile):
        common, total = tile_stats(rows["mat"], cols["mat"], sketch_size)
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
    # a CPU scalar: compared in float32 on any slot's device
    thr = torch.tensor(min_ani, dtype=torch.float32)
    _emit_copy_gauge(mesh, m * regs.element_size())

    def tile_fn(rows, cols, t: Tile):
        powsum, zeros = union_stats(rows["mat"], cols["mat"])
        ani = hll_ops._ani_from_union_stats(
            powsum, zeros, rows["cards"], cols["cards"], k, m)
        return (ani,), ani >= thr

    gi, gj, (vals,) = _extract(
        mesh, n, row_tile, col_tile, cap_per_row,
        {"mat": regs, "cards": cards}, tile_fn, (np.float32,), "hll")
    return {(int(a), int(b)): float(v) for a, b, v in
            zip(gi.tolist(), gj.tolist(), vals.tolist())}


def sharded_stripe_stats(rows_mat: torch.Tensor, cols_mat: torch.Tensor,
                         sketch_size: int, mesh: Mesh, row_tile: int = 64,
                         r_pad: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(common, total) int32 (r_pad, block) numpy arrays of every row of
    `rows_mat` (sentinel-padded to `r_pad` rows) against the column
    block `cols_mat`: the mesh twin of the streamed pass's one-launch
    stripe. The rows are sharded over the mesh rows (every slot on the
    row), the column block over the mesh columns of a grid, which must
    divide it; `r_pad` must be a multiple of mesh rows x `row_tile`.
    One full-form ``tile_stats`` launch a slot over its (row shard,
    column chunk), every launch enqueued before any result is read."""
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED
    from galah_tpu_torch.ops.tile_stats import tile_stats

    two_d = mesh_is_2d(mesh)
    r, c = mesh.shape if two_d else (mesh.size, 1)
    block, width = cols_mat.shape
    if block % c:
        raise ValueError(f"column block {block} not divisible by mesh "
                         f"cols {c}")
    q = r * row_tile
    if r_pad is None:
        r_pad = -(-rows_mat.shape[0] // q) * q
    if r_pad % q:
        raise ValueError(f"r_pad {r_pad} not a multiple of mesh "
                         f"{'rows' if two_d else 'size'} {r} x row_tile "
                         f"{row_tile}")
    if rows_mat.shape[0] < r_pad:
        pad = torch.full((r_pad - rows_mat.shape[0], width),
                         SENTINEL_BIASED, dtype=torch.int64,
                         device=rows_mat.device)
        rows_mat = torch.cat([rows_mat, pad])
    rs, bc = r_pad // r, block // c
    _emit_copy_gauge(mesh, width * cols_mat.element_size())
    place = _Placement({"rows": rows_mat, "cols": cols_mat})
    local, devs = {}, []
    for slot in range(mesh.size):
        if not mesh.owned(slot):
            continue
        i, j = divmod(slot, c)
        dev = mesh.device(slot)
        common, total = tile_stats(
            place.get("rows", dev, (i * rs, (i + 1) * rs)),
            place.get("cols", dev, (j * bc, (j + 1) * bc)), sketch_size)
        local[slot] = _to_host(torch.stack([common, total]))
        devs.append(dev)
    _sync(devs)
    local = {s: t.numpy().reshape(-1) for s, t in local.items()}
    shards = _gather_slots("stripe", mesh, local, [2 * rs * bc] * mesh.size,
                           np.int32)
    stats = np.empty((2, r_pad, block), np.int32)
    for slot, flat in enumerate(shards):
        i, j = divmod(slot, c)
        stats[:, i * rs:(i + 1) * rs, j * bc:(j + 1) * bc] = \
            flat.reshape(2, rs, bc)
    return stats[0], stats[1]


def sharded_pair_stats_for_pairs(mat: torch.Tensor, pi: np.ndarray,
                                 pj: np.ndarray, sketch_size: int,
                                 mesh: Mesh
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(common, total) int32 of an explicit pair list, the list split
    into one contiguous chunk a slot in slot order, whatever the
    mesh's shape, and each chunk one pairlist pass on its slot's
    device (the matrix placed on each device once), every pass
    enqueued before any is read: the same integers as
    ``ops/sparse_device.pair_stats_for_pairs`` over the whole list."""
    from galah_tpu_torch.ops.sparse_device import (collect_pair_stats,
                                                   enqueue_pair_stats)

    n_pairs = int(np.asarray(pi).shape[0])
    per = -(-n_pairs // mesh.size)
    bounds = [(min(s * per, n_pairs), min((s + 1) * per, n_pairs))
              for s in range(mesh.size)]
    place = _Placement({"mat": mat})
    enqueued = {}
    for slot, (a, b) in enumerate(bounds):
        if mesh.owned(slot):
            enqueued[slot] = enqueue_pair_stats(
                place.get("mat", mesh.device(slot), (0, mat.shape[0])),
                pi[a:b], pj[a:b], sketch_size)
    local = {s: np.concatenate(collect_pair_stats(h))
             for s, h in enqueued.items()}
    got = _gather_slots("pairlist", mesh, local,
                        [2 * (b - a) for a, b in bounds], np.int32)
    common = np.concatenate([g[:len(g) // 2] for g in got]) \
        if got else np.zeros(0, np.int32)
    total = np.concatenate([g[len(g) // 2:] for g in got]) \
        if got else np.zeros(0, np.int32)
    return common.astype(np.int32), total.astype(np.int32)
