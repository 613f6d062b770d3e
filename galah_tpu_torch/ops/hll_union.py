"""Pairwise HyperLogLog union statistics: the port of
``ops/pallas_hll.py``'s ``hll_union_stats_tile``.

For uint8 register rows (Br, m) and columns (Bc, m), per pair the sum
of ``2^-max(reg_r, reg_c)`` over the registers and the count of union
registers equal to 0, both float32 (Br, Bc): the two reductions of the
HLL union estimate (``ops/hll._estimate``). ``galah_tpu`` feeds its
kernel ``2^-reg`` as f32; the port reads the registers (4x fewer bytes)
and forms each term exactly. Sums are taken in float64 and rounded to
float32 once, by the kernel and by the plain version alike, so the two
agree bit for bit while every register is at most 41 (every real
genome) and within one f32 ulp beyond.

On CUDA tensors ``hll_union_stats`` launches the hand-written kernel
(``kernels/hll_union.cu``); on CPU tensors the plain torch version
beside it, ``hll_union_stats_plain``. A CUDA failure raises; nothing
falls back.

The kernel splits the register axis into slices so that every launch
fills the card (``plan_launch``): with more than one slice it writes
float64 partial sums and int32 zero counts to scratch, and a second
kernel adds them in slice order, so the result does not depend on
scheduling.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES

# the kernel's block: ROWS rows x COLS columns, SPLIT threads a column
ROWS = 8
COLS = 64
SPLIT = 4
# blocks a launch should have where m allows: 4 per SM of an H100
TARGET_BLOCKS = 4 * 132


class LaunchPlan(NamedTuple):
    """Slices of the register axis: `chunk` 16-register words each, the
    last one ragged; `blocks` is the launch's grid size."""
    slices: int
    chunk: int
    blocks: int


@functools.lru_cache(maxsize=256)
def plan_launch(br: int, bc: int, m: int) -> LaunchPlan:
    """The slice plan of one launch over (br, m) rows and (bc, m)
    columns: all words in one slice where the tiles alone give
    TARGET_BLOCKS blocks, else the largest chunk, a multiple of SPLIT
    words, that does, or SPLIT words a slice where m is too short."""
    words = m // 16
    tiles = -(-bc // COLS) * -(-br // ROWS)
    chunk = max(words, 1)
    if tiles < TARGET_BLOCKS and words > SPLIT:
        chunk = next((c for c in range(words // SPLIT * SPLIT, SPLIT, -SPLIT)
                      if tiles * -(-words // c) >= TARGET_BLOCKS), SPLIT)
    slices = -(-words // chunk) if words else 1
    return LaunchPlan(slices, chunk, tiles * slices)


def _check(rows: torch.Tensor, cols: torch.Tensor) -> None:
    for t in (rows, cols):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                "hll_union_stats takes contiguous 2-D uint8 registers; got "
                f"{t.dtype} {tuple(t.shape)}")
    if rows.device != cols.device or rows.shape[1] != cols.shape[1]:
        raise ValueError(
            f"hll_union_stats rows {tuple(rows.shape)} on {rows.device} "
            f"and cols {tuple(cols.shape)} on {cols.device} do not match")


def hll_union_stats(rows: torch.Tensor, cols: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(powsum, zeros) float32 (Br, Bc)."""
    _check(rows, cols)
    if rows.device.type == "cpu":
        return hll_union_stats_plain(rows, cols)
    return run_launch(prepare_launch(rows, cols))


def pow2_neg(device: torch.device) -> torch.Tensor:
    """2^-v for every uint8 v, exact in float64."""
    return torch.tensor([2.0 ** -v for v in range(256)],
                        dtype=torch.float64, device=device)


def hll_union_stats_plain(rows: torch.Tensor, cols: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch version: per row, the register-wise max against every
    column, its terms summed in float64, then float32."""
    lut = pow2_neg(rows.device)
    powsum = torch.empty(rows.shape[0], cols.shape[0], dtype=torch.float32,
                         device=rows.device)
    zeros = torch.empty_like(powsum)
    for i in range(rows.shape[0]):
        mx = torch.maximum(rows[i][None, :], cols)
        powsum[i] = lut[mx.long()].sum(-1).float()
        zeros[i] = (mx == 0).sum(-1).float()
    return powsum, zeros


class Launch(NamedTuple):
    """One planned launch: its operands, plan, outputs and scratch."""
    rows: torch.Tensor
    cols: torch.Tensor
    plan: LaunchPlan
    powsum: torch.Tensor
    zeros: torch.Tensor
    scratch: Optional[torch.Tensor]


def prepare_launch(rows: torch.Tensor, cols: torch.Tensor) -> Launch:
    """The host side of one kernel launch on checked CUDA registers:
    the plan, the outputs and, with more than one slice, one scratch
    buffer of S x Br x Bc float64 partial sums then int32 zero counts."""
    br, m = rows.shape
    bc = cols.shape[0]
    if br and bc and (m % 16 or rows.data_ptr() % 16
                      or cols.data_ptr() % 16):
        raise ValueError("the hll_union kernel reads 16 registers a load: "
                         "it needs m % 16 == 0 and 16-byte aligned rows; "
                         f"got m={m}")
    plan = plan_launch(br, bc, m)
    powsum, zeros = torch.empty(2, br, bc, dtype=torch.float32,
                                device=rows.device)
    scratch = None
    if plan.slices > 1 and br and bc:
        scratch = torch.empty(plan.slices * br * bc * 3, dtype=torch.int32,
                              device=rows.device)
    return Launch(rows, cols, plan, powsum, zeros, scratch)


def launch_args(launch: Launch) -> tuple:
    """The arguments of the C launch function ``hll_union_launch`` for
    a prepared launch, on the current stream."""
    rows, cols = launch.rows, launch.cols
    br, m = rows.shape
    bc = cols.shape[0]
    part_pow = part_zeros = None
    if launch.scratch is not None:
        part_pow = launch.scratch.data_ptr()
        part_zeros = part_pow + 8 * launch.plan.slices * br * bc
    return (rows.data_ptr(), cols.data_ptr(), br, bc, m, launch.plan.chunk,
            part_pow, part_zeros, launch.powsum.data_ptr(),
            launch.zeros.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)


def run_launch(launch: Launch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone (and, with slices, its combine), on a prepared
    launch; returns (powsum, zeros)."""
    from galah_tpu_torch.kernels import build

    if launch.powsum.numel() == 0:
        return launch.powsum, launch.zeros
    # the kernel refuses more than 65535 * 8 rows (its grid's y limit);
    # the pair pass gives it one row block
    err = build.load("hll_union").hll_union_launch(*launch_args(launch))
    build.check("hll_union", err)
    LAUNCHES["hll_union"] += 1
    return launch.powsum, launch.zeros
