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
"""

from __future__ import annotations

from typing import Tuple

import torch

from galah_tpu_torch.kernels import LAUNCHES


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
    return _launch(rows, cols)


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


def _launch(rows: torch.Tensor, cols: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    from galah_tpu_torch.kernels import build

    br, m = rows.shape
    bc = cols.shape[0]
    powsum = torch.empty(br, bc, dtype=torch.float32, device=rows.device)
    zeros = torch.empty_like(powsum)
    if br == 0 or bc == 0:
        return powsum, zeros
    if m % 16 or rows.data_ptr() % 16 or cols.data_ptr() % 16:
        raise ValueError("the hll_union kernel reads 16 registers a load: "
                         "it needs m % 16 == 0 and 16-byte aligned rows; "
                         f"got m={m}")
    lib = build.load("hll_union")
    # the kernel refuses more than 65535 * 8 rows (its grid's y limit);
    # the pair pass gives it one row block
    err = lib.hll_union_launch(
        rows.data_ptr(), cols.data_ptr(), br, bc, m, powsum.data_ptr(),
        zeros.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream)
    build.check("hll_union", err)
    LAUNCHES["hll_union"] += 1
    return powsum, zeros
