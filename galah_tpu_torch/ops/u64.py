"""How the port holds 64-bit hashes: biased int64.

torch's ``uint64`` lacks ``lt``, ``searchsorted``, ``>>`` and ``add`` on
the CPU, so every 64-bit hash is carried as ``x_u64 ^ 2**63`` viewed
as int64. The bias keeps unsigned order under signed compare, so
``sort``, ``unique``, ``searchsorted`` and the CUDA kernels' signed
``int64_t`` compares all order hashes exactly as u64 would, and the
u64 sentinel (all ones) becomes ``INT64_MAX``, still last.

Conversion happens only at the numpy boundary (``to_biased`` /
``from_biased``). Hash arithmetic runs on UNBIASED int64 with
wrap-around ``*`` and ``+`` (two's complement makes them equal to u64
arithmetic bit for bit); the bias is applied after hashing.
"""

from __future__ import annotations

import numpy as np
import torch

BIAS = 1 << 63
_INT64_MIN = -(1 << 63)


def as_int64(u: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= BIAS else u


def biased_scalar(u: int) -> int:
    """A u64 value in the biased domain, as a Python int: compare a
    biased tensor against it to compare the u64 values."""
    return u - BIAS


def to_biased(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint64 numpy array -> biased int64 tensor on `device`."""
    a = np.asarray(a, dtype=np.uint64)
    b = (a ^ np.uint64(BIAS)).view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(b)).to(device)


def from_biased(t: torch.Tensor) -> np.ndarray:
    """Biased int64 tensor -> uint64 numpy array."""
    a = t.detach().to("cpu").contiguous().numpy()
    return a.view(np.uint64) ^ np.uint64(BIAS)


def bias(t: torch.Tensor) -> torch.Tensor:
    """Unbiased int64 (u64 bits) -> biased int64."""
    return t ^ _INT64_MIN


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is
    arithmetic, so the sign-extended top bits are masked off)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 64 - r)
