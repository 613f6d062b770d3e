"""Carry per-genome state across from ``galah_tpu``.

The system has no weights: its state is the per-genome profile (the
positional hashes, the distinct set and the markers), for finch the
(N, K) sketch matrix, and for dashing the (N, 2^p) HLL register matrix.
``galah_tpu`` keeps hashes as uint64 numpy arrays, the port as biased
int64 tensors (``ops/u64.py``); registers are uint8 in both. These
functions convert between the two without importing ``galah_tpu``: a
profile's source is any object with the profile's attributes (a
``galah_tpu`` ``GenomeProfile`` qualifies), the result of the inverse
is a dict of its constructor fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from galah_tpu_torch.ops.fragment_ani import GenomeProfile
from galah_tpu_torch.ops.u64 import from_biased, to_biased

FIELDS = ("path", "k", "fraglen", "flat_hashes", "ref_set", "markers",
          "subsample_c")


def profile_from_galah(src, device="cpu") -> GenomeProfile:
    """A port profile on `device` from a galah_tpu profile's arrays."""
    return GenomeProfile(
        path=src.path, k=int(src.k), fraglen=int(src.fraglen),
        flat_hashes=to_biased(src.flat_hashes, device),
        ref_set=to_biased(src.ref_set, device),
        markers=to_biased(src.markers, device),
        subsample_c=int(src.subsample_c))


def profile_to_galah_fields(prof: GenomeProfile) -> Dict:
    """The constructor fields of a galah_tpu GenomeProfile (uint64
    numpy arrays) for a port profile."""
    return dict(path=prof.path, k=prof.k, fraglen=prof.fraglen,
                flat_hashes=from_biased(prof.flat_hashes),
                ref_set=from_biased(prof.ref_set),
                markers=from_biased(prof.markers),
                subsample_c=prof.subsample_c)


def sketch_matrix_from_galah(mat: np.ndarray, device="cpu") -> torch.Tensor:
    """galah_tpu's sentinel-padded (N, K) uint64 sketch matrix
    (``ops/minhash.sketch_matrix``) as the port's biased int64 tensor."""
    if mat.dtype != np.uint64 or mat.ndim != 2:
        raise ValueError("a galah_tpu sketch matrix is 2-D uint64; got "
                         f"{mat.dtype} {mat.shape}")
    return to_biased(mat, device)


def sketch_matrix_to_galah(mat: torch.Tensor) -> np.ndarray:
    """The port's (N, K) biased sketch matrix as galah_tpu's uint64."""
    if mat.dtype != torch.int64 or mat.dim() != 2:
        raise ValueError("a port sketch matrix is 2-D int64; got "
                         f"{mat.dtype} {tuple(mat.shape)}")
    return from_biased(mat)


def hll_registers_from_galah(regs: np.ndarray, device="cpu") -> torch.Tensor:
    """galah_tpu's (N, 2^p) uint8 HLL register matrix (the rows of
    ``ops/hll.hll_sketch_genome``) as the port's uint8 tensor."""
    if regs.dtype != np.uint8 or regs.ndim != 2:
        raise ValueError("a galah_tpu register matrix is 2-D uint8; got "
                         f"{regs.dtype} {regs.shape}")
    return torch.from_numpy(np.ascontiguousarray(regs)).to(device)


def hll_registers_to_galah(regs: torch.Tensor) -> np.ndarray:
    """The port's (N, 2^p) uint8 register matrix as galah_tpu's."""
    if regs.dtype != torch.uint8 or regs.dim() != 2:
        raise ValueError("a port register matrix is 2-D uint8; got "
                         f"{regs.dtype} {tuple(regs.shape)}")
    return regs.detach().cpu().numpy()
