"""Exact MinHash sketching on the device: the port of
``galah_tpu/ops/minhash.py``.

``sketch_genome_device`` hashes every canonical k-mer of a genome
(``ops/hashing.positional_hashes``, chunked so any length fits), drops
the invalid windows, and keeps the ``sketch_size`` smallest distinct
hashes (``torch.unique``, sorted). It serves the genomes the fused path
does not take (longer than ``DEFAULT_CHUNK``, or a sketch size beyond
the candidate file's capacity) and re-sketches the jobs the fused
path's certificate flags. ``sketch_matrix`` stacks sketches into the
(N, sketch_size) biased int64 matrix the all-pairs pass reads
(``sketch_rows`` does it from bare uint64 rows, as the sketch index
holds them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops.constants import SENTINEL_BIASED, SENTINEL_U64
from galah_tpu_torch.ops.hashing import positional_hashes
from galah_tpu_torch.ops.minhash_np import MinHashSketch
from galah_tpu_torch.ops.u64 import from_biased, to_biased



def sketch_genome_device(genome: Genome,
                         sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
                         k: int = Defaults.MINHASH_KMER,
                         algo: str = Defaults.HASH_ALGO,
                         device="cuda", k21_hash=None) -> MinHashSketch:
    """Bottom-k distinct canonical k-mer sketch, computed on `device`
    (`k21_hash` as in ``ops/hashing.positional_hashes``)."""
    flat = positional_hashes(genome, k, resolve_device(device), algo=algo,
                             k21_hash=k21_hash)
    distinct = torch.unique(flat[flat != SENTINEL_BIASED], sorted=True)
    return MinHashSketch(hashes=from_biased(distinct[:sketch_size]),
                         sketch_size=sketch_size, kmer=k)


def sketch_genomes_device_batch(
        genomes: Sequence[Genome],
        sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
        k: int = Defaults.MINHASH_KMER,
        algo: str = Defaults.HASH_ALGO,
        device="cuda") -> List[MinHashSketch]:
    """``sketch_genome_device`` for each genome. ``galah_tpu`` groups
    genomes into one XLA dispatch here; eager torch needs no grouping."""
    return [sketch_genome_device(g, sketch_size, k, algo, device)
            for g in genomes]


def sketch_rows(hashes: Sequence[np.ndarray],
                sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
                device="cuda", rows: Optional[int] = None) -> torch.Tensor:
    """Ascending uint64 hash rows, each cut to its first `sketch_size`
    values, as a sentinel-padded (rows, sketch_size) biased int64 tensor
    on `device`; the rows past the given ones (`rows` defaults to their
    count) are all sentinel. A row shorter than `sketch_size` is padded
    here only."""
    mat = np.full((len(hashes) if rows is None else rows, sketch_size),
                  SENTINEL_U64, dtype=np.uint64)
    for i, h in enumerate(hashes):
        m = min(h.shape[0], sketch_size)
        mat[i, :m] = h[:m]
    return to_biased(mat, resolve_device(device))


def sketch_matrix(sketches: Sequence[MinHashSketch],
                  sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
                  device="cuda") -> torch.Tensor:
    """Sketches stacked into a sentinel-padded (N, sketch_size) biased
    int64 tensor on `device`, rows ascending."""
    return sketch_rows([s.hashes for s in sketches], sketch_size, device)
