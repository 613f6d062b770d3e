"""Bottom-k MinHash sketches and the Mash distance, in numpy: the
port's own copy of ``galah_tpu/ops/minhash_np.py``'s sketch type and
distance (reference: src/finch.rs:26-73).

A sketch is the sorted ascending distinct bottom-k uint64 hashes of a
genome's canonical k-mers. ``mash_jaccard`` walks two sketches in merge
order over the smallest ``sketch_size`` distinct union hashes; ANI is
``1 - d`` with the Mash distance ``d = -ln(2j / (1 + j)) / k``. The
sketchers live in ``ops/minhash.py`` and ``ops/sketch_stream.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class MinHashSketch:
    """Sorted ascending distinct bottom-k hash sketch of one genome."""

    hashes: np.ndarray  # uint64 [<= sketch_size], sorted ascending
    sketch_size: int
    kmer: int

    @property
    def size(self) -> int:
        return int(self.hashes.shape[0])


def mash_jaccard(a: MinHashSketch, b: MinHashSketch) -> float:
    """Merged-bottom-k Jaccard estimate (Mash/finch semantics)."""
    size = min(a.sketch_size, b.sketch_size)
    ha, hb = a.hashes, b.hashes
    i = j = common = total = 0
    la, lb = len(ha), len(hb)
    while i < la and j < lb and total < size:
        if ha[i] < hb[j]:
            i += 1
        elif hb[j] < ha[i]:
            j += 1
        else:
            common += 1
            i += 1
            j += 1
        total += 1
    while i < la and total < size:
        i += 1
        total += 1
    while j < lb and total < size:
        j += 1
        total += 1
    if total == 0:
        return 0.0
    return common / total


def mash_ani(a: MinHashSketch, b: MinHashSketch) -> float:
    """ANI = 1 - Mash distance (reference: src/finch.rs:56-64)."""
    j = mash_jaccard(a, b)
    if j <= 0.0:
        return 0.0
    d = -math.log(2.0 * j / (1.0 + j)) / a.kmer
    return 1.0 - d
