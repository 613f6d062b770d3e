"""Sparse pair-distance cache keyed by sorted genome-index pairs (a
copy of galah_tpu/cluster/cache.py).

Equivalent of the reference's SortedPairGenomeDistanceCache
(reference: src/sorted_pair_genome_distance_cache.rs:5-58): a mapping
(i, j) -> Optional[ANI] where the key is always stored sorted ascending,
plus `transform_ids` to re-index a precluster subset into local 0..n ids.

Values are ANI fractions in [0, 1]; `None` records "computed but failed
the aligned-fraction gate" (distinct from absent = never computed).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

Key = Tuple[int, int]


def pair_key(i: int, j: int) -> Key:
    return (i, j) if i < j else (j, i)


class PairDistanceCache:
    def __init__(self) -> None:
        self._d: Dict[Key, Optional[float]] = {}

    def insert(self, key: Tuple[int, int], ani: Optional[float]) -> None:
        self._d[pair_key(*key)] = ani

    def get(self, key: Tuple[int, int]) -> Optional[float]:
        """Value for a computed pair; None if absent OR computed-but-None.

        Use `contains` to distinguish the two, as the reference does.
        """
        return self._d.get(pair_key(*key))

    def contains(self, key: Tuple[int, int]) -> bool:
        return pair_key(*key) in self._d

    def keys(self) -> Iterable[Key]:
        return self._d.keys()

    def items(self):
        return self._d.items()

    def __len__(self) -> int:
        return len(self._d)

    def __eq__(self, other) -> bool:
        return isinstance(other, PairDistanceCache) and self._d == other._d

    def __repr__(self) -> str:
        return f"PairDistanceCache({self._d!r})"

    def transform_ids(self, indices: Sequence[int]) -> "PairDistanceCache":
        """Re-key the subset `indices` into local ids 0..len(indices)-1.

        `indices` must be sorted ascending (precluster members are);
        mirrors reference src/sorted_pair_genome_distance_cache.rs:47-58.

        Cost: min(m^2/2 probes, one full-cache scan) — the greedy
        engine calls this once per precluster, and scanning the whole
        cache each time measured 22.7 s of a 40k-genome run (10k
        preclusters x 150k cached pairs); typical preclusters have a
        handful of members, so probing their own pairs wins by orders
        of magnitude, while near-duplicate mega-preclusters keep the
        scan path.
        """
        out = PairDistanceCache()
        m = len(indices)
        missing = object()
        if m * (m - 1) // 2 < len(self._d):
            for a in range(m):
                gi = indices[a]
                for b in range(a + 1, m):
                    v = self._d.get(pair_key(gi, indices[b]), missing)
                    if v is not missing:
                        out.insert((a, b), v)
            return out
        remap = {g: l for l, g in enumerate(indices)}
        for (i, j), v in self._d.items():
            if i in remap and j in remap:
                out.insert((remap[i], remap[j]), v)
        return out
