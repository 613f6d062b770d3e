"""Single-linkage precluster partitioning via union-find (a copy of
galah_tpu/cluster/partition.py).

Equivalent of the reference's partition_sketches + DisjointSetVec
(reference: src/clusterer.rs:409-431): every cached pair joins its two
genomes; connected components become preclusters, each sorted ascending,
and the precluster list is ordered biggest-first so large components are
scheduled before small ones (reference: src/clusterer.rs:45-57).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


class UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


def partition_preclusters(
    n_genomes: int, pair_keys: Iterable[Tuple[int, int]]
) -> List[List[int]]:
    """Connected components of the thresholded pair graph, biggest first.

    Ties in size keep the component of the lowest genome index first
    (stable, unlike the reference's unstable sort — deterministic output).
    """
    uf = UnionFind(n_genomes)
    for i, j in pair_keys:
        uf.union(i, j)
    comps: dict[int, List[int]] = {}
    for g in range(n_genomes):
        comps.setdefault(uf.find(g), []).append(g)
    out = [sorted(members) for members in comps.values()]
    out.sort(key=lambda c: (-len(c), c[0]))
    return out
