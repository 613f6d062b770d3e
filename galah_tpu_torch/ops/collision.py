"""Inverted-index collision counting over sketch and marker matrices:
the port of ``galah_tpu/ops/collision.py`` (its numpy reference,
``_collision_pair_counts_np``).

Host numpy, as in ``galah_tpu``: sort the (hash, genome) multiset of
every valid entry; each run of equal hashes adds one collision to every
genome pair in the run. Rows hold distinct values, so a pair's count is
exactly ``|A ∩ B|``. That makes it the exact marker-containment
numerator of the skani screen, and an upper bound on the merged-bottom-k
walk's ``common``, which ``candidate_pairs_minhash`` turns into a
conservative MinHash screen. Above ``SPARSE_SCREEN_MIN_N`` genomes both
screens take this path instead of the dense O(N^2) tiles.

A hash shared by more than ``_BIG_RUN`` genomes (a near-duplicate
mega-family) is handled once per distinct genome group, with its
occurrences as the weight, so the work stays O(K m + output pairs).
"""

from __future__ import annotations

import numpy as np

from galah_tpu_torch.ops.constants import SENTINEL_U64

_BIG_RUN = 64

# genome count from which the sparse collision screens replace the
# dense passes (below it the dense pass is cheaper than sorting the
# whole hash multiset); callers read it at call time, so a test can
# move it
SPARSE_SCREEN_MIN_N = 1024

# buffered (key, weight) entries before a compaction: peak transient
# memory is O(this + distinct pairs)
_COMPACT_EVERY = 4 << 20


class _CountAccum:
    """Incrementally merge (key, weight) batches into exact per-key
    sums, compacting whenever the buffer exceeds _COMPACT_EVERY."""

    def __init__(self) -> None:
        self._keys = [np.zeros(0, np.int64)]
        self._weights = [np.zeros(0, np.int64)]
        self._buffered = 0

    def add(self, keys: np.ndarray, weights: np.ndarray) -> None:
        if keys.shape[0] == 0:
            return
        self._keys.append(keys)
        self._weights.append(weights)
        self._buffered += keys.shape[0]
        if self._buffered > _COMPACT_EVERY:
            self.compact()

    def compact(self):
        keys = np.concatenate(self._keys)
        weights = np.concatenate(self._weights)
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv, weights=weights).astype(np.int64)
        self._keys = [uniq]
        self._weights = [sums]
        self._buffered = 0
        return uniq, sums


def collision_pair_counts(mat: np.ndarray, lens: np.ndarray):
    """Exact |A ∩ B| for every colliding row pair of a sentinel-padded
    sorted uint64 matrix with per-row valid lengths: (pi, pj, counts),
    int64, pi < pj, row-major. Pairs that share nothing are absent."""
    n = mat.shape[0]
    ids = np.repeat(np.arange(n, dtype=np.int64), lens)
    hv = mat[mat != SENTINEL_U64]
    order = np.argsort(hv, kind="stable")
    hs = hv[order]
    gs = ids[order]
    empty = (np.zeros(0, np.int64),) * 3
    if hs.shape[0] == 0:
        return empty
    starts = np.flatnonzero(np.concatenate([[True], hs[1:] != hs[:-1]]))
    run_len = np.diff(np.append(starts, hs.shape[0]))

    acc = _CountAccum()
    big_mask = run_len > _BIG_RUN
    groups: "dict[bytes, tuple[np.ndarray, int]]" = {}
    for s, m in zip(starts[big_mask], run_len[big_mask]):
        group = np.unique(gs[s:s + m])
        sig = group.tobytes()
        prev = groups.get(sig)
        groups[sig] = (group, (prev[1] if prev else 0) + 1)
    for group, occurrences in groups.values():
        gi = group[:, None]
        gj = group[None, :]
        keys = (gi * n + gj)[gi < gj]
        acc.add(keys, np.full(keys.shape[0], occurrences, dtype=np.int64))
    for m in np.unique(run_len[~big_mask]):
        if m < 2:
            continue
        s = starts[(run_len == m) & ~big_mask]
        block = gs[s[:, None] + np.arange(m)]
        block.sort(axis=1)
        for a in range(int(m)):
            for b in range(a + 1, int(m)):
                i, j = block[:, a], block[:, b]
                neq = i != j  # duplicate genome paths share rows
                acc.add(i[neq] * n + j[neq],
                        np.ones(int(neq.sum()), dtype=np.int64))
    uniq, counts = acc.compact()
    if uniq.shape[0] == 0:
        return empty
    return uniq // n, uniq % n, counts


def candidate_pairs_minhash(mat: np.ndarray, lens: np.ndarray,
                            j_thr: float, sketch_size: int):
    """Conservative MinHash candidate pairs (pi, pj) by collision
    counting. |A ∩ B| bounds the merged-bottom-k walk's `common` from
    above and its `total` is at least min(sketch_size, max(|A|, |B|)),
    so a pair below j_thr times that cannot pass the exact keep-check
    ``common >= j_thr * total``; the survivors still need the exact
    walk."""
    pi, pj, counts = collision_pair_counts(mat, lens)
    t_min = np.minimum(
        sketch_size, np.maximum(lens[pi], lens[pj])).astype(np.float64)
    keep = counts.astype(np.float64) >= j_thr * t_min - 1e-9
    return pi[keep], pj[keep]
