"""Port parity: greedy selection and the round-based engine.

``window_select`` / ``membership_argmax`` are held against galah_tpu's
jitted twins (NaN = no edge, ties to the lowest rep), and the port's
engine against galah_tpu's ``cluster`` and against its own host-order
scan, on table-driven backends. Tolerance: none — rep flags, argmax
columns and cluster lists must be equal.
"""

from typing import List, Optional, Sequence

import numpy as np
import pytest
import torch

from galah_tpu.backends.base import ClusterBackend, PreclusterBackend
from galah_tpu.cluster import cluster as jcluster
from galah_tpu.cluster.cache import PairDistanceCache as JCache
from galah_tpu.ops import greedy_select as jgs
from galah_tpu_torch.cluster import engine as tengine
from galah_tpu_torch.cluster.cache import PairDistanceCache as TCache
from galah_tpu_torch.cluster.partition import partition_preclusters
from galah_tpu_torch.ops import greedy_select as tgs

CPU = torch.device("cpu")
NAN = float("nan")


def _random_window(rng, w, nan_rate=0.5):
    ani = np.full((w, w), np.nan)
    iu = np.triu_indices(w, 1)
    vals = np.round(rng.uniform(0.9, 0.99, size=iu[0].size), 2)
    vals[rng.random(iu[0].size) < nan_rate] = np.nan
    ani[iu] = vals
    return ani


@pytest.mark.parametrize("seed", range(4))
def test_window_select_matches(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 40))
    ani = _random_window(rng, w)
    ext = rng.random(w) < 0.2
    want_rep, want_conv = jgs.window_select(ani, ext, 0.95)
    got_rep, got_conv = tgs.window_select(ani, ext, 0.95, CPU)
    np.testing.assert_array_equal(got_rep, want_rep)
    assert got_conv == want_conv


def test_window_select_deep_chain_does_not_converge():
    """A rep chain deeper than FOLD_ITERS leaves the fold undecided,
    as in galah_tpu (the engine then finishes on the host scan)."""
    w = 80
    ani = np.full((w, w), np.nan)
    for i in range(w - 1):
        ani[i, i + 1] = 0.99
    ext = np.zeros(w, dtype=bool)
    got_rep, got_conv = tgs.window_select(ani, ext, 0.95, CPU)
    want_rep, want_conv = jgs.window_select(ani, ext, 0.95)
    assert not got_conv and not want_conv
    np.testing.assert_array_equal(got_rep, want_rep)


def test_membership_argmax_nans_and_ties():
    ani = np.array([
        [0.97, 0.97, 0.90],   # tie -> lowest rep index
        [NAN, 0.91, 0.96],    # gated against rep 0
        [NAN, NAN, NAN],      # no candidate at all
        [0.95, NAN, 0.95],    # tie across a gap
    ])
    got_best, got_has = tgs.membership_argmax(ani, CPU)
    want_best, want_has = jgs.membership_argmax(ani)
    np.testing.assert_array_equal(got_has, want_has)
    np.testing.assert_array_equal(got_best[got_has], want_best[want_has])
    assert got_best[[0, 1, 3]].tolist() == [0, 2, 0]


class TablePre(PreclusterBackend):
    def __init__(self, pairs, cache_cls):
        self.pairs, self.cache_cls = pairs, cache_cls

    def method_name(self):
        return "stub-pre"

    def distances(self, genome_paths):
        cache = self.cache_cls()
        for (i, j), ani in self.pairs.items():
            cache.insert((i, j), ani)
        return cache


class TableCl(ClusterBackend):
    """Exact ANI from a lookup table; absent pairs are gated (None)."""

    def __init__(self, table, threshold):
        self.table = {frozenset(k): v for k, v in table.items()}
        self._threshold = threshold

    def method_name(self):
        return "stub-exact"

    @property
    def ani_threshold(self):
        return self._threshold

    def calculate_ani_batch(
            self, pairs: Sequence[tuple]) -> List[Optional[float]]:
        return [self.table.get(frozenset(p)) for p in pairs]


def _workload(seed, n, density, none_rate=0.1):
    rng = np.random.default_rng(seed)
    pre, table = {}, {}
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < density:
                pre[(i, j)] = 0.96
                table[(f"g{i}", f"g{j}")] = (
                    None if rng.random() < none_rate
                    else round(float(rng.uniform(0.88, 0.99)), 6))
    return [f"g{i}" for i in range(n)], pre, table


def _both(genomes, pre, table, rep_rounds=None):
    want = jcluster(genomes, TablePre(pre, JCache), TableCl(table, 0.95),
                    rep_rounds=rep_rounds)
    got = tengine.cluster(genomes, TablePre(pre, TCache),
                          TableCl(table, 0.95), CPU, rep_rounds=rep_rounds)
    return got, want


@pytest.mark.parametrize("seed,n,density", [
    (100, 30, 0.35), (101, 12, 0.8), (102, 60, 0.1),
    # one dense precluster of 40: a rep chain deeper than the
    # sub-round budget, finished on the host-order scan
    (103, 40, 1.0),
])
def test_engine_matches_galah_tpu(seed, n, density):
    genomes, pre, table = _workload(seed, n, density)
    got, want = _both(genomes, pre, table)
    assert got == want


def test_conflict_window_matches():
    """Every pair below the threshold: every genome is its own rep, a
    chain of depth 40 > MAX_SUBROUNDS."""
    n = 40
    pre = {(i, j): 0.96 for i in range(n) for j in range(i + 1, n)}
    table = {(f"g{i}", f"g{j}"): 0.90 for i, j in pre}
    got, want = _both([f"g{i}" for i in range(n)], pre, table)
    assert got == want and len(got) == n


@pytest.mark.parametrize("width", [1, 3, 7])
def test_round_width_invariance(width):
    genomes, pre, table = _workload(7, 24, 0.4)
    got, want = _both(genomes, pre, table, rep_rounds=width)
    assert got == want


@pytest.mark.parametrize("seed", [200, 201])
def test_rounds_match_host_order_scan(seed):
    """Per precluster, the port's host-order scan gives the clusters
    the round strategy gives."""
    genomes, pre, table = _workload(seed, 36, 0.3)
    cl = TableCl(table, 0.95)
    got = tengine.cluster(genomes, TablePre(pre, TCache), cl, CPU)
    cache = TCache()
    for k, v in pre.items():
        cache.insert(k, v)
    host = []
    for members in partition_preclusters(len(genomes), cache.keys()):
        local = cache.transform_ids(members)
        names = [genomes[g] for g in members]
        reps, ani_cache = tengine.find_representatives(cl, local, names,
                                                       False)
        clusters = tengine.find_memberships(cl, reps, local, names,
                                            ani_cache, False)
        host.extend([[members[i] for i in c] for c in clusters])
    assert got == host
