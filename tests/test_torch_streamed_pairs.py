"""The port's streamed finch pair pass, and its clustering against
galah_tpu's overlapped dataflow.

* ``ops/pairwise.threshold_pairs_streamed`` against the port's
  ``threshold_pairs``, galah_tpu's streamed and dense passes, and a
  pair dict from the plain pair statistics;
* the port's engine on table-driven stubs (its copies of
  tests/test_overlap.py's ``TablePre``/``TableCl``) against galah_tpu's
  ``cluster`` with ``GALAH_TPU_OVERLAP=1`` (its streaming
  ``StreamTablePre``), the route galah_tpu takes by default for finch
  below the sparse crossover;
* the finch CLI with ``--threads``, streamed in several stripes,
  against galah_tpu's TSV and its own one-thread run.

Tolerance: none — pair dicts (float64 ANIs), cluster lists and TSV
bytes equal.
"""

from typing import List, Optional, Sequence

import numpy as np
import pytest
import torch

from galah_tpu.backends.base import ClusterBackend, PreclusterBackend
from galah_tpu.cli import main as jmain
from galah_tpu.cluster import cluster as jcluster
from galah_tpu.cluster.cache import PairDistanceCache as JCache
from galah_tpu.ops import collision as jcol
from galah_tpu.ops.pairwise import threshold_pairs as jpairs
from galah_tpu.ops.pairwise import threshold_pairs_streamed as jstreamed
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.cluster import engine as tengine
from galah_tpu_torch.cluster.cache import PairDistanceCache as TCache
from galah_tpu_torch.ops import sketch_stream
from galah_tpu_torch.ops.pairlist import pair_stats_pairs_plain
from galah_tpu_torch.ops.pairwise import (ani_to_jaccard, stats_to_ani_f64)
from galah_tpu_torch.ops.pairwise import threshold_pairs as tpairs
from galah_tpu_torch.ops.pairwise import (
    threshold_pairs_streamed as tstreamed)
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.timing import StageClock

from test_torch_cluster import _families

CPU = torch.device("cpu")


# -- the streamed pair pass -------------------------------------------------


def _sketches(seed, n, k, family=3):
    """(n, k) uint64 sorted, sentinel-padded sketch rows: families of
    rows that share most of their hashes, a few short rows, one empty."""
    rng = np.random.default_rng(seed)
    sentinel = np.uint64(2 ** 64 - 1)
    mat = np.full((n, k), sentinel, dtype=np.uint64)
    base = None
    for r in range(n):
        if r % family == 0:
            base = rng.integers(0, 2 ** 63, size=k, dtype=np.uint64)
        row = base.copy()
        swap = rng.random(k) < rng.choice([0.02, 0.1, 0.4])
        row[swap] = rng.integers(0, 2 ** 63, size=int(swap.sum()),
                                 dtype=np.uint64)
        size = k if rng.random() > 0.1 else int(rng.integers(0, k))
        row = np.unique(row)[:size]
        mat[r, :row.shape[0]] = row
    return mat


def _blocks(mat, block, torch_rows):
    for r0 in range(0, mat.shape[0], block):
        rows = mat[r0:r0 + block]
        yield r0, (to_biased(rows, CPU) if torch_rows else rows)


def _plain_pair_dict(mat_biased, k, min_ani, sketch_size):
    """All pairs i < j through the plain pair statistics, thresholded
    as the passes do: the reference the card's check also uses."""
    n = mat_biased.shape[0]
    ii, jj = np.triu_indices(n, 1)
    c, t = pair_stats_pairs_plain(mat_biased, torch.from_numpy(ii),
                                  torch.from_numpy(jj), sketch_size)
    c = c.numpy().astype(np.int64)
    t = t.numpy().astype(np.int64)
    keep = (c > 0) & (c.astype(np.float64)
                      >= ani_to_jaccard(min_ani, k) * t)
    return dict(zip(zip(ii[keep].tolist(), jj[keep].tolist()),
                    stats_to_ani_f64(c[keep], t[keep], k).tolist()))


@pytest.mark.parametrize("block", [16, 64])
def test_threshold_pairs_streamed_matches(block):
    n, k = 100, 256
    mat = _sketches(7, n, k)
    want = jpairs(mat, k=21, min_ani=0.9, use_pallas=False, row_tile=64,
                  col_tile=128)
    clock = StageClock(CPU)
    got = tstreamed(_blocks(mat, block, True), n, 21, 0.9, k, clock,
                    block=block)
    assert got == want
    assert got == tpairs(to_biased(mat, CPU), 21, 0.9, k)
    assert got == jstreamed(_blocks(mat, block, False), n, 21, 0.9, k,
                            mesh=None, block=block)
    assert got == _plain_pair_dict(to_biased(mat, CPU), 21, 0.9, k)
    assert len(got) > n // 3
    assert clock.counts["pairs-streamed-stripes"] == -(-n // block)


@pytest.mark.parametrize("n", [64, 300])
def test_threshold_pairs_streamed_at_full_blocks_matches_plain(n):
    """Blocks of 256 rows, as the finch run streams them: one stripe
    at 64 rows, and at 300 a last stripe of 44 rows (not a multiple of
    64) padded to 512 sentinel-padded rows."""
    k = 64
    mat = to_biased(_sketches(n, n, k, family=4), CPU)
    blocks = ((r0, mat[r0:r0 + 256]) for r0 in range(0, n, 256))
    clock = StageClock(CPU)
    got = tstreamed(blocks, n, 21, 0.9, k, clock, block=256)
    assert got == _plain_pair_dict(mat, 21, 0.9, k)
    assert len(got) >= n // 4
    assert clock.counts["pairs-streamed-stripes"] == -(-n // 256)


def test_threshold_pairs_streamed_rejects_a_short_or_unordered_stream():
    mat = _sketches(1, 40, 64)
    with pytest.raises(ValueError, match="saw 32 rows, expected 40"):
        tstreamed(_blocks(mat[:32], 16, True), 40, 21, 0.9, 64, block=16)
    shuffled = list(_blocks(mat, 16, True))[::-1]
    with pytest.raises(ValueError, match="does not follow"):
        tstreamed(iter(shuffled), 40, 21, 0.9, 64, block=16)


# -- the engine on table-driven stubs ---------------------------------------


def _stream_gen(pairs, n, block):
    by_row = {}
    for (i, j), ani in pairs.items():
        by_row.setdefault(max(i, j), {})[(i, j)] = ani

    def gen():
        r1 = 0
        while r1 < n:
            r0, r1 = r1, min(r1 + block, n)
            inc = {}
            for r in range(r0, r1):
                inc.update(by_row.get(r, {}))
            yield r1, inc

    return gen()


class TablePre:
    """The port's copy of tests/test_overlap.py's TablePre."""

    def __init__(self, pairs):
        self.pairs = pairs

    def method_name(self):
        return "stub-pre"

    def distances(self, genome_paths):
        cache = TCache()
        for (i, j), ani in self.pairs.items():
            cache.insert((i, j), ani)
        return cache


class TableCl:
    """Exact ANI from a lookup table; absent pairs are gated (None)."""

    def __init__(self, table, threshold):
        self.table = {frozenset(k): v for k, v in table.items()}
        self.ani_threshold = threshold
        self.pairs_computed: List[tuple] = []

    def method_name(self):
        return "stub-exact"

    def calculate_ani_batch(self, pairs: Sequence[tuple]
                            ) -> List[Optional[float]]:
        self.pairs_computed.extend(pairs)
        return [self.table.get(frozenset(p)) for p in pairs]


class _JStreamPre(PreclusterBackend):
    """galah_tpu's StreamTablePre: hit pairs arrive in blocks of `block`
    rows, each yield completing the prefix [0, r1)."""

    def __init__(self, pairs, n, block):
        self.pairs, self.n, self.block = pairs, n, block

    def method_name(self):
        return "stub-pre"

    def distances(self, genome_paths):
        cache = JCache()
        for (i, j), ani in self.pairs.items():
            cache.insert((i, j), ani)
        return cache

    def distances_streamed(self, genome_paths):
        return _stream_gen(self.pairs, self.n, self.block)


class _JTableCl(ClusterBackend):
    def __init__(self, table, threshold):
        self.table = {frozenset(k): v for k, v in table.items()}
        self.threshold = threshold

    def method_name(self):
        return "stub-exact"

    @property
    def ani_threshold(self):
        return self.threshold

    def calculate_ani_batch(self, pairs):
        return [self.table.get(frozenset(p)) for p in pairs]


def g(n):
    return [f"g{i}.fna" for i in range(n)]


def _family_workload(n_families, fam_size, seed, none_rate=0.05, thr=0.95):
    """tests/test_overlap.py's planted families: exact ANIs straddling
    the threshold and a few gated-None pairs."""
    rng = np.random.default_rng(seed)
    pre, table = {}, {}
    for f in range(n_families):
        base = f * fam_size
        for a in range(fam_size):
            for b in range(a + 1, fam_size):
                i, j = base + a, base + b
                pre[(i, j)] = 0.96
                if rng.random() < none_rate:
                    table[(f"g{i}.fna", f"g{j}.fna")] = None
                else:
                    table[(f"g{i}.fna", f"g{j}.fna")] = round(
                        float(rng.uniform(thr - 0.05, thr + 0.04)), 6)
    return pre, table


def _dense_workload(n, seed):
    rng = np.random.default_rng(seed)
    pre, table = {}, {}
    for i in range(n):
        for j in range(i + 1, n):
            pre[(i, j)] = 0.96
            table[(f"g{i}.fna", f"g{j}.fna")] = round(
                float(rng.uniform(0.90, 0.99)), 6)
    return pre, table


def _port(n, pre, table, **kw):
    clock = StageClock(CPU)
    got = tengine.cluster(g(n), TablePre(pre), TableCl(table, 0.95), CPU,
                          clock=clock, **kw)
    return got, clock


def _galah_tpu_overlapped(monkeypatch, n, pre, table, block=7, **kw):
    monkeypatch.setenv("GALAH_TPU_GREEDY_STRATEGY", "device")
    monkeypatch.setenv("GALAH_TPU_OVERLAP", "1")
    try:
        return jcluster(g(n), _JStreamPre(pre, n, block),
                        _JTableCl(table, 0.95), **kw)
    finally:
        monkeypatch.delenv("GALAH_TPU_GREEDY_STRATEGY")
        monkeypatch.delenv("GALAH_TPU_OVERLAP")


@pytest.mark.parametrize("workload", ["families_250x4", "dense_96"])
def test_clustering_equals_galah_tpu_overlapped(monkeypatch, workload):
    """The port's rounds give galah_tpu's overlapped clustering, its
    default route for finch below the crossover: on the 250 x 4 family
    rung (each genome's non-rep hits gated at random) and on one dense
    family."""
    if workload == "families_250x4":
        n, block = 1000, 64
        pre, table = _family_workload(250, 4, seed=11)
    else:
        n, block = 96, 5
        pre, table = _dense_workload(96, seed=3)
    got, clock = _port(n, pre, table)
    assert got == _galah_tpu_overlapped(monkeypatch, n, pre, table,
                                        block=block)
    assert sorted(x for c in got for x in c) == list(range(n))
    assert "greedy" in clock.seconds


def test_round_width_grid_equals_galah_tpu_overlapped(monkeypatch):
    """Round width changes batching only: every rep_rounds gives
    galah_tpu's overlapped clustering at every arrival granularity."""
    pre, table = _family_workload(6, 4, seed=7)
    for width in (1, 3, 7, 64):
        got, _ = _port(24, pre, table, rep_rounds=width)
        for block in (1, 3, 5, 24):
            assert got == _galah_tpu_overlapped(
                monkeypatch, 24, pre, table, block=block,
                rep_rounds=width), (block, width)


# -- the finch CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def families24(tmp_path_factory):
    """24 genomes: 8 families x 3 members, 30 kb, ~2% divergence (the
    fixture of tests/test_torch_cluster.py)."""
    return _families(tmp_path_factory.mktemp("overlap24"), 7, 8, 3, 30_000,
                     0.02)


def test_finch_cli_threads_streamed_tsv_byte_identical(
        families24, monkeypatch, tmp_path):
    """`--precluster-method finch --threads 4`, streamed in blocks of 8
    rows (three stripes): the TSV equals the one-thread run's and
    galah_tpu's."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    monkeypatch.setattr(sketch_stream, "ROW_BLOCK", 8)
    paths, _ = families24
    common = ["cluster", "-f", *paths, "--ani", "97",
              "--precluster-ani", "90", "--precluster-method", "finch"]
    want = tmp_path / "jax.tsv"
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    runs = {}
    for threads in ("4", "1"):
        out = tmp_path / f"t{threads}.tsv"
        runs[threads] = tcli.run_cluster(tcli.parse_args(
            [*common, "--threads", threads, "--device", "cpu",
             "--output-cluster-definition", str(out)]))
        assert out.read_bytes() == want.read_bytes(), threads
        counts = runs[threads].clock.counts
        assert counts["pairs-streamed-stripes"] == 3
        assert counts["genomes-read"] >= len(paths)
        assert runs[threads].clock.work_seconds["read"] > 0
    assert tcli.parse_args(common).threads == 1
    assert tcli.parse_args([*common, "-t", "3"]).threads == 3
