"""Port parity of the finch all-pairs pass: pairlist stats, the
collision screen, the dense and sparse ``threshold_pairs`` and the
skani screen above the crossover, against galah_tpu on the same
numpy-seeded inputs.

Tolerance: none. (common, total) are int32 and collision counts int64,
equal element for element; pair dicts map to float64 ANIs and must be
equal as dicts. The pairlist kernel itself needs the card and is held
against ``pair_stats_pairs_plain`` by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops import collision as jcol
from galah_tpu.ops import pairwise as jpw
from galah_tpu.ops import sparse_device as jsd
from galah_tpu.ops.constants import SENTINEL
from galah_tpu.ops.pallas_pairlist import pair_stats_pairs_pallas
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import collision as tcol
from galah_tpu_torch.ops import pairlist as tpl
from galah_tpu_torch.ops import pairwise as tpw
from galah_tpu_torch.ops import sparse_device as tsd
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.timing import StageClock

CPU = torch.device("cpu")
SENT = np.uint64(SENTINEL)


def _family_sketches(n, width, n_fam, seed, mutations):
    """Family-structured sorted sketch rows (galah_tpu's
    tests/test_sparse_device.py recipe) with a ragged row, an empty
    row, two identical rows and a row disjoint from every other."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 62, size=(n_fam, width), dtype=np.uint64)
    mat = np.empty((n, width), dtype=np.uint64)
    for i in range(n):
        row = base[i % n_fam].copy()
        n_mut = int(rng.integers(0, mutations))
        idx = rng.choice(width, size=n_mut, replace=False)
        row[idx] = rng.integers(0, 1 << 62, size=n_mut, dtype=np.uint64)
        mat[i] = np.sort(row)
    mat[3, width // 5:] = SENT          # ragged
    mat[9] = SENT                       # empty
    mat[11] = mat[12]                   # identical
    mat[13] = np.sort(rng.integers(1 << 62, 1 << 63, size=width,
                                   dtype=np.uint64))  # disjoint
    return mat


def _pairs(rng, n, b):
    pi = rng.integers(0, n, size=b)
    pj = rng.integers(0, n, size=b)
    pi[:4], pj[:4] = [9, 11, 3, 13], [9, 12, 4, 0]
    return pi, pj


@pytest.mark.parametrize("width,n_pairs", [(100, 7), (1000, 300)])
def test_pair_stats_plain_matches_xla(width, n_pairs):
    """sketch_size K and K/3; empty, identical, disjoint and ragged
    rows; an index repeated within the list."""
    mat = _family_sketches(60, width, 12, width, width // 3)
    pi, pj = _pairs(np.random.default_rng(n_pairs), 60, n_pairs)
    tmat = to_biased(mat)
    for sketch_size in (width, width // 3):
        want_c, want_t = jsd._batch_pair_stats(
            jnp.asarray(mat), jnp.asarray(pi.astype(np.int32)),
            jnp.asarray(pj.astype(np.int32)), sketch_size,
            use_pallas=False)
        before = LAUNCHES["pairlist"]
        got_c, got_t = tpl.pair_stats_pairs(
            tmat, torch.from_numpy(pi), torch.from_numpy(pj), sketch_size)
        assert LAUNCHES["pairlist"] == before  # no kernel on the CPU
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_pair_stats_plain_matches_pallas_interpret():
    """B = 8 pairs at K = 128 against the Pallas pairlist kernel in
    interpret mode."""
    mat = _family_sketches(20, 128, 5, 7, 40)
    pi, pj = _pairs(np.random.default_rng(8), 20, 8)
    c, t = pair_stats_pairs_pallas(jnp.asarray(mat[pi]),
                                   jnp.asarray(mat[pj]), 128,
                                   interpret=True)
    gc, gt = tpl.pair_stats_pairs(to_biased(mat), torch.from_numpy(pi),
                                  torch.from_numpy(pj), 128)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(t))


def test_collision_counts_and_candidates_match_numpy_reference():
    """A near-duplicate mega-family (runs longer than _BIG_RUN), random
    small collisions and a duplicated row."""
    rng = np.random.default_rng(61)
    n, width = 200, 40
    mat = np.full((n, width), SENT, dtype=np.uint64)
    lens = np.zeros(n, dtype=np.int64)
    shared = np.sort(rng.choice(1 << 30, size=width,
                                replace=False)).astype(np.uint64)
    for i in range(n):
        if i < 90:
            row = shared.copy()
            row[rng.integers(0, width)] = rng.integers(1 << 40, 1 << 41,
                                                       dtype=np.uint64)
        else:
            row = rng.choice(1 << 12, size=width, replace=False).astype(
                np.uint64)
        row = np.unique(row)
        mat[i, :row.shape[0]] = row
        lens[i] = row.shape[0]
    mat[150] = mat[151]
    lens[150] = lens[151]
    got = tcol.collision_pair_counts(mat, lens)
    want = jcol._collision_pair_counts_np(mat, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for thr in (0.05, 0.5):
        for g, w in zip(
                tcol.candidate_pairs_minhash(mat, lens, thr, width),
                jcol.candidate_pairs_minhash(mat, lens, thr, width)):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def sketches():
    return _family_sketches(300, 64, 40, 17, 30)


@pytest.mark.parametrize("min_ani", [0.90, 0.95, 0.99])
def test_threshold_pairs_dense_and_sparse_match_galah_tpu(
        sketches, monkeypatch, min_ani):
    """Port dense pass, port sparse pass (crossover at 0) and galah_tpu's
    dense row-block pass and screened sparse pass give one pair dict."""
    mat = sketches
    want = jpw.threshold_pairs(mat, k=21, min_ani=min_ani,
                               use_pallas=False, row_tile=64, col_tile=128)
    assert want == jsd.threshold_pairs_sparse(mat, k=21, min_ani=min_ani)
    assert len(want) > 0
    dense = tpw.threshold_pairs(to_biased(mat), 21, min_ani)
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    clock = StageClock(CPU)
    before = LAUNCHES["tile_stats"]
    sparse = tpw.threshold_pairs(to_biased(mat), 21, min_ani, clock=clock)
    assert LAUNCHES["tile_stats"] == before
    assert dense == want
    assert sparse == want
    assert clock.counts["screen-kept-pairs"] == len(want)
    assert clock.counts["screen-candidates"] >= len(want)
    assert set(clock.seconds) == {"collision-screen", "pair-stats"}


def test_sparse_pass_batches_pairs(sketches, monkeypatch):
    """More candidates than one launch's batch: the same dict."""
    whole = tsd.threshold_pairs_sparse(to_biased(sketches), 21, 0.9)
    monkeypatch.setattr(tsd, "PAIR_BATCH", 7)
    assert tsd.threshold_pairs_sparse(to_biased(sketches), 21, 0.9) == whole
    assert len(whole) > 7


def test_threshold_pairs_sketch_size_below_width(sketches):
    """sketch_size < K caps `total` on both sides."""
    want = jpw.threshold_pairs(sketches, k=21, min_ani=0.9, sketch_size=40,
                               use_pallas=False, row_tile=64, col_tile=128)
    got = tpw.threshold_pairs(to_biased(sketches), 21, 0.9, sketch_size=40)
    assert got == want


def test_screen_pairs_above_crossover_matches_galah_tpu(monkeypatch):
    """The skani marker screen takes the exact host collision screen
    from the crossover up: the pair list of galah_tpu's screen_pairs
    (its collision path) and of the port's dense kernel screen."""
    rng = np.random.default_rng(41)
    n, m, n_fam = 150, 40, 15
    base = rng.integers(0, 1 << 62, size=(n_fam, m), dtype=np.uint64)
    mat = np.empty((n, m), dtype=np.uint64)
    for i in range(n):
        row = base[i % n_fam].copy()
        n_mut = int(rng.integers(0, 12))
        idx = rng.choice(m, size=n_mut, replace=False)
        row[idx] = rng.integers(0, 1 << 62, size=n_mut, dtype=np.uint64)
        mat[i] = np.sort(row)
    mat[5, 20:] = SENT
    counts = (mat != SENT).sum(axis=1)
    dense = tpw.screen_pairs(to_biased(mat), counts, 0.8)
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    before = LAUNCHES["tile_stats"]
    sparse = tpw.screen_pairs(to_biased(mat), counts, 0.8)
    assert LAUNCHES["tile_stats"] == before
    assert sparse == jpw.screen_pairs(mat, counts, 0.8)
    assert sorted(sparse) == sorted(dense)
    assert len(sparse) > 0


def test_pair_stats_rejects_bad_inputs():
    mat = torch.zeros(4, 8, dtype=torch.int64)
    idx = torch.tensor([0, 1])
    with pytest.raises(ValueError):  # index out of range
        tpl.pair_stats_pairs(mat, idx, torch.tensor([0, 4]), 8)
    with pytest.raises(ValueError):  # lengths differ
        tpl.pair_stats_pairs(mat, idx, torch.tensor([0]), 8)
    with pytest.raises(ValueError):  # int32 indices
        tpl.pair_stats_pairs(mat, idx.to(torch.int32), idx, 8)
    with pytest.raises(ValueError):  # wider than the kernel stages
        tpl.pair_stats_pairs(torch.zeros(2, tpl.MAX_K + 1,
                                         dtype=torch.int64), idx, idx, 8)
