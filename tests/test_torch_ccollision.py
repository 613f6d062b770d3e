"""The port's C collision counter (galah_tpu_torch/csrc/collision.c via
ops/_ccollision.py) against galah_tpu's compiled counter and both
packages' numpy versions.

Tolerance: none — (pi, pj, counts) int64 triples equal, in the same
order, for planted families, a mega-cluster past _BIG_RUN (the group
dedup), ragged and empty rows, no collisions and seeded fuzz. Also: the
auto route takes C, a failed build raises (nothing drops to numpy), and
GALAH_TPU_NO_CCOLLISION=1 takes numpy.
"""

import os

import numpy as np
import pytest

from galah_tpu.ops import collision as jcol
from galah_tpu.ops._ccollision import collision_pair_counts_c as jcount_c
from galah_tpu_torch.io import _cingest
from galah_tpu_torch.ops import _ccollision
from galah_tpu_torch.ops import collision as tcol
from galah_tpu_torch.ops.constants import SENTINEL_U64


def _assert_identical(mat, lens):
    got = _ccollision.collision_pair_counts_c(mat, lens, tcol._BIG_RUN)
    for want in (jcount_c(mat, lens, jcol._BIG_RUN),
                 jcol._collision_pair_counts_np(mat, lens),
                 tcol._collision_pair_counts_np(mat, lens)):
        for g, w, name in zip(got, want, ("pi", "pj", "counts")):
            assert g.dtype == np.int64, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _family_matrix(rng, n, k, fam):
    base = rng.integers(0, 1 << 62, size=(fam, k), dtype=np.uint64)
    mat = np.empty((n, k), np.uint64)
    for i in range(n):
        row = base[i % fam].copy()
        n_mut = int(rng.integers(0, max(1, k // 8)))
        idx = rng.choice(k, size=n_mut, replace=False)
        row[idx] = rng.integers(0, 1 << 62, size=n_mut, dtype=np.uint64)
        row.sort()
        mat[i] = row
    return mat


def _mega_cluster(rng, k=48):
    shared = np.sort(rng.integers(0, 1 << 62, size=k, dtype=np.uint64))
    n = tcol._BIG_RUN * 2 + 7  # every shared hash makes a run past it
    mat = np.tile(shared, (n, 1))
    # a second, partly overlapping mega-group: distinct group signatures
    mat[n // 2:, : k // 2] = np.sort(
        rng.integers(0, 1 << 62, size=k // 2, dtype=np.uint64))
    mat.sort(axis=1)
    return mat, np.full(n, k, np.int64)


def _ragged(rng, n=50, k=32):
    mat = np.full((n, k), SENTINEL_U64, dtype=np.uint64)
    lens = np.zeros(n, np.int64)
    pool = rng.integers(0, 1 << 16, size=64, dtype=np.uint64)  # dense
    for i in range(n):
        # every seventh row empty, the rest of any length up to k
        m = 0 if i % 7 == 3 else int(rng.integers(0, k + 1))
        lens[i] = m
        if m:
            mat[i, :m] = np.sort(rng.choice(pool, size=m, replace=False))
    return mat, lens


def test_planted_families_identical():
    rng = np.random.default_rng(11)
    pi, _, _ = _assert_identical(_family_matrix(rng, 64, 96, 16),
                                 np.full(64, 96, np.int64))
    assert pi.shape[0] > 0


def test_mega_cluster_big_run_dedup_identical():
    mat, lens = _mega_cluster(np.random.default_rng(12))
    _, _, counts = _assert_identical(mat, lens)
    n = mat.shape[0]
    assert counts.shape[0] == n * (n - 1) // 2


def test_ragged_and_empty_rows_identical():
    mat, lens = _ragged(np.random.default_rng(13))
    assert (lens == 0).any()
    _assert_identical(mat, lens)


def test_all_empty_and_no_collisions():
    n, k = 8, 16
    empty = np.full((n, k), SENTINEL_U64, dtype=np.uint64)
    got = _assert_identical(empty, np.zeros(n, np.int64))
    assert all(a.shape == (0,) for a in got)
    rng = np.random.default_rng(14)
    mat = np.sort(rng.integers(0, 1 << 62, size=(n, k), dtype=np.uint64),
                  axis=1)
    got = _assert_identical(mat, np.full(n, k, np.int64))
    assert all(a.shape == (0,) for a in got)
    got = _assert_identical(np.zeros((0, k), np.uint64),
                            np.zeros(0, np.int64))
    assert all(a.shape == (0,) for a in got)


@pytest.mark.parametrize("trial", range(12))
def test_fuzz_identical_across_structures(trial):
    rng = np.random.default_rng(1500 + trial)
    n = int(rng.integers(2, 120))
    k = int(rng.integers(1, 64))
    fam = int(rng.integers(1, max(2, n // 2)))
    if trial % 3 == 0:
        # a collision-dense small universe
        mat = np.empty((n, k), np.uint64)
        for i in range(n):
            mat[i] = np.sort(rng.choice(np.arange(4 * k, dtype=np.uint64),
                                        size=k, replace=False))
    else:
        mat = _family_matrix(rng, n, k, fam)
    lens = rng.integers(0, k + 1, size=n).astype(np.int64)
    mm = np.full((n, k), SENTINEL_U64, dtype=np.uint64)
    for i in range(n):
        mm[i, : lens[i]] = mat[i, : lens[i]]
    _assert_identical(mm, lens)


def test_auto_route_uses_c(monkeypatch):
    """collision_pair_counts goes to the C counter on every device, and
    its triples equal galah_tpu's auto route's."""
    monkeypatch.delenv("GALAH_TPU_NO_CCOLLISION", raising=False)
    mat = _family_matrix(np.random.default_rng(16), 32, 40, 8)
    lens = np.full(32, 40, np.int64)
    calls = []
    real = _ccollision.collision_pair_counts_c
    monkeypatch.setattr(_ccollision, "collision_pair_counts_c",
                        lambda *a: calls.append(a) or real(*a))
    got = tcol.collision_pair_counts(mat, lens)
    assert len(calls) == 1
    for g, w in zip(got, jcol.collision_pair_counts(mat, lens)):
        np.testing.assert_array_equal(g, w)
    assert _ccollision._LIB is not None


def test_no_ccollision_flag_takes_numpy(monkeypatch):
    """GALAH_TPU_NO_CCOLLISION=1 asks for the numpy version (galah_tpu's
    switch, read by both packages)."""
    monkeypatch.setenv("GALAH_TPU_NO_CCOLLISION", "1")
    mat, lens = _ragged(np.random.default_rng(17))
    monkeypatch.setattr(
        _ccollision, "collision_pair_counts_c",
        lambda *a: pytest.fail("the C counter ran under the flag"))
    got = tcol.collision_pair_counts(mat, lens)
    for g, w in zip(got, jcol.collision_pair_counts(mat, lens)):
        np.testing.assert_array_equal(g, w)


def test_failed_build_raises_and_never_counts_with_numpy(tmp_path,
                                                         monkeypatch):
    """CC=false: the build raises with the compiler's status, through
    the auto route too, instead of counting with numpy."""
    monkeypatch.delenv("GALAH_TPU_NO_CCOLLISION", raising=False)
    monkeypatch.setattr(_ccollision, "_LIB", None)
    monkeypatch.setattr(_cingest, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CC", "false")
    monkeypatch.setattr(
        tcol, "_collision_pair_counts_np",
        lambda *a: pytest.fail("numpy counted after a failed build"))
    with pytest.raises(RuntimeError,
                       match="C collision counter build failed"):
        _ccollision.load()
    mat = _family_matrix(np.random.default_rng(18), 8, 16, 2)
    with pytest.raises(RuntimeError,
                       match="C collision counter build failed"):
        tcol.collision_pair_counts(mat, np.full(8, 16, np.int64))
    assert not list((tmp_path / "build").glob("libcollision-*.so"))


def test_library_named_by_source_hash(tmp_path, monkeypatch):
    """The counter builds into the build directory under a hash of its
    source and flags, once; the ingest parser's name is untouched."""
    lib = _cingest.build(_ccollision.SOURCE, str(tmp_path),
                         stem="collision", what="C collision counter")
    assert lib == _cingest.build(_ccollision.SOURCE, str(tmp_path),
                                 stem="collision",
                                 what="C collision counter")
    assert [p.name for p in tmp_path.glob("lib*.so")] == [
        os.path.basename(lib)]
    assert os.path.basename(lib).startswith("libcollision-")
