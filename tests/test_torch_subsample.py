"""``--ani-subsample c`` (FracMinHash-compressed exact ANI) on the port
against galah_tpu on the same numpy-seeded genomes: profiles, directed
ANI, cluster TSVs, cache entries and checkpoint fingerprints, at
c in {2, 16, 125, 1000} and both hashes.

The port masks each profile group's positional hashes to the sentinel
at and above 2^64 / c (``ops/fragment_ani.subsample_mask``) and keeps
the window layout, where galah_tpu compacts each window's surviving
hashes; the per-window (matched, total) integers, and so the float64
ANIs, are the same.

Tolerance: none — hash arrays equal, float64 ANIs equal bit for bit,
TSV and fingerprint bytes equal.
"""

import logging
import os

import numpy as np
import pytest
import torch

from galah_tpu.backends import ProfileStore as JStore
from galah_tpu.cli import main as jmain
from galah_tpu.io import diskcache as jdiskcache
from galah_tpu.io import read_genome as jread
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.backends import ProfileStore as TStore
from galah_tpu_torch.io import diskcache as tdiskcache
from galah_tpu_torch.io import group as tgroup
from galah_tpu_torch.io.fasta import read_genome as tread
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker (as
# tests/test_torch_hll.py sets for the whole run)
torch.set_num_threads(1)

CPU = torch.device("cpu")
CS = [2, 16, 125, 1000]
ALGOS = ["murmur3", "tpufast"]
ABISKO = ["73.20120800_S1X.13.fna", "73.20120600_S2D.19.fna",
          "73.20120700_S3X.12.fna", "73.20110800_S2D.13.fna"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 families x 3 members, 40 kb, ~1% divergence; the first genome
    gets N runs and contig breaks."""
    root = tmp_path_factory.mktemp("sub")
    paths, labels = _families(root, 31, 3, 3, 40_000, 0.01)
    with open(paths[0]) as fh:
        seq = "".join(ln.strip() for ln in fh if not ln.startswith(">"))
    seq = seq[:5000] + "N" * 40 + seq[5040:20000] + "NNNN" + seq[20004:]
    with open(paths[0], "w") as fh:
        fh.write(f">a\n{seq[:12000]}\n>b\n{seq[12000:12010]}\n"
                 f">c\n{seq[12010:]}\n")
    return paths, labels


@pytest.fixture
def small_groups(monkeypatch):
    """Profile groups of a few genomes, so a batch spans several."""
    monkeypatch.setattr(tfa, "PROFILE_BATCH_BUDGET", 90_000)
    monkeypatch.setattr(tgroup, "ALONE_ABOVE", 45_000)


@pytest.fixture
def root_logger():
    """main() replaces the root handlers (as galah-tpu's does); put
    them and the level back after the test."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture
def no_dense_mesh(monkeypatch):
    """galah_tpu's exact collision screen, off conftest's 8-device mesh
    (the same pair list)."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)


def _np_profile(p):
    return {name: from_biased(getattr(p, name))
            for name in ("flat_hashes", "ref_set", "markers")}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("c", CS)
def test_profiles_match_galah_tpu(corpus, small_groups, c, algo):
    """Masked flat hashes, distinct sets, markers, the sorted queries'
    hashes and each window's valid count equal galah_tpu's per-genome
    and batched builds, with the port's batch cut into groups."""
    paths, _ = corpus
    jg = [jread(p) for p in paths]
    want = [jfa.build_profile(g, 15, 3000, subsample_c=c,
                              hash_algorithm=algo) for g in jg]
    want_b = jfa.build_profiles_batch(jg, 15, 3000, subsample_c=c,
                                      hash_algorithm=algo)
    got = tfa.build_profiles_batch([tread(p) for p in paths], 15, 3000,
                                   CPU, subsample_c=c, hash_algorithm=algo)
    one = tfa.build_profile(tread(paths[0]), 15, 3000, CPU, subsample_c=c,
                            hash_algorithm=algo)
    assert _np_profile(one).keys() == _np_profile(got[0]).keys()
    for name, arr in _np_profile(one).items():
        np.testing.assert_array_equal(arr, _np_profile(got[0])[name])
    for t, j, jb in zip(got, want, want_b):
        assert t.subsample_c == j.subsample_c == c
        for name, arr in _np_profile(t).items():
            np.testing.assert_array_equal(arr, getattr(j, name))
            np.testing.assert_array_equal(arr, getattr(jb, name))
        jqh, _, jtot = j.sorted_query()
        tqh, _, ttot = t.sorted_query()
        np.testing.assert_array_equal(from_biased(tqh), jqh)
        np.testing.assert_array_equal(ttot.numpy(), jtot)
    # the markers are the unmasked profile's: c <= 1000 keeps them all
    dense = tfa.build_profiles_batch([tread(paths[1])], 15, 3000, CPU,
                                     hash_algorithm=algo)[0]
    assert torch.equal(dense.markers, got[1].markers)
    # the subsampled distinct set is about c-fold smaller
    ratio = dense.ref_set.shape[0] / max(got[1].ref_set.shape[0], 1)
    assert 0.5 * c < ratio < 2.0 * c


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("c", CS)
def test_directed_ani_matches_galah_tpu(corpus, c, algo):
    """directed_ani_arrays equals galah_tpu's directed_ani_batch bit for
    bit (float64 ANI and aligned fraction, integer fragment counts) on
    every ordered pair of related and unrelated genomes."""
    paths, _ = corpus
    want = [jfa.build_profile(jread(p), 15, 3000, subsample_c=c,
                              hash_algorithm=algo) for p in paths]
    got = tfa.build_profiles_batch([tread(p) for p in paths], 15, 3000,
                                   CPU, subsample_c=c, hash_algorithm=algo)
    idx = [(i, j) for i in range(len(paths)) for j in range(len(paths))
           if i != j]
    jd = jfa.directed_ani_batch([(want[i], want[j]) for i, j in idx])
    ani, af, fm, ft = tfa.directed_ani_arrays(
        [(got[i], got[j]) for i, j in idx])
    assert ani.tolist() == [d.ani for d in jd]
    assert af.tolist() == [d.aligned_fraction for d in jd]
    assert fm.tolist() == [d.frags_matching for d in jd]
    assert ft.tolist() == [d.frags_total for d in jd]
    assert sum(d.frags_matching > 0 for d in jd) >= 6  # related pairs
    assert LAUNCHES["window_hits"] == 0  # the plain version on the CPU


@pytest.mark.parametrize("route", ["skani", "finch", "abisko4"])
def test_subsample_tsv_matches_galah_tpu(request, corpus, no_dense_mesh,
                                         root_logger, tmp_path, route):
    """`cluster --ani-subsample 16` writes galah_tpu's TSV byte for byte:
    the skani and finch routes on the synthetic corpus, and finch at 99%
    on the reference's 4 MAGs (tests/test_ani_accuracy.py's golden
    composition, [[0, 1, 3], [2]])."""
    if route == "abisko4":
        ref = request.getfixturevalue("ref_data") / "abisko4"
        paths = [str(ref / n) for n in ABISKO]
        flags = ["--precluster-method", "finch", "--ani", "99"]
    else:
        paths, _ = corpus
        flags = ["--precluster-method", route, "--ani", "97",
                 "--precluster-ani", "90"]
    common = ["cluster", "-f", *paths, *flags, "--cluster-method", "skani",
              "--ani-subsample", "16", "-q"]
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    assert tcli.main([*common, "--device", "cpu",
                      "--output-cluster-definition", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    reps = {ln.split("\t")[0] for ln in got.read_text().splitlines()}
    if route == "abisko4":
        assert len(reps) == 2
    else:
        assert len(reps) == 3  # the planted families


@pytest.mark.parametrize("writer", ["galah_tpu", "port"])
def test_cache_entries_interchangeable_at_c16(corpus, tmp_path, writer):
    """Profile entries written at c = 16 by either package carry the
    same names and arrays, and the other package loads them without
    profiling anything."""
    paths, _ = corpus
    cache = tmp_path / "cache"
    clock = StageClock(CPU)
    if writer == "galah_tpu":
        JStore(k=15, subsample_c=16,
               cache=jdiskcache.CacheDir(str(cache))).get_many(paths)
        store = TStore(CPU, clock=clock, subsample_c=16,
                       cache=tdiskcache.CacheDir(str(cache), clock))
        got = store.get_many(paths)
        assert clock.counts["cache-hits"] == len(paths)
        assert clock.counts.get("profile-groups", 0) == 0
        want = JStore(k=15, subsample_c=16).get_many(paths)
    else:
        got = TStore(CPU, clock=clock, subsample_c=16,
                     cache=tdiskcache.CacheDir(str(cache),
                                               clock)).get_many(paths)
        jc = jdiskcache.CacheDir(str(cache))
        want = JStore(k=15, subsample_c=16, cache=jc).get_many(paths)
        assert jc.hits == len(paths) and jc.misses == 0
    assert all(n.startswith("profile") for n in os.listdir(cache))
    assert len(os.listdir(cache)) == len(paths)
    for t, j in zip(got, want):
        assert t.subsample_c == j.subsample_c == 16
        for name, arr in _np_profile(t).items():
            np.testing.assert_array_equal(arr, getattr(j, name))
    # a c = 1 store finds none of them: the entry names key c
    clock1 = StageClock(CPU)
    TStore(CPU, clock=clock1, cache=tdiskcache.CacheDir(
        str(cache), clock1)).get_many(paths[:1])
    assert clock1.counts.get("cache-hits", 0) == 0


def test_checkpoint_fingerprint_at_c16(corpus, no_dense_mesh, root_logger,
                                       tmp_path):
    """A `--checkpoint-dir` run at --ani-subsample 16 writes galah_tpu's
    fingerprint file byte for byte (subsample_c in its backend params),
    and a c = 1 run's fingerprint differs."""
    paths, _ = corpus
    common = ["cluster", "-f", *paths, "-q", "--ani-subsample", "16"]
    assert jmain([*common, "--checkpoint-dir", str(tmp_path / "j")]) == 0
    assert tcli.main([*common, "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "t")]) == 0
    fp = "fingerprint.json"
    want = (tmp_path / "j" / fp).read_bytes()
    assert (tmp_path / "t" / fp).read_bytes() == want
    assert b'"subsample_c": 16' in want
    assert tcli.main([*common[:-2], "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "t1")]) == 0
    assert (tmp_path / "t1" / fp).read_bytes() != want


@pytest.mark.parametrize("c", [0, 1001])
def test_subsample_out_of_range_is_refused(corpus, root_logger, tmp_path,
                                          capsys, c):
    """c = 0 and c = 1001 raise galah_tpu's message before any device
    work, in the profile build, the store and the CLI (exit 1, the flag
    named)."""
    paths, _ = corpus
    with pytest.raises(ValueError) as je:
        jfa.build_profile(jread(paths[0]), 15, 3000, subsample_c=c)
    for build in (lambda: tfa.build_profile(tread(paths[0]), 15, 3000, CPU,
                                            subsample_c=c),
                  lambda: TStore(CPU, subsample_c=c)):
        with pytest.raises(ValueError) as te:
            build()
        assert str(te.value) == str(je.value)
    out = str(tmp_path / "c.tsv")
    assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                      "--ani-subsample", str(c),
                      "--output-cluster-definition", out]) == 1
    assert f"--ani-subsample must be in [1, 1000], got {c}" in \
        capsys.readouterr().err
    assert not os.path.exists(out)
