"""``cluster-validate`` and ``dist`` against galah_tpu on the same
numpy-seeded genomes.

Tolerance: none — violation counts and exit codes equal; dist TSVs
byte-identical (ANIs printed %.6f from the same float64 values), on
both sides of the sparse crossover in both packages.
"""

import logging

import pytest
import torch

from galah_tpu.backends import FastANIEquivalentClusterer as JFastANI
from galah_tpu.backends import ProfileStore as JStore
from galah_tpu.cli import main as jmain
from galah_tpu.ops import _cpairstats
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import pairwise as jpairwise
from galah_tpu.validate import validate_clusters as jvalidate
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import collision as tcol

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker (as
# tests/test_torch_hll.py sets for the whole run)
torch.set_num_threads(1)


@pytest.fixture
def root_logger():
    """main() replaces the root handlers (as galah-tpu's does); put
    them and the level back after the test."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 families x 3 members, 25 kb, ~0.3% divergence from the family
    base (members ~99.5% ANI to each other, above the 99% default)."""
    return _families(tmp_path_factory.mktemp("vd"), 11, 4, 3, 25_000,
                     0.003)


def _tsv(path, clusters):
    with open(path, "w") as fh:
        for c in clusters:
            for m in c:
                fh.write(f"{c[0]}\t{m}\n")
    return str(path)


def _cluster_files(tmp_path, paths, labels):
    fams = [[p for p, f in zip(paths, labels) if f == fam]
            for fam in sorted(set(labels))]
    split = [fams[0][:2], fams[0][2:], *fams[1:]]
    foreign = [fams[0] + [fams[1][2]], fams[1][:2], *fams[2:]]
    return {"clean": (_tsv(tmp_path / "clean.tsv", fams), 0),
            "split": (_tsv(tmp_path / "split.tsv", split), 1),
            "foreign": (_tsv(tmp_path / "foreign.tsv", foreign), 1)}


@pytest.mark.parametrize("case", ["clean", "split", "foreign"])
@pytest.mark.parametrize("flags,ani,af", [([], 0.99, 0.5),
                                          (["--ani", "95",
                                            "--min-aligned-fraction", "15"],
                                           0.95, 0.15)])
def test_validate_counts_match_galah_tpu(corpus, tmp_path, case, flags, ani,
                                         af):
    """The same violation count as galah_tpu's validate_clusters: 0 on
    the planted families, 1 with a family split into two clusters (its
    two representatives reach the threshold), 1 with a member of
    another family."""
    paths, labels = corpus
    cluster_file, expected = _cluster_files(tmp_path, paths, labels)[case]
    want = jvalidate(cluster_file, JFastANI(ani, af, store=JStore(k=15)))
    LAUNCHES["window_hits"] = 0
    got = tcli.run_cluster_validate(tcli.parse_args(
        ["cluster-validate", "--cluster-file", cluster_file,
         "--device", "cpu", *flags]))
    assert got.violations == want == expected
    n_reps = 4 + (case == "split")
    assert got.rep_pairs == n_reps * (n_reps - 1) // 2
    assert got.member_pairs == len(paths) - n_reps
    # the CPU runs the plain version; no kernel is launched
    assert LAUNCHES["window_hits"] == 0


def test_validate_cli_exit_codes(corpus, tmp_path, root_logger, capsys):
    """Exit 0 whatever the violations, as galah_tpu, --ani-subsample 125
    included; --ani-subsample 0 and a missing --cluster-file are refused
    (exit 1) with the flag named, as galah_tpu refuses them."""
    paths, labels = corpus
    cluster_file, _ = _cluster_files(tmp_path, paths, labels)["foreign"]
    argv = ["cluster-validate", "--cluster-file", cluster_file, "-q"]
    assert jmain(argv) == 0
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert jmain(["cluster-validate"]) == tcli.main(
        ["cluster-validate", "--device", "cpu"]) == 1
    assert "--cluster-file" in capsys.readouterr().err
    assert jmain([*argv, "--ani-subsample", "125"]) == 0
    assert tcli.main([*argv, "--device", "cpu", "--ani-subsample",
                      "125"]) == 0
    capsys.readouterr()
    assert jmain([*argv, "--ani-subsample", "0"]) == 1
    assert tcli.main([*argv, "--device", "cpu", "--ani-subsample",
                      "0"]) == 1
    err = capsys.readouterr().err
    assert err.count("--ani-subsample must be in [1, 1000], got 0") == 2


def _c_route(mat, k, min_ani, sketch_size=None):
    """galah_tpu's CPU route (the compiled-C pair walk), which its
    threshold_pairs takes on a 1-device CPU runtime."""
    return _cpairstats.threshold_pairs_c(
        mat, sketch_size or mat.shape[1], k, float(min_ani))


@pytest.mark.parametrize("flags", [[], ["--min-ani", "99.5"],
                                   ["--hash-algorithm", "tpufast",
                                    "--kmer-length", "17",
                                    "--num-hashes", "300"]])
def test_dist_tsv_matches_galah_tpu(corpus, monkeypatch, tmp_path,
                                    root_logger, capsys, flags):
    """The dist TSV is byte-identical to galah_tpu's on both sides of
    the sparse crossover: the port's streamed pass and its screen plus
    pairlist pass, against galah_tpu's C route and its sparse route."""
    paths, labels = corpus
    base = ["dist", "-f", *paths, "-q", *flags]
    out = {}
    monkeypatch.setattr(jpairwise, "threshold_pairs", _c_route)
    assert jmain([*base, "--output", str(tmp_path / "jc.tsv")]) == 0
    monkeypatch.undo()
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    assert jmain([*base, "--output", str(tmp_path / "js.tsv")]) == 0
    assert tcli.main([*base, "--device", "cpu",
                      "--output", str(tmp_path / "td.tsv")]) == 0
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    assert tcli.main([*base, "--device", "cpu"]) == 0  # to stdout
    out["ts"] = capsys.readouterr().out.encode()
    for name in ("jc", "js", "td"):
        out[name] = (tmp_path / f"{name}.tsv").read_bytes()
    assert out["td"] == out["ts"] == out["jc"] == out["js"]
    rows = [ln.split("\t") for ln in out["td"].decode().splitlines()]
    within = [(a, b) for a, b, _ in rows
              if labels[paths.index(a)] == labels[paths.index(b)]]
    if "--min-ani" in flags:  # a cut through the families' ANIs
        assert 0 < len(rows) < 4 * 3
        assert all(float(ani) >= 0.995 for _, _, ani in rows)
    else:  # every pair with any overlap: all the families' pairs
        assert len(within) == 4 * 3


def test_dist_refuses_murmur3_at_other_k(corpus, root_logger, capsys):
    """The port sketches k-mers of 1 to 32 bases: k = 0, which galah_tpu
    refuses too, and k = 33, where galah_tpu's 64-bit packs wrap and it
    hashes a k-mer's non-canonical orientation (ROADMAP.md, section 3),
    are refused naming the flag and the range."""
    paths, _ = corpus
    for k in (0, 33):
        assert tcli.main(["dist", "-f", *paths[:2], "--device", "cpu",
                          "--kmer-length", str(k)]) == 1
        err = capsys.readouterr().err
        assert f"--kmer-length {k}" in err and "1 to 32" in err
    assert jmain(["dist", "-f", *paths[:2], "--kmer-length", "0"]) == 1


@pytest.mark.parametrize("k", [9, 15, 16, 31, 32])
def test_dist_murmur3_at_other_k_matches_galah_tpu(corpus, monkeypatch,
                                                   tmp_path, root_logger,
                                                   k):
    """`dist --kmer-length k` with murmur3 writes galah_tpu's TSV byte for
    byte on both sides of the sparse crossover (the fused sketch's plain
    version at k on the CPU), and finds every within-family pair."""
    paths, labels = corpus
    base = ["dist", "-f", *paths, "-q", "--kmer-length", str(k)]
    monkeypatch.setattr(jpairwise, "threshold_pairs", _c_route)
    assert jmain([*base, "--output", str(tmp_path / "jc.tsv")]) == 0
    monkeypatch.undo()
    assert tcli.main([*base, "--device", "cpu",
                      "--output", str(tmp_path / "td.tsv")]) == 0
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    assert tcli.main([*base, "--device", "cpu",
                      "--output", str(tmp_path / "ts.tsv")]) == 0
    want = (tmp_path / "jc.tsv").read_bytes()
    assert (tmp_path / "td.tsv").read_bytes() == want
    assert (tmp_path / "ts.tsv").read_bytes() == want
    rows = [ln.split("\t") for ln in want.decode().splitlines()]
    within = [(a, b) for a, b, _ in rows
              if labels[paths.index(a)] == labels[paths.index(b)]]
    assert len(within) == 4 * 3
