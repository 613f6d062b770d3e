"""Port end to end with the finch precluster: clusters and the CLI TSV
against galah_tpu, the port's dense and sparse finch passes against
each other, and the finch CLI's flags.

Tolerance: none — cluster lists equal, TSV bytes equal, pair dicts
(float64 ANIs) equal.
"""

import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.ops import collision as jcol
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import timing
from galah_tpu_torch.backends import MinHashPreclusterer, SketchStore
from galah_tpu_torch.ops import collision as tcol

from test_torch_cluster import _families

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def families24(tmp_path_factory):
    """24 genomes: 8 families x 3 members, 30 kb, ~2% divergence (the
    fixture of tests/test_torch_cluster.py)."""
    return _families(tmp_path_factory.mktemp("finch24"), 7, 8, 3, 30_000,
                     0.02)


@pytest.mark.parametrize("method,algo", [("skani", "murmur3"),
                                         ("fastani", "murmur3"),
                                         ("skani", "tpufast")])
def test_finch_cli_tsv_byte_identical(families24, monkeypatch, tmp_path,
                                      method, algo):
    """`cluster --precluster-method finch` writes galah_tpu's TSV byte
    for byte (galah_tpu's crossover at 0 keeps its pair pass off
    conftest's 8-device mesh; its result is the dense pass's)."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    paths, labels = families24
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    common = ["cluster", "-f", *paths, "--ani", "97",
              "--precluster-ani", "90", "--min-aligned-fraction", "20",
              "--precluster-method", "finch", "--cluster-method", method,
              "--hash-algorithm", algo]
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    assert tcli.main([*common, "--device", "cpu",
                      "--output-cluster-definition", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_finch_clusters_are_the_families_on_both_passes(families24,
                                                        monkeypatch):
    """The port's finch run recovers the planted families, with the same
    precluster pair dict from the dense pass and the sparse pass."""
    paths, labels = families24
    args = tcli.parse_args(["cluster", "-f", *paths, "--device", "cpu",
                            "--precluster-method", "finch"])
    dense = tcli.run_cluster(args)
    pre_dense = MinHashPreclusterer(0.9, SketchStore(CPU)).distances(paths)
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    sparse = tcli.run_cluster(args)
    pre_sparse = MinHashPreclusterer(0.9, SketchStore(CPU)).distances(paths)
    assert pre_sparse == pre_dense
    assert len(pre_dense) == 8 * 3
    assert sparse.clusters == dense.clusters
    fams = sorted(sorted(labels[i] for i in c) for c in dense.clusters)
    assert fams == sorted([[f] * 3 for f in range(8)])
    assert dense.clock.counts["sketch-fused-jobs"] == len(paths)
    # each genome read once for its sketch and once for its profile
    assert dense.clock.counts["genomes-read"] == 2 * len(paths)
    assert "collision-screen" in sparse.clock.seconds
    assert "collision-screen" not in dense.clock.seconds


def test_cli_finch_flags():
    base = ["cluster", "-f", "a.fna", "--precluster-method", "finch"]
    args = tcli.parse_args([*base, "--hash-algorithm", "tpufast"])
    assert (args.precluster_method, args.hash_algorithm) == ("finch",
                                                            "tpufast")
    assert tcli.parse_args(base).hash_algorithm == "murmur3"
    with pytest.raises(SystemExit):
        tcli.parse_args([*base, "--hash-algorithm", "xxhash"])


def test_stage_clock_excludes_nested_stages(monkeypatch):
    """A stage's seconds exclude the stages nested in it (the finch
    run's greedy stage reads and profiles genomes)."""
    ticks = iter([0.0, 1.0, 3.0, 4.0, 4.5, 10.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    clock = timing.StageClock(CPU)
    with clock.stage("greedy"):
        with clock.stage("read"):
            pass
        with clock.stage("read"):
            pass
    assert dict(clock.seconds) == {"read": 2.5, "greedy": 7.5}
