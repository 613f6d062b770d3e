"""Port end to end with the dashing (HLL) precluster and quality
ordering: the CLI TSV against galah_tpu's, with and without a quality
input, and the port's own run on planted families.

Tolerance: none — TSV bytes equal, cluster lists equal. (galah_tpu's
pair pass is pinned to its single-device XLA form, use_pallas=False,
so conftest's 8-device mesh does not shard it; the pair set is the
same either way.)
"""

import logging

import numpy as np
import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.ops import hll as jhll
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.backends import HLLPreclusterer, HLLStore

from test_torch_cluster import _families

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def families24(tmp_path_factory):
    """24 genomes: 8 families x 3 members, 30 kb, ~2% divergence (the
    fixture of tests/test_torch_cluster.py), and quality inputs for
    them in all three formats."""
    d = tmp_path_factory.mktemp("dash24")
    paths, labels = _families(d, 7, 8, 3, 30_000, 0.02)
    rng = np.random.default_rng(3)
    comp = rng.permutation(np.arange(50.0, 98.0, 2.0))[:len(paths)]
    cont = np.round(rng.uniform(0.0, 4.0, size=len(paths)), 2)
    names = [f"fam{f}_m{i % 3}" for i, f in enumerate(labels)]
    checkm2 = d / "quality_report.tsv"
    checkm2.write_text("Name\tCompleteness\tContamination\n" + "".join(
        f"{n}\t{c}\t{x}\n" for n, c, x in zip(names, comp, cont)))
    checkm1 = d / "checkm1.tsv"
    checkm1.write_text(
        "Bin Id\tCompleteness\tContamination\tStrain heterogeneity\n"
        + "".join(f"{n}\t{c}\t{x}\t{h}\n" for n, c, x, h in zip(
            names, comp, cont, rng.uniform(0, 100, size=len(paths)))))
    info = d / "genomeInfo.csv"
    info.write_text("genome,completeness,contamination\n" + "".join(
        f"{n},{c},{x}\n" for n, c, x in zip(names, comp, cont)))
    return paths, labels, {"--checkm2-quality-report": str(checkm2),
                           "--checkm-tab-table": str(checkm1),
                           "--genome-info": str(info)}


@pytest.fixture
def single_device_hll(monkeypatch):
    orig = jhll.hll_threshold_pairs

    def pinned(regs_mat, k, min_ani, **kw):
        return orig(regs_mat, k=k, min_ani=min_ani, use_pallas=False, **kw)

    monkeypatch.setattr(jhll, "hll_threshold_pairs", pinned)


@pytest.mark.parametrize("method,algo,quality", [
    ("skani", "murmur3", []),
    ("skani", "murmur3", ["--checkm2-quality-report"]),
    ("fastani", "murmur3", ["--checkm2-quality-report",
                            "--min-completeness", "60"]),
    ("skani", "tpufast", ["--checkm-tab-table", "--quality-formula",
                          "dRep", "--max-contamination", "3"]),
    ("skani", "murmur3", ["--genome-info", "--quality-formula",
                          "completeness-4contamination"]),
])
def test_dashing_cli_tsv_byte_identical(families24, single_device_hll,
                                        tmp_path, method, algo, quality):
    """`cluster --precluster-method dashing` writes galah_tpu's TSV
    byte for byte, with the quality flags where given (the input
    flag's value is the fixture's file of that format)."""
    paths, _, inputs = families24
    flags = []
    for f in quality:
        flags.append(f)
        if f in inputs:
            flags.append(inputs[f])
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    common = ["cluster", "-f", *paths, "--ani", "97",
              "--precluster-ani", "90", "--min-aligned-fraction", "20",
              "--precluster-method", "dashing", "--cluster-method", method,
              "--hash-algorithm", algo, *flags]
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    assert tcli.main([*common, "--device", "cpu",
                      "--output-cluster-definition", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    if any(f.startswith(("--min-", "--max-")) for f in quality):
        assert len(got.read_text().splitlines()) < len(paths)


def test_dashing_clusters_are_families_with_best_representatives(
        families24):
    """The port's dashing run recovers the planted families, finds
    exactly the within-family pairs, and each family's representative
    is its best member under Parks2020_reduced (every genome here is
    one contig without N, so the best has the highest completeness
    minus 5x contamination)."""
    paths, labels, inputs = families24
    report = inputs["--checkm2-quality-report"]
    res = tcli.run_cluster(tcli.parse_args(
        ["cluster", "-f", *paths, "--device", "cpu", "--precluster-method",
         "dashing", "--checkm2-quality-report", report]))
    fams = sorted(sorted(labels[paths.index(res.genomes[i])] for i in c)
                  for c in res.clusters)
    assert fams == sorted([[f] * 3 for f in range(8)])
    score = {}
    with open(report) as fh:
        next(fh)
        for line in fh:
            name, c, x = line.split("\t")
            score[name] = float(c) - 5 * float(x)
    for c in res.clusters:
        members = [res.genomes[i] for i in c]
        stems = [m.rsplit("/", 1)[1][:-4] for m in members]
        assert score[stems[0]] == max(score[s] for s in stems)
    assert res.clock.counts["precluster-pairs"] == 8 * 3
    assert res.clock.counts["hll-launch-groups"] == 1
    assert res.clock.counts["genomes-read"] == 2 * len(paths)
    assert {"read", "sketch", "pair-stats", "profile", "exact-ani",
            "greedy"} <= set(res.clock.seconds)
    # the same pair dict from a preclusterer of its own
    pre = HLLPreclusterer(0.9, HLLStore(CPU)).distances(paths)
    assert len(pre) == 8 * 3


def test_cli_quality_flags(families24, capsys):
    base = ["cluster", "-f", families24[0][0]]
    args = tcli.parse_args([*base, "--checkm2-quality-report", "q.tsv",
                            "--min-completeness", "50",
                            "--max-contamination", "10",
                            "--quality-formula", "dRep"])
    assert (args.checkm2_quality_report, args.min_completeness,
            args.max_contamination, args.quality_formula) == (
        "q.tsv", 50.0, 10.0, "dRep")
    assert tcli.parse_args(base).quality_formula == "Parks2020_reduced"
    with pytest.raises(SystemExit):
        tcli.parse_args([*base, "--quality-formula", "best"])
    # two quality inputs: the run refuses before any work. main sets the
    # log level as galah-tpu does (replacing the root handlers), so the
    # message goes to stderr, and the root logger is restored after
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        assert tcli.main([*base, "--device", "cpu", "--checkm-tab-table",
                          "x", "--genome-info", "y"]) == 1
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    assert "at most one" in capsys.readouterr().err
