"""``--on-bad-genome skip`` on the port against galah_tpu: verdicts,
the preflight's kept list and records, the manifest, the genome-input
branch, the read retry and the command line.

Tolerance: none. Lists, records, manifest bytes and TSV bytes are
compared for equality.
"""

import errno
import gzip
import json
import os

import numpy as np
import pytest

from galah_tpu.cli import main as jmain
from galah_tpu.genome_inputs import parse_genome_inputs as jparse
from galah_tpu.ops import collision
from galah_tpu.resilience import quarantine as jq
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.genome_inputs import parse_genome_inputs as tparse
from galah_tpu_torch.io import fasta as tfasta
from galah_tpu_torch.resilience import quarantine as tq

pytestmark = pytest.mark.fault_injection


def _genome(path, codes):
    path.write_text(">c1\n" + "".join("ACGT"[c] for c in codes) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """9 good genomes (3 families of 3, 25 kb, ~1% apart) and one file
    of each bad kind: text with no record, empty, truncated gzip,
    binary bytes named .fna, and a missing path."""
    root = tmp_path_factory.mktemp("quarantine")
    rng = np.random.default_rng(11)
    good = []
    for fam in range(3):
        base = rng.integers(0, 4, size=25_000)
        for m in range(3):
            codes = base.copy()
            sites = rng.random(codes.shape[0]) < 0.01
            codes[sites] = (codes[sites] + 1) % 4
            good.append(_genome(root / f"fam{fam}_m{m}.fna", codes))
    (root / "text.fna").write_text("this is not FASTA at all\n")
    (root / "empty.fna").write_bytes(b"")
    whole = gzip.compress(b">c\n" + b"ACGT" * 4000 + b"\n")
    (root / "trunc.fna.gz").write_bytes(whole[:len(whole) // 2])
    (root / "binary.fna").write_bytes(bytes(range(256)) * 64)
    bad = {"text": str(root / "text.fna"), "empty": str(root / "empty.fna"),
           "trunc": str(root / "trunc.fna.gz"),
           "binary": str(root / "binary.fna"),
           "missing": str(root / "missing.fna")}
    return good, bad


def _mixed(good, bad):
    """Bad inputs between good ones, as a listing would hold them."""
    return [good[0], bad["empty"], *good[1:4], bad["trunc"], good[4],
            bad["binary"], bad["text"], *good[5:], bad["missing"]]


def test_validate_genome_verdicts_equal_galah_tpu(corpus):
    good, bad = corpus
    for p in [*good[:2], *bad.values()]:
        got, want = tq.validate_genome(p), jq.validate_genome(p)
        assert (got and got[0]) == (want and want[0]), p
    assert tq.validate_genome(good[0]) is None
    assert tq.validate_genome(bad["empty"])[0] == "empty"
    assert tq.validate_genome(bad["trunc"])[0] == "corrupt"
    assert tq.validate_genome(bad["missing"])[0] == "missing"


@pytest.mark.parametrize("threads", [1, 4])
def test_preflight_equals_galah_tpu(corpus, threads):
    good, bad = corpus
    paths = _mixed(good, bad)
    kept, man = tq.preflight_quarantine(paths, threads=threads)
    jkept, jman = jq.preflight_quarantine(paths)
    assert kept == jkept == good
    assert [(r.path, r.reason) for r in man.records()] == \
        [(r.path, r.reason) for r in jman.records()]
    assert [r.reason for r in man.records()] == [
        "empty", "corrupt", "empty", "empty", "missing"]
    assert tq.preflight_quarantine(good, threads=threads)[0] == good


def test_parse_inputs_skip_equals_galah_tpu(corpus, tmp_path):
    good, bad = corpus
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join([good[0], bad["missing"], good[1]]) + "\n")
    tm, jm = tq.QuarantineManifest(), jq.QuarantineManifest()
    kw = dict(genome_fasta_files=[good[2]],
              genome_fasta_list=str(listing), on_bad_genome="skip")
    assert tparse(manifest=tm, **kw) == jparse(manifest=jm, **kw) == \
        [good[2], good[0], good[1]]
    assert [vars(r) for r in tm.records()] == \
        [vars(r) for r in jm.records()]
    with pytest.raises(FileNotFoundError):
        tparse(genome_fasta_list=str(listing))
    with pytest.raises(FileNotFoundError, match="every input"):
        tparse(genome_fasta_files=[bad["missing"]], on_bad_genome="skip")


def test_manifest_bytes_equal_galah_tpu(tmp_path):
    recs = [("/d/a.fna", "corrupt", "bad gzip"), ("/d/b.fna", "missing",
                                                  "not a regular file")]
    for mod, name in ((tq, "port"), (jq, "jax")):
        m = mod.QuarantineManifest()
        for r in recs:
            m.add(*r)
        out = m.write(str(tmp_path / name))
        assert os.path.basename(out) == "quarantine.json"
    assert (tmp_path / "port" / "quarantine.json").read_bytes() == \
        (tmp_path / "jax" / "quarantine.json").read_bytes()
    back = tq.QuarantineManifest.load(str(tmp_path / "jax" /
                                          "quarantine.json"))
    assert [(r.path, r.reason) for r in back.records()] == \
        [r[:2] for r in recs]
    for kw, want in (({"cluster_definition": "/o/c.tsv",
                       "representative_list": "/r/l.txt"}, "/o"),
                     ({"representative_list": "/r/l.txt"}, "/r"),
                     ({"checkpoint_dir": "/ck"}, "/ck"), ({}, ".")):
        assert tq.manifest_output_dir(**kw) == jq.manifest_output_dir(**kw) \
            == want


def test_read_retries_transient_errors(corpus, monkeypatch):
    good, _ = corpus
    want = tfasta.read_genome_plain(good[0]).stats
    real = tfasta._read_bytes
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(errno.EIO, "network filesystem flake")
        return real(path)

    slept = []
    monkeypatch.setattr(tfasta, "_read_bytes", flaky)
    monkeypatch.setattr("time.sleep", slept.append)
    assert tfasta.read_genome(good[0]).stats == want
    assert len(calls) == 2 and len(slept) == 1
    monkeypatch.setattr(tfasta, "_read_bytes", real)
    with pytest.raises(FileNotFoundError):
        tfasta.read_genome(good[0] + ".gone")
    assert len(slept) == 1  # a missing file is not retried


@pytest.fixture
def no_dense_mesh(monkeypatch):
    """galah_tpu's exact collision screen instead of its 8-device CPU
    mesh: the same pair list, seconds faster."""
    monkeypatch.setattr(collision, "SPARSE_SCREEN_MIN_N", 0)


def test_cli_skip_equals_galah_tpu_and_the_good_run(corpus, tmp_path,
                                                    no_dense_mesh):
    good, bad = corpus
    listing = tmp_path / "genomes.txt"
    listing.write_text("\n".join(_mixed(good, bad)) + "\n")
    outs = {}
    for side, run, extra in (("port", tcli.main, ["--device", "cpu",
                                                  "--threads", "3"]),
                             ("jax", jmain, [])):
        (tmp_path / side).mkdir()
        outs[side] = tmp_path / side / "clusters.tsv"
        assert run(["cluster", "--genome-fasta-list", str(listing),
                    "--on-bad-genome", "skip", "--ani", "95",
                    "--output-cluster-definition", str(outs[side]),
                    *extra]) == 0
    clean = tmp_path / "clean.tsv"
    assert tcli.main(["cluster", "-f", *good, "--ani", "95", "--device",
                      "cpu", "--output-cluster-definition", str(clean)]) == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes() == \
        clean.read_bytes()
    manifests = {side: json.loads((tmp_path / side /
                                   "quarantine.json").read_text())
                 for side in outs}
    assert [(r["path"], r["reason"]) for r in
            manifests["port"]["quarantined"]] == \
        [(r["path"], r["reason"]) for r in manifests["jax"]["quarantined"]]
    assert [r["reason"] for r in manifests["port"]["quarantined"]] == [
        "missing", "empty", "corrupt", "empty", "empty"]
    # without skip the same input fails on a user error
    assert tcli.main(["cluster", "--genome-fasta-list", str(listing),
                      "--device", "cpu", "--output-cluster-definition",
                      str(tmp_path / "x.tsv")]) == 1
    assert tcli.main(["cluster", "-f", *good[:4], bad["empty"],
                      "--device", "cpu", "--output-cluster-definition",
                      str(tmp_path / "y.tsv")]) == 1
    # every genome quarantined: nothing to cluster
    assert tcli.main(["cluster", "-f", bad["empty"], bad["text"],
                      "--on-bad-genome", "skip", "--device", "cpu",
                      "--output-cluster-definition",
                      str(tmp_path / "z.tsv")]) == 1
