"""Port end to end: clusters and the CLI TSV against galah_tpu, plus
the package boundary (no jax, nothing of galah_tpu).

Tolerance: none — cluster lists equal, TSV bytes equal.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from galah_tpu.backends import (FastANIEquivalentClusterer,
                                ProfileStore as JStore,
                                SkaniEquivalentClusterer,
                                SkaniPreclusterer)
from galah_tpu.cli import main as jmain
from galah_tpu.cluster import cluster as jcluster
from galah_tpu.ops import collision
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.backends import ProfileStore as TStore
from galah_tpu_torch.backends import (
    FastANIEquivalentClusterer as TFastANI,
    SkaniEquivalentClusterer as TSkani,
    SkaniPreclusterer as TSkaniPre,
)
from galah_tpu_torch.cluster.engine import cluster as tcluster
from galah_tpu_torch.device import resolve_device

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))
REPO = pathlib.Path(__file__).resolve().parents[1]


def _families(root, seed, n_fam, size, length, rate):
    rng = np.random.default_rng(seed)
    paths, labels = [], []
    for fam in range(n_fam):
        base = rng.integers(0, 4, size=length)
        for m in range(size):
            codes = base.copy()
            if m:  # member 0 is the unmutated base
                sites = rng.random(length) < rate
                codes[sites] = (codes[sites] + rng.integers(
                    1, 4, size=int(sites.sum()))) % 4
            seq = "".join(ACGT[codes])
            p = root / f"fam{fam}_m{m}.fna"
            with open(p, "w") as f:
                f.write(">contig1\n")
                for i in range(0, len(seq), 70):
                    f.write(seq[i:i + 70] + "\n")
            paths.append(str(p))
            labels.append(fam)
    return paths, labels


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """3 families x 4 members, 60 kb, ~0.5% divergence (as in
    tests/test_synthetic_families.py)."""
    return _families(tmp_path_factory.mktemp("fam"), 42, 3, 4, 60_000,
                     0.005)


@pytest.fixture(scope="module")
def families24(tmp_path_factory):
    """24 genomes: 8 families x 3 members, 30 kb, ~2% divergence."""
    return _families(tmp_path_factory.mktemp("fam24"), 7, 8, 3, 30_000,
                     0.02)


@pytest.fixture
def no_dense_mesh(monkeypatch):
    """galah_tpu's screen on conftest's 8-device CPU mesh costs seconds
    per call; its exact collision screen gives the same pair list."""
    monkeypatch.setattr(collision, "SPARSE_SCREEN_MIN_N", 0)


def _jax_run(paths, method, ani):
    store = JStore(k=15)
    pre = SkaniPreclusterer(threshold=ani if method == "skani" else 0.9,
                            min_aligned_fraction=0.15, store=store)
    cl = (SkaniEquivalentClusterer(ani, 0.15, store=store)
          if method == "skani" else
          FastANIEquivalentClusterer(ani, 0.15, store=store))
    return jcluster(paths, pre, cl)


def _port_run(paths, method, ani):
    store = TStore(CPU)
    pre = TSkaniPre(threshold=ani if method == "skani" else 0.9,
                    min_aligned_fraction=0.15, store=store)
    cl = (TSkani(ani, 0.15, store) if method == "skani"
          else TFastANI(ani, 0.15, store))
    return tcluster(paths, pre, cl, CPU)


@pytest.mark.parametrize("method", ["skani", "fastani"])
@pytest.mark.parametrize("corpus", ["families", "families24"])
def test_clusters_match_galah_tpu(request, no_dense_mesh, corpus, method):
    paths, labels = request.getfixturevalue(corpus)
    for ani in (0.95, 0.99):
        want = _jax_run(paths, method, ani)
        got = _port_run(paths, method, ani)
        assert got == want, (ani, got, want)
    # at 95% the clusters are the planted families
    fams = sorted(sorted(labels[i] for i in c)
                  for c in _port_run(paths, method, 0.95))
    assert fams == sorted([[f] * labels.count(f) for f in set(labels)])


@pytest.mark.parametrize("method", ["skani", "fastani"])
def test_cli_tsv_byte_identical(families24, no_dense_mesh, tmp_path,
                                method):
    paths, _ = families24
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    common = ["cluster", "-f", *paths, "--ani", "97",
              "--precluster-ani", "90", "--min-aligned-fraction", "20",
              "--cluster-method", method]
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    assert tcli.main([*common, "--device", "cpu",
                      "--output-cluster-definition", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_cli_directory_input(families, tmp_path):
    paths, _ = families
    out = tmp_path / "dir.tsv"
    root = os.path.dirname(paths[0])
    assert tcli.main(["cluster", "-d", root, "--device", "cpu",
                      "--output-cluster-definition", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == len(paths)
    assert {ln.split("\t")[1] for ln in lines} == set(paths)


@pytest.mark.parametrize("flag", [
    ["--platform", "cpu"], ["--rep-scan-window", "8"],
    ["--profile-trace-dir", "d"]])
def test_cli_rejects_unsupported_flag_by_name(flag, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["cluster", "-f", "a.fna", *flag])
    assert e.value.code == 2
    assert flag[0].split("=")[0] in capsys.readouterr().err


@pytest.mark.parametrize("sub", ["cluster", "index"])
@pytest.mark.parametrize("flag", ["--run-report", "--trace-events"])
def test_cli_accepts_observability_flag(families, tmp_path, sub, flag):
    """--run-report and --trace-events, refused before the port had a
    run report, parse on `cluster` and `index` (also as --flag=value)
    and write their file, which loads as JSON."""
    paths, _ = families
    out = tmp_path / "out.json"
    argv = (["cluster", "-f", *paths[:4], "--device", "cpu", f"{flag}={out}"]
            if sub == "cluster" else
            ["index", "--index-dir", str(tmp_path / "idx"), "--device",
             "cpu", f"{flag}={out}", "build", "-f", *paths[:4]])
    args = tcli.parse_args(argv)
    assert getattr(args, flag[2:].replace("-", "_")) == str(out)
    assert tcli.main(argv) == 0
    with open(out) as fh:
        loaded = json.load(fh)
    if flag == "--run-report":
        assert loaded["kind"] == "galah-tpu-run-report"
        assert loaded["run"]["subcommand"] == sub
    else:
        assert any(ev.get("ph") == "X" for ev in loaded)


def test_cli_parses_ani_subsample():
    """--ani-subsample, refused before the port had subsampled profiles,
    parses on `cluster` and `cluster-validate` (default 1)."""
    args = tcli.parse_args(["cluster", "-f", "a.fna", "--ani-subsample",
                            "125"])
    assert args.ani_subsample == 125
    assert tcli.parse_args(["cluster", "-f", "a.fna"]).ani_subsample == 1
    args = tcli.parse_args(["cluster-validate", "--cluster-file", "c.tsv",
                            "--ani-subsample", "125"])
    assert args.ani_subsample == 125


def test_cli_rejects_unsupported_precluster_method(capsys):
    """All three of galah-tpu's precluster methods parse; any other is
    refused by name."""
    for method in ("skani", "finch", "dashing"):
        args = tcli.parse_args(["cluster", "-f", "a.fna",
                                "--precluster-method", method])
        assert args.precluster_method == method
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["cluster", "-f", "a.fna", "--precluster-method",
                         "mash"])
    assert e.value.code == 2
    assert "'mash'" in capsys.readouterr().err


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu") == CPU


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_galah_tpu():
    files = sorted((REPO / "galah_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"galah_tpu_torch/io/_cingest.py",
            "galah_tpu_torch/io/prefetch.py",
            "galah_tpu_torch/io/atomic.py",
            "galah_tpu_torch/io/diskcache.py",
            "galah_tpu_torch/genome_inputs.py",
            "galah_tpu_torch/manpage.py",
            "galah_tpu_torch/validate.py",
            "galah_tpu_torch/index/__init__.py",
            "galah_tpu_torch/index/store.py",
            "galah_tpu_torch/index/incremental.py",
            "galah_tpu_torch/obs/__init__.py",
            "galah_tpu_torch/obs/heartbeat.py",
            "galah_tpu_torch/obs/metrics.py",
            "galah_tpu_torch/obs/report.py",
            "galah_tpu_torch/obs/trace.py"} <= names
    for f in files:
        for mod in _imports(ast.parse(f.read_text())):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "galah_tpu"), (f, mod)


def test_port_run_loads_no_jax(families, tmp_path):
    """CPU cluster runs of the port (skani, finch and dashing
    preclusters, a persistent sketch cache, the representative
    outputs), cluster-validate and dist in a fresh interpreter leave jax
    and galah_tpu out of sys.modules, and reach the C parser, the
    read-ahead, the genome inputs, the cache and its durable write, the
    outputs, the validation, the help pages, the sketch index (build,
    insert, query, remove, fsck), the library API with a subsampled
    profile, and dist at another k."""
    paths, _ = families
    out = tmp_path / "o.tsv"
    listing = tmp_path / "genomes.txt"
    listing.write_text("\n".join(paths[:4]) + "\n")
    code = (
        "import sys\n"
        "from galah_tpu_torch.cli import main\n"
        f"rc = main(['cluster', '-f', *{paths[:4]!r}, '--device', 'cpu',"
        f" '--precluster-method', 'finch', '--threads', '2',"
        f" '--sketch-cache', {str(tmp_path / 'cache')!r},"
        f" '--output-cluster-definition', {str(out)!r}])\n"
        f"rc = rc or main(['cluster', '--genome-fasta-list',"
        f" {str(listing)!r}, '--device', 'cpu', '-q',"
        f" '--output-representative-list', {str(tmp_path / 'r.txt')!r},"
        f" '--output-cluster-definition', {str(out)!r}])\n"
        f"rc = rc or main(['cluster', '-f', *{paths[:4]!r}, '--device',"
        f" 'cpu', '--precluster-method', 'dashing', '--ani-subsample',"
        f" '16', '--output-cluster-definition', {str(out)!r}])\n"
        f"rc = rc or main(['cluster-validate', '--cluster-file',"
        f" {str(out)!r}, '--device', 'cpu'])\n"
        f"rc = rc or main(['dist', '-f', *{paths[:4]!r}, '--device', 'cpu',"
        f" '--kmer-length', '16', '--output', {str(tmp_path / 'd.tsv')!r}])\n"
        "rc = rc or main(['dist', '--full-help-roff'])\n"
        f"ix = ['index', '--index-dir', {str(tmp_path / 'ix')!r},"
        f" '--device', 'cpu']\n"
        f"rc = rc or main([*ix, 'build', '-f', *{paths[:3]!r}])\n"
        f"rc = rc or main([*ix, 'insert', '-f', *{paths[3:5]!r}])\n"
        f"rc = rc or main([*ix, 'query', '-f', {paths[5]!r}, '--output',"
        f" {str(tmp_path / 'q.tsv')!r}])\n"
        f"rc = rc or main([*ix, 'remove', '-f', {paths[0]!r}])\n"
        f"rc = rc or main([*ix, 'fsck'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'galah_tpu')]\n"
        "new = [m for m in ('io._cingest', 'io.prefetch', 'io.atomic', "
        "'io.diskcache', 'genome_inputs', 'outputs', 'validate', "
        "'manpage', 'index', 'index.store', 'index.incremental', 'api', "
        "'backends.base', 'obs.events') "
        "if 'galah_tpu_torch.' + m not in sys.modules]\n"
        "print('LOADED', bad, 'MISSING', new)\n"
        "sys.exit(rc or (1 if bad or new else 0))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED [] MISSING []" in proc.stdout
    assert len(out.read_text().splitlines()) == 4
    assert len((tmp_path / "q.tsv").read_text().splitlines()) == 2
