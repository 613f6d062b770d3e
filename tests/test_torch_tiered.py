"""Whole `cluster --precluster-method finch` runs of the out-of-core
tier in both packages: GALAH_TPU_HLL_BUCKETS x GALAH_TPU_PAGESTORE x
GALAH_TPU_PREFILTER in {0, 1} (both packages read the three), over a
corpus whose cardinality tiers lie bands apart and which holds byte
duplicates.

Tolerance: none — the TSV bytes, and the run reports' band, page store
and prefilter figures (metrics and the memory section), are galah_tpu's.
"""

import itertools
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from galah_tpu.cli import main as jmain
from galah_tpu.ops import collision as jcol
from galah_tpu_torch import cli as tcli

import torch  # noqa: E402

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

ACGT = np.array(list("ACGT"))
FLAGS = ("GALAH_TPU_HLL_BUCKETS", "GALAH_TPU_PAGESTORE",
         "GALAH_TPU_PREFILTER")
COMBOS = list(itertools.product("01", repeat=3))
FIGURES = ("precluster.bucket_pruned_pairs",
           "precluster.bucket_pruned_fraction", "precluster.bucket_count",
           "pagestore.page_ins", "pagestore.page_outs",
           "pagestore.resident_bytes", "prefilter.skipped",
           "prefilter.skipped_duplicate", "prefilter.skipped_degenerate",
           "prefilter.hll_prewarmed")


def _write(path, codes):
    seq = "".join(ACGT[codes])
    with open(path, "w") as f:
        f.write(">c\n" + "\n".join(seq[i:i + 70]
                                   for i in range(0, len(seq), 70)) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Families of two (~1% divergence) at 1.5, 15 and 100 kb, whose
    cardinalities fall in bands 3, 4 and 5 at 95% ANI, and two byte
    duplicates under other paths."""
    root = tmp_path_factory.mktemp("tiered_runs")
    rng = np.random.default_rng(41)
    paths = []
    for t, length in enumerate((1_500, 15_000, 100_000)):
        for fam in range(2):
            base = rng.integers(0, 4, size=length)
            for m in range(2):
                codes = base.copy()
                if m:
                    sites = rng.random(length) < 0.01
                    codes[sites] = (codes[sites] + 1) % 4
                paths.append(str(root / f"t{t}_f{fam}_m{m}.fna"))
                _write(paths[-1], codes)
    for i, src in enumerate((paths[5], paths[10])):
        dup = str(root / f"dup{i}.fna")
        shutil.copyfile(src, dup)
        paths.append(dup)
    order = np.random.default_rng(42).permutation(len(paths))
    return [paths[i] for i in order]


def _run(main, argv):
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        assert main(argv) == 0, argv
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)


@pytest.mark.parametrize("combo", COMBOS, ids=["".join(c) for c in COMBOS])
def test_finch_runs_equal_galah_tpu(corpus, tmp_path, monkeypatch, combo):
    """Each flag combination: the TSV is galah_tpu's under the same
    flags, and so are the reports' band, page and prefilter figures;
    the bucketed runs prune pairs, the paged ones page, the prefiltered
    ones skip the two duplicates and pre-warm every register row."""
    for name, value in zip(FLAGS, combo):
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("GALAH_TPU_SKETCH_RAM_MB", "1")
    # galah_tpu's side: its C sketcher, and its pair passes off
    # conftest's 8-device mesh
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "c")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    reports = {}
    tsvs = {}
    for side, main, extra in (("jax", jmain, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        _run(main, ["cluster", "-f", *corpus, "--precluster-method",
                    "finch", "--ani", "97", "--precluster-ani", "95",
                    "--sketch-cache", str(d / "cache"), *extra,
                    "--run-report", str(d / "report.json"),
                    "--output-cluster-definition", str(d / "out.tsv")])
        tsvs[side] = (d / "out.tsv").read_bytes()
        with open(d / "report.json") as fh:
            reports[side] = json.load(fh)
    assert tsvs["port"] == tsvs["jax"]
    got, want = (reports[s]["metrics"] for s in ("port", "jax"))
    for name in FIGURES:
        assert (got.get(name) or {}).get("value") == \
            (want.get(name) or {}).get("value"), name
    assert reports["port"].get("memory") == reports["jax"].get("memory")
    bucketed, paged, prefiltered = (c == "1" for c in combo)
    assert ("precluster.bucket_count" in got) == bucketed
    if bucketed:
        assert got["precluster.bucket_count"]["value"] == 3.0
        assert got["precluster.bucket_pruned_pairs"]["value"] > 0
    assert ("pagestore.page_ins" in got) == (bucketed and paged)
    if bucketed and paged:
        assert got["pagestore.page_ins"]["value"] > 0
    assert ("prefilter.skipped" in got) == prefiltered
    if prefiltered:
        assert got["prefilter.skipped_duplicate"]["value"] == 2
        assert got["prefilter.hll_prewarmed"]["value"] == len(corpus)


def test_tier_imports_neither_jax_nor_galah_tpu(corpus, tmp_path):
    """In a fresh interpreter, a bucketed, paged, prefiltered finch run
    with a disk cache, a paged index build and the C collision counter
    load the tier's modules and leave jax and galah_tpu out of
    sys.modules."""
    code = (
        "import os, sys\n"
        "os.environ.update(GALAH_TPU_HLL_BUCKETS='1',"
        " GALAH_TPU_PAGESTORE='1', GALAH_TPU_PREFILTER='1')\n"
        "import numpy as np\n"
        "from galah_tpu_torch.cli import main\n"
        "from galah_tpu_torch.ops import collision\n"
        f"rc = main(['cluster', '-f', *{corpus!r}, '--device', 'cpu',"
        " '--precluster-method', 'finch', '--precluster-ani', '95',"
        f" '--sketch-cache', {str(tmp_path / 'cache')!r},"
        f" '--output-cluster-definition', {str(tmp_path / 'o.tsv')!r}])\n"
        f"rc = rc or main(['index', '--index-dir', {str(tmp_path / 'ix')!r},"
        f" '--device', 'cpu', 'build', '-f', *{corpus[:4]!r}])\n"
        "mat = np.sort(np.arange(40, dtype=np.uint64).reshape(4, 10) % 13,"
        " axis=1)\n"
        "pi, pj, c = collision.collision_pair_counts(mat, np.full(4, 10))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'galah_tpu')]\n"
        "new = [m for m in ('ops.bucketing', 'ops.prefilter', "
        "'io.pagestore', 'ops._ccollision', 'index.store') "
        "if 'galah_tpu_torch.' + m not in sys.modules]\n"
        "print('LOADED', bad, 'MISSING', new)\n"
        "sys.exit(rc or (1 if bad or new else 0))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GALAH_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=str(pathlib.Path(__file__).parent.parent),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED [] MISSING []" in proc.stdout
