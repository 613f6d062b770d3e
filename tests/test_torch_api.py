"""The port's library API (``galah_tpu_torch/api.py``) against
``galah_tpu.api`` on the same inputs: each case of tests/test_api.py,
run through both packages.

Tolerance: none — option strings, defaults, choices, genome order,
backend classes, ``backend_params``, error messages and cluster lists
equal. galah_tpu's whole runs take its exact collision screen
(``collision.SPARSE_SCREEN_MIN_N`` at 0) and its single-device HLL pass
(``use_pallas=False``), off conftest's 8-device mesh; the pair sets are
the same either way.
"""

import argparse
import logging
import subprocess
import sys

import pytest
import torch

from galah_tpu import api as japi
from galah_tpu.obs import events as jevents
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import hll as jhll
from galah_tpu_torch import api as tapi
from galah_tpu_torch.backends import ClusterBackend, PreclusterBackend
from galah_tpu_torch.cluster.checkpoint import fingerprint_fields
from galah_tpu_torch.obs import events as tevents

from test_torch_cluster import REPO, _families

CPU = torch.device("cpu")

# CoverM's names for the dereplication flags it embeds
COVERM = {
    "ani": "dereplication-ani",
    "precluster_ani": "dereplication-prethreshold-ani",
    "min_aligned_fraction": "dereplication-aligned-fraction",
    "fragment_length": "dereplication-fragment-length",
    "precluster_method": "dereplication-precluster-method",
    "cluster_method": "dereplication-cluster-method",
    "quality_formula": "dereplication-quality-formula",
    "ani_subsample": "dereplication-ani-subsample",
    "rep_scan_window": "dereplication-scan-window",
    "checkm2_quality_report": "checkm2-quality-report-file",
    "min_completeness": "min-completeness-percent",
    "threads": "dereplication-threads",
}


def _definitions(renamed):
    kw = COVERM if renamed else {}
    return (japi.ClustererCommandDefinition(**kw),
            tapi.ClustererCommandDefinition(**kw))


def _parse(api, defn, argv):
    parser = argparse.ArgumentParser()
    api.add_cluster_arguments(parser, defn)
    return vars(parser.parse_args(argv))


def _flags(renamed, **values):
    """argv setting each definition field of `values` under its name."""
    kw = COVERM if renamed else {}
    argv = []
    for field, value in values.items():
        argv += [f"--{kw.get(field, field.replace('_', '-'))}", str(value)]
    return argv


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """4 families x 3 members, 30 kb, ~1% divergence."""
    return _families(tmp_path_factory.mktemp("api"), 23, 4, 3, 30_000,
                     0.01)


@pytest.fixture
def single_device(monkeypatch):
    """galah_tpu off conftest's 8-device mesh: its exact collision
    screen and its single-device HLL pass."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    orig = jhll.hll_threshold_pairs

    def pinned(regs_mat, k, min_ani, **kw):
        return orig(regs_mat, k=k, min_ani=min_ani, use_pallas=False, **kw)

    monkeypatch.setattr(jhll, "hll_threshold_pairs", pinned)


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.type,
             tuple(a.choices) if a.choices else None, a.nargs)
            for a in parser._actions if a.dest != "help"]


@pytest.mark.parametrize("renamed", [False, True])
def test_add_cluster_arguments_matches_galah_tpu(renamed):
    """The same option strings, dests, defaults, types and choices, in
    the same order, under the default and the renamed definition."""
    jd, td = _definitions(renamed)
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    japi.add_cluster_arguments(jp, jd)
    tapi.add_cluster_arguments(tp, td)
    assert _actions(tp) == _actions(jp)
    assert dataclass_fields(td) == dataclass_fields(jd)
    for field in dataclass_fields(td):
        name = getattr(td, field)
        assert td.dest(name) == jd.dest(name)


def dataclass_fields(defn):
    import dataclasses

    return {f.name: getattr(defn, f.name)
            for f in dataclasses.fields(defn)}


@pytest.mark.parametrize("renamed", [False, True])
@pytest.mark.parametrize("values", [
    {},
    {"ani": 97, "precluster_ani": 92, "cluster_method": "fastani"},
    {"precluster_method": "finch", "ani": 98, "fragment_length": 2000},
    {"precluster_method": "dashing", "hash_algorithm": "tpufast",
     "min_aligned_fraction": 0.3},
    {"ani_subsample": 16, "threads": 3},
    {"ani_subsample": 125, "precluster_method": "finch",
     "cluster_method": "fastani"},
], ids=["default", "fastani", "finch", "dashing", "subsample16",
        "subsample125"])
def test_renamed_flags_parse_and_build(values, renamed):
    """Flags parsed under either definition build the same clusterer in
    both packages: genome order, backend classes, thresholds and
    backend_params (and so the checkpoint fingerprint)."""
    jd, td = _definitions(renamed)
    argv = _flags(renamed, **values)
    jv, tv = _parse(japi, jd, argv), _parse(tapi, td, argv)
    assert tv == jv
    paths = ["x.fna", "y.fna"]
    want = japi.generate_galah_clusterer(paths, jv, jd)
    got = tapi.generate_galah_clusterer(paths, tv, td, device="cpu")
    assert isinstance(got, tapi.GalahClusterer)
    assert got.genome_paths == want.genome_paths
    assert type(got.preclusterer).__name__ == \
        type(want.preclusterer).__name__
    assert type(got.clusterer).__name__ == type(want.clusterer).__name__
    assert isinstance(got.preclusterer, PreclusterBackend)
    assert isinstance(got.clusterer, ClusterBackend)
    assert got.clusterer.ani_threshold == want.clusterer.ani_threshold
    assert got.clusterer.method_name() == want.clusterer.method_name()
    assert got.backend_params == want.backend_params
    assert got.rep_rounds == want.rep_rounds
    assert got.clusterer.store._params() == want.clusterer.store._params()
    assert got.clusterer.store.subsample_c == \
        want.clusterer.store.subsample_c
    assert got.clusterer.store.threads == want.clusterer.store.threads


@pytest.mark.parametrize("argv,field", [
    (["--dereplication-ani", "101"], "ani"),
    (["--dereplication-prethreshold-ani", "-1"], "precluster_ani"),
    (["--dereplication-aligned-fraction", "250"], "min_aligned_fraction"),
    (["--dereplication-ani-subsample", "0"], "ani_subsample"),
    (["--dereplication-ani-subsample", "1001"], "ani_subsample"),
    (["--rep-rounds", "0"], "rep_rounds"),
    (["--checkm2-quality-report-file", "q.tsv",
      "--min-completeness-percent", "120"], "min_completeness"),
])
def test_out_of_range_values_name_the_renamed_flag(argv, field, tmp_path):
    """A bad value is the same ValueError in both packages, naming the
    flag under the definition's name."""
    jd, td = _definitions(True)
    report = tmp_path / "q.tsv"
    report.write_text("Name\tCompleteness\tContamination\nx\t90\t1\n")
    argv = [str(report) if a == "q.tsv" else a for a in argv]
    with pytest.raises(ValueError) as je:
        japi.generate_galah_clusterer(["x.fna"], _parse(japi, jd, argv), jd)
    with pytest.raises(ValueError) as te:
        tapi.generate_galah_clusterer(["x.fna"], _parse(tapi, td, argv), td,
                                      device="cpu")
    assert str(te.value) == str(je.value)
    assert f"--{getattr(td, field)}" in str(te.value)


def test_rep_scan_window_is_refused_by_its_renamed_name():
    """The scan window is taken at 8, as galah_tpu takes it, and handed
    to the engine; at 0 it is refused with galah_tpu's message, named
    as the embedding tool spelled it."""
    jd, td = _definitions(True)
    values = _parse(tapi, td, ["--dereplication-scan-window", "8"])
    got = tapi.generate_galah_clusterer(["x.fna"], values, td, device="cpu")
    want = japi.generate_galah_clusterer(
        ["x.fna"], _parse(japi, jd, ["--dereplication-scan-window", "8"]),
        jd)
    assert got.rep_scan_window == want.rep_scan_window == 8
    zero = ["--dereplication-scan-window", "0"]
    with pytest.raises(ValueError) as je:
        japi.generate_galah_clusterer(["x.fna"], _parse(japi, jd, zero), jd)
    with pytest.raises(ValueError, match="--dereplication-scan-window") \
            as te:
        tapi.generate_galah_clusterer(["x.fna"], _parse(tapi, td, zero), td,
                                      device="cpu")
    assert str(te.value) == str(je.value)


def test_cuda_without_a_gpu_raises(monkeypatch):
    """The API's device is cuda unless the caller asks for the CPU; with
    no GPU, cuda raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    values = _parse(tapi, tapi.ClustererCommandDefinition(), [])
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.generate_galah_clusterer(["x.fna"], values)


def test_missing_checkm_warning_emits_once_across_builds(caplog):
    """Three builds without a quality input warn once in each package;
    each records the two repeats it suppressed as events."""
    jevents.reset_warn_once()
    jevents.reset()
    tevents.reset_warn_once()
    tevents.reset()
    jv = _parse(japi, japi.ClustererCommandDefinition(), [])
    tv = _parse(tapi, tapi.ClustererCommandDefinition(), [])
    with caplog.at_level(logging.WARNING):
        for _ in range(3):
            japi.generate_galah_clusterer(["x.fna"], jv)
            tapi.generate_galah_clusterer(["x.fna"], tv, device="cpu")
    hits = [r for r in caplog.records
            if "Since CheckM input is missing" in r.getMessage()]
    assert sorted(r.name for r in hits) == ["galah_tpu.api",
                                            "galah_tpu_torch.quality"]
    suppressed = [e for e in jevents.snapshot()
                  if e["kind"] == "warn-once-suppressed"
                  and "Since CheckM" in e["message"]]
    assert len(suppressed) == 2
    t_suppressed = [e for e in tevents.snapshot()
                    if e["kind"] == "warn-once-suppressed"
                    and "Since CheckM" in e["message"]]
    assert ([e["message"] for e in t_suppressed]
            == [e["message"] for e in suppressed])
    jevents.reset_warn_once()
    tevents.reset_warn_once()


@pytest.mark.parametrize("argv,match", [
    (["--checkm-tab-table", "a.tsv", "--genome-info", "b.csv"],
     "at most one"),
    (["--checkm2-quality-report", "a.tsv", "--genome-info", "b.csv"],
     "at most one"),
])
def test_conflicting_quality_inputs_raise(argv, match):
    defn_j, defn_t = _definitions(False)
    with pytest.raises(ValueError, match=match) as je:
        japi.generate_galah_clusterer(["x.fna"], _parse(japi, defn_j, argv))
    with pytest.raises(ValueError, match=match) as te:
        tapi.generate_galah_clusterer(["x.fna"], _parse(tapi, defn_t, argv),
                                      device="cpu")
    assert str(te.value) == str(je.value)


def _quality_report(path, paths):
    """A CheckM2 report whose completeness falls with the input index,
    so quality order reverses each family's input order."""
    with open(path, "w") as fh:
        fh.write("Name\tCompleteness\tContamination\n")
        for i, p in enumerate(paths):
            name = p.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            fh.write(f"{name}\t{95 - i}\t{(i % 3) * 0.5}\n")
    return str(path)


@pytest.mark.parametrize("method,renamed", [
    ("skani", False), ("skani", True), ("finch", True), ("dashing", True),
])
def test_end_to_end_via_api(families, single_device, tmp_path, method,
                            renamed):
    """Embedding-style use: build from parsed (renamed) flags with a
    CheckM2 report and run; the genome order and the index clusters
    equal galah_tpu.api's, and the clusters are the planted families."""
    paths, labels = families
    jd, td = _definitions(renamed)
    report = _quality_report(tmp_path / "q.tsv", paths)
    argv = _flags(renamed, ani=97, precluster_ani=90,
                  precluster_method=method, min_aligned_fraction=20,
                  checkm2_quality_report=report)
    want_c = japi.generate_galah_clusterer(paths, _parse(japi, jd, argv), jd)
    got_c = tapi.generate_galah_clusterer(paths, _parse(tapi, td, argv), td,
                                          device="cpu")
    assert got_c.genome_paths == want_c.genome_paths
    assert got_c.genome_paths != paths  # the report reordered them
    got = got_c.cluster()
    assert got == want_c.cluster()
    fams = sorted(sorted(labels[paths.index(got_c.genome_paths[i])]
                         for i in c) for c in got)
    assert fams == sorted([[f] * 3 for f in range(4)])
    assert got_c.clock.seconds["quality"] > 0


def test_threads_parity_clusters(families, single_device):
    """--threads 3 gives the clusters of --threads 1, and galah_tpu's."""
    paths, _ = families
    values = {"ani": 95.0, "precluster_ani": 90.0,
              "min_aligned_fraction": 15.0, "fragment_length": 3000,
              "precluster_method": "finch", "cluster_method": "skani"}
    one = tapi.generate_galah_clusterer(paths, {**values, "threads": 1},
                                        device="cpu").cluster()
    many_c = tapi.generate_galah_clusterer(paths, {**values, "threads": 3},
                                           device="cpu")
    assert many_c.clusterer.store.threads == 3
    assert many_c.cluster() == one
    assert one == japi.generate_galah_clusterer(
        paths, {**values, "threads": 1}).cluster()


@pytest.mark.parametrize("pre", ["finch", "dashing", "skani"])
def test_degenerate_genomes_cluster_alone(tmp_path, single_device, pre):
    """All-N and shorter-than-k genomes land in singleton clusters on
    every precluster route, as in galah_tpu."""
    import numpy as np

    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=50_000))
    paths = []
    for name, s in [("normal", seq), ("allN", "N" * 5000),
                    ("short", "ACGTACGT")]:
        p = tmp_path / f"{name}.fna"
        p.write_text(f">c\n{s}\n")
        paths.append(str(p))
    values = {"ani": 95.0, "precluster_ani": 90.0,
              "min_aligned_fraction": 15.0, "fragment_length": 3000,
              "precluster_method": pre, "cluster_method": "skani",
              "threads": 1}
    got = tapi.generate_galah_clusterer(paths, values, device="cpu").cluster()
    assert sorted(sorted(c) for c in got) == [[0], [1], [2]]
    if pre != "dashing":  # galah_tpu's dashing variant is its slow tier
        assert got == japi.generate_galah_clusterer(paths, values).cluster()


def test_hash_algorithm_reaches_profile_store():
    """--hash-algorithm selects the profile hash too, and the profile
    cache key records it, as in galah_tpu."""
    jd, td = _definitions(False)
    argv = ["--hash-algorithm", "tpufast", "--precluster-method", "finch"]
    want = japi.generate_galah_clusterer(["a.fna", "b.fna"],
                                         _parse(japi, jd, argv))
    got = tapi.generate_galah_clusterer(["a.fna", "b.fna"],
                                        _parse(tapi, td, argv), device="cpu")
    assert got.clusterer.store.hash_algorithm == "tpufast"
    assert got.clusterer.store._params().get("hash_algorithm") == "tpufast"
    assert got.clusterer.store._params() == want.clusterer.store._params()
    assert got.preclusterer.store.algo == "tpufast"


def test_fingerprint_takes_backend_params(tmp_path):
    """The checkpoint fingerprint fields built from the API's
    backend_params equal galah_tpu's, with a renamed subsample flag."""
    from galah_tpu.cluster.checkpoint import fingerprint_fields as jfields

    jd, td = _definitions(True)
    argv = _flags(True, ani_subsample=16)
    want = japi.generate_galah_clusterer(["x.fna"], _parse(japi, jd, argv), jd)
    got = tapi.generate_galah_clusterer(["x.fna"], _parse(tapi, td, argv), td,
                                        device="cpu")
    assert got.backend_params["fragment"]["subsample_c"] == 16
    args = ("skani", "skani", 0.95, 0.9)
    tf = fingerprint_fields(got.genome_paths, *args,
                            backend_params=got.backend_params)
    jf = jfields(want.genome_paths, *args,
                 backend_params=want.backend_params)
    tf.pop("version")
    jf.pop("version")
    assert tf == jf


def test_api_import_loads_no_jax():
    """Importing the port's API in a fresh interpreter loads neither
    jax nor anything of galah_tpu."""
    code = ("import sys, galah_tpu_torch.api; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'galah_tpu.')) or m == 'galah_tpu']; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
