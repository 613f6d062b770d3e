"""The port's run reports, traces and heartbeats against galah_tpu's, on
the same files through both command lines.

The reports cross over both ways: each package's ``validate`` accepts
the other's, its ``render`` renders it and its ``diff`` compares the
two; ``galah-tpu report`` reads the port's and ``galah_tpu_torch
report`` galah_tpu's. On the same inputs the funnel (possible,
screened and kept pairs; exact ANIs computed and wasted), the cache
hits and misses, the quarantined genomes and their events, and the
index section are equal.

The screen routes compared: both packages count the screen's funnel
on their collision routes only (``galah_tpu`` counts
``screen-candidates`` on its collision routes and nowhere else), so
the skani and finch runs take them, with each package's
``collision.SPARSE_SCREEN_MIN_N`` at 0 and galah_tpu's HLL
cardinality bucketing and ingest prefilter (neither ported) off; the
dashing route counts no
screen in either package and is compared for its exact ANIs.
galah_tpu's HLL pass is pinned to its single-device form, as in
tests/test_torch_dashing.py.

Tolerance: none — counts, events (but for their timestamps), index
sections and TSV bytes are equal.
"""

import io
import json
import logging
import pathlib
from contextlib import redirect_stdout

import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.obs import events as jevents
from galah_tpu.obs import heartbeat as jheartbeat
from galah_tpu.obs import report as jreport
from galah_tpu.ops import collision as jcollision
from galah_tpu.ops import hll as jhll
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.obs import events as tevents
from galah_tpu_torch.obs import report as treport
from galah_tpu_torch.ops import collision as tcollision
from galah_tpu_torch.resilience import interrupt as tinterrupt

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

METHODS = {
    "skani": [],
    "finch": ["--precluster-method", "finch", "--cluster-method", "skani"],
    "dashing": ["--precluster-method", "dashing", "--cluster-method",
                "skani"],
}
FUNNEL = ("possible_pairs", "screened_candidates", "kept_pairs",
          "exact_ani_computed", "exact_ani_wasted")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 families x 3 members, 40 kb, ~1% divergence, and an empty
    genome and a text file for the quarantine."""
    root = tmp_path_factory.mktemp("report_corpus")
    paths, _ = _families(root, 11, 3, 3, 40_000, 0.01)
    empty = root / "empty.fna"
    empty.write_text("")
    text = root / "text.fna"
    text.write_text("not a fasta file\n")
    return paths, [str(empty), str(text)]


def _ported_routes(mp):
    """Both packages' collision routes at any size, with the HLL
    cardinality bucketing (which would engage from the crossover) and
    the ingest prefilter off in both: their own figures are compared in
    tests/test_torch_tiered.py."""
    mp.setattr(jcollision, "SPARSE_SCREEN_MIN_N", 0)
    mp.setattr(tcollision, "SPARSE_SCREEN_MIN_N", 0)
    mp.setenv("GALAH_TPU_HLL_BUCKETS", "0")
    mp.setenv("GALAH_TPU_PREFILTER", "0")


def _pinned_hll(orig):
    def pinned(regs_mat, k, min_ani, **kw):
        return orig(regs_mat, k=k, min_ani=min_ani, use_pallas=False, **kw)
    return pinned


def _both(root, name, argv, port_extra=()):
    """The `cluster` command line `argv` through galah_tpu's main and
    the port's, each with its own outputs, run report and trace under
    root/<name>/<side>; returns {side: directory}. The root logger,
    which main replaces, is put back after."""
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    out = {}
    try:
        for side, main, extra in (("jax", jmain, []),
                                  ("port", tcli.main,
                                   ["--device", "cpu", *port_extra])):
            d = pathlib.Path(root) / name / side
            d.mkdir(parents=True)
            full = [*argv, *extra, "--run-report", str(d / "report.json"),
                    "--trace-events", str(d / "trace.json"),
                    "--output-cluster-definition", str(d / "clusters.tsv")]
            assert main(full) == 0, (side, full)
            out[side] = d
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    return out


def _load(d):
    with open(d / "report.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Each method's cluster run in both packages, on the collision
    routes; {method: {side: directory}}."""
    paths, _ = corpus
    root = tmp_path_factory.mktemp("report_runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _ported_routes(mp)
        mp.setattr(jhll, "hll_threshold_pairs",
                   _pinned_hll(jhll.hll_threshold_pairs))
        for method, extra in METHODS.items():
            out[method] = _both(root, method, ["cluster", "-f", *paths,
                                               "--ani", "95", *extra])
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_funnel_equals_galah_tpu(runs, method):
    got, want = (_load(runs[method][s]) for s in ("port", "jax"))
    assert (runs[method]["port"] / "clusters.tsv").read_bytes() == \
        (runs[method]["jax"] / "clusters.tsv").read_bytes()
    assert {k: got["funnel"][k] for k in FUNNEL} == \
        {k: want["funnel"][k] for k in FUNNEL}
    for key in ("exact-ani-wasted-rep", "exact-ani-wasted-membership",
                "exact-ani-wasted-warm"):
        assert got["counters"].get(key) == want["counters"].get(key)
    assert got["metrics"]["ani.exact_computed"] == \
        want["metrics"]["ani.exact_computed"]
    if method == "skani":  # the precluster's ANIs are reused
        assert got["funnel"]["exact_ani_computed"] == 0
        assert got["funnel"]["kept_pairs"] > 0
    elif method == "finch":
        assert got["funnel"]["exact_ani_computed"] > 0
        assert got["funnel"]["possible_pairs"] == 9 * 8 // 2
    else:
        assert got["funnel"]["exact_ani_computed"] > 0


@pytest.mark.parametrize("method", list(METHODS))
def test_reports_validate_and_render_both_ways(runs, method):
    got, want = (_load(runs[method][s]) for s in ("port", "jax"))
    for validate in (jreport.validate, treport.validate):
        assert validate(got) == []
        assert validate(want) == []
    for render in (jreport.render, treport.render):
        page = render(got)
        assert "precluster funnel:" in page
        assert f"kept pairs:         {got['funnel']['kept_pairs']}" in page
        assert render(want)
    # galah_tpu's page, less the flow critical path it draws through
    # obs/flow.py, which the port lacks
    lines = iter(jreport.render(want).splitlines())
    assert all(line in lines for line in treport.render(want).splitlines())
    assert got["kind"] == "galah-tpu-run-report"
    assert got["device"]["backend"] == "cpu"
    assert got["device"]["jax_version"] is None
    assert got["run"]["subcommand"] == "cluster"
    names = {n["name"] for n in got["stages"]["tree"]}
    assert {"greedy", "write-outputs"} <= names


@pytest.mark.parametrize("method", list(METHODS))
def test_reports_diff_both_ways(runs, method):
    got, want = (_load(runs[method][s]) for s in ("port", "jax"))
    for diff in (jreport.diff, treport.diff):
        for a, b in ((got, want), (want, got)):
            text = diff(a, b, label_a="A", label_b="B")
            # counters and funnel line up; stage rows do not (the port
            # names its stages its own way)
            for key in FUNNEL:
                assert f"  {key}: {a['funnel'][key]} -> " \
                    f"{b['funnel'][key]} (+0)" in text
            assert "[only in" in text
    assert treport.diff(got, want) == jreport.diff(got, want)


@pytest.mark.parametrize("method", list(METHODS))
def test_traces_load_with_a_span_for_each_stage(runs, method):
    rep = _load(runs[method]["port"])
    with open(runs[method]["port"] / "trace.json") as fh:
        events = json.load(fh)
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "stage":
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1

    def walk(nodes, acc):
        for n in nodes:
            acc[n["name"]] = acc.get(n["name"], 0) + n["count"]
            walk(n["children"], acc)
        return acc

    assert spans == walk(rep["stages"]["tree"], {})
    assert not [ev for ev in events if ev.get("cat") == "nvcc"]


def test_cache_counts_equal_galah_tpu(corpus, tmp_path):
    """--sketch-cache, cold then warm, on the finch route: the reports'
    cache hits and misses are galah_tpu's."""
    paths, _ = corpus
    caches = {side: tmp_path / f"cache-{side}" for side in ("jax", "port")}
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        _ported_routes(mp)
        for run in ("cold", "warm"):
            log = logging.getLogger()
            handlers, level = log.handlers[:], log.level
            try:
                for side, main, extra in (
                        ("jax", jmain, []),
                        ("port", tcli.main, ["--device", "cpu"])):
                    rep = tmp_path / f"{run}-{side}.json"
                    assert main(["cluster", "-f", *paths, *METHODS["finch"],
                                 "--sketch-cache", str(caches[side]),
                                 "--run-report", str(rep), *extra]) == 0
                    with open(rep) as fh:
                        got[run, side] = json.load(fh)["funnel"]["cache"]
            finally:
                log.handlers[:] = handlers
                log.setLevel(level)
    for run in ("cold", "warm"):
        assert got[run, "port"] == got[run, "jax"], run
    assert got["cold", "port"]["hits"] == 0
    assert got["warm", "port"]["misses"] == 0
    assert got["warm", "port"]["hit_rate"] == 1.0


def test_quarantine_equals_galah_tpu(corpus, tmp_path):
    """--on-bad-genome skip: the quarantined genomes and their events
    are galah_tpu's."""
    paths, bad = corpus
    with pytest.MonkeyPatch.context() as mp:
        _ported_routes(mp)
        dirs = _both(tmp_path, "skip", ["cluster", "-f", *paths[:4], *bad,
                                        "--on-bad-genome", "skip"])
    got, want = (_load(dirs[s]) for s in ("port", "jax"))

    def quarantined(rep):
        return [{k: v for k, v in ev.items() if k != "time"}
                for ev in rep["events"] if ev["kind"] == "quarantine"]

    assert got["resilience"]["quarantined_genomes"] == \
        want["resilience"]["quarantined_genomes"] == 2
    assert quarantined(got) == quarantined(want)
    assert [ev["genome"] for ev in quarantined(got)] == bad


def test_index_sections_equal_galah_tpu(corpus, tmp_path):
    """index build, then insert, through both command lines: the index
    sections (and gauges) of the two reports are galah_tpu's, and their
    events (each package's warn-once state cleared first: it is
    process-scoped)."""
    paths, _ = corpus
    jevents.reset_warn_once()
    tevents.reset_warn_once()
    with pytest.MonkeyPatch.context() as mp:
        _ported_routes(mp)
        for action, genomes in (("build", paths[:6]),
                                ("insert", paths[6:])):
            idx = {side: tmp_path / f"idx-{side}"
                   for side in ("jax", "port")}
            dirs = {}
            log = logging.getLogger()
            handlers, level = log.handlers[:], log.level
            try:
                for side, main, extra in (("jax", jmain, []),
                                          ("port", tcli.main,
                                           ["--device", "cpu"])):
                    d = tmp_path / action / side
                    d.mkdir(parents=True)
                    assert main(["index", "--index-dir", str(idx[side]),
                                 "--run-report", str(d / "report.json"),
                                 *extra, action, "-f", *genomes]) == 0
                    dirs[side] = d
            finally:
                log.handlers[:] = handlers
                log.setLevel(level)
            got, want = (_load(dirs[s]) for s in ("port", "jax"))
            assert got["index"] == want["index"], action
            assert got["index"]["op"] == action
            for gauge in ("index.generation", "index.genomes",
                          "index.clusters"):
                assert got["metrics"][gauge]["value"] == \
                    want["metrics"][gauge]["value"]
            assert got["run"]["subcommand"] == "index"
            # (the warning's logger is each package's own)
            events = [[{k: v for k, v in e.items()
                        if k not in ("time", "logger")}
                       for e in rep["events"]] for rep in (got, want)]
            assert events[0] == events[1]
            assert [e["kind"] for e in events[0]].count(
                "index-quality-fallback") == 1


def test_preempted_run_writes_its_report_and_trace(corpus, tmp_path,
                                                   monkeypatch):
    """A stop requested at a greedy round's boundary: exit 75, a report
    that says so with a `preempted` event, and a trace that loads."""
    from galah_tpu_torch.cluster import checkpoint as tcheckpoint

    paths, _ = corpus
    real = tcheckpoint.ClusterCheckpoint.save_greedy_round

    def save_then_stop(self, *a, **kw):
        real(self, *a, **kw)
        tinterrupt.request_stop()

    monkeypatch.setattr(tcheckpoint.ClusterCheckpoint, "save_greedy_round",
                        save_then_stop)
    rep, trace = tmp_path / "report.json", tmp_path / "trace.json"
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        rc = tcli.main(["cluster", "-f", *paths, *METHODS["finch"],
                        "--device", "cpu", "--rep-rounds", "2",
                        "--checkpoint-dir", str(tmp_path / "ck"),
                        "--output-cluster-definition",
                        str(tmp_path / "c.tsv"), "--run-report", str(rep),
                        "--trace-events", str(trace)])
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    assert rc == tinterrupt.EXIT_PREEMPTED == 75
    with open(rep) as fh:
        got = json.load(fh)
    assert jreport.validate(got) == []
    assert got["preemption"]["stop_requested"] is True
    assert got["preemption"]["boundary"] == "greedy-round-saved"
    (ev,) = [e for e in got["events"] if e["kind"] == "preempted"]
    assert ev["boundary"] == "greedy-round-saved"
    with open(trace) as fh:
        events = json.load(fh)
    assert any(e.get("name") == "preempted" and e.get("ph") == "i"
               for e in events)
    assert not (tmp_path / "c.tsv").read_bytes()


def test_heartbeat_reads_with_galah_tpu(corpus, tmp_path, monkeypatch):
    """GALAH_OBS_HEARTBEAT_S on a cluster run: heartbeat.jsonl beside
    the report, read by galah_tpu's read_latest_beat; its final beat is
    the report's last, and the report carries the RSS series."""
    paths, _ = corpus
    monkeypatch.setenv("GALAH_OBS_HEARTBEAT_S", "0.05")
    d = tmp_path / "hb"
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        assert tcli.main(["cluster", "-f", *paths[:6], "--device", "cpu",
                          "--run-report", str(d / "report.json")]) == 0
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    latest = jheartbeat.read_latest_beat(str(d))
    rep = _load(d)
    hb = rep["flow"]["heartbeat"]
    assert latest is not None and latest["beat"] == hb["beats"] >= 1
    assert hb["period_s"] == 0.05
    assert rep["memory"]["rss_mb"]["samples"] == hb["beats"]
    assert jreport.validate(rep) == []


def test_report_subcommand_renders_diffs_and_refuses(runs, tmp_path,
                                                     capsys):
    port = str(runs["finch"]["port"] / "report.json")
    jax = str(runs["finch"]["jax"] / "report.json")
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        assert tcli.main(["report", port, jax]) == 0
        out = capsys.readouterr().out
        assert out == (treport.render(_load(runs["finch"]["port"])) + "\n"
                       + treport.render(_load(runs["finch"]["jax"])))
        assert tcli.main(["report", "--diff", port, jax]) == 0
        assert capsys.readouterr().out.startswith(
            f"run report diff: {port} -> {jax}")
        # galah-tpu's own subcommand reads the port's report
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert jmain(["report", port]) == 0
        assert buf.getvalue() == treport.render(_load(runs["finch"]["port"]))
        bad = tmp_path / "bad.json"
        broken = _load(runs["finch"]["port"])
        del broken["funnel"]
        bad.write_text(json.dumps(broken))
        assert tcli.main(["report", str(bad)]) == 1
        (tmp_path / "junk.json").write_text("{not json")
        assert tcli.main(["report", str(tmp_path / "junk.json")]) == 1
        assert tcli.main(["report", str(tmp_path / "none.json")]) == 1
        assert tcli.main(["report", "--diff", port]) == 1
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)


@pytest.mark.parametrize("sub", ["cluster", "index", "report"])
def test_full_help_renders_the_observability_flags(sub):
    """--full-help shows --run-report and --trace-events under
    OBSERVABILITY; the report subcommand's page is galah_tpu's
    (rendered from the port's parser) but for the ENVIRONMENT
    section."""
    from galah_tpu import manpage as jmanpage
    from galah_tpu_torch import manpage as tmanpage

    parser = tcli.build_parser().subcommand_parsers[sub]
    page = tmanpage.render_full_help(parser, sub)
    if sub == "report":
        want = jmanpage.render_full_help(parser, sub)
        t_env = tmanpage.render_environment_section()
        j_env = jmanpage.render_environment_section()
        assert page.split(t_env) == want.split(j_env)
        assert "REPORT CONTENTS" in page and "--diff" in page
        return
    section = page.split("OBSERVABILITY", 1)[1].split("\n\n", 2)[1]
    assert "--run-report" in section and "--trace-events" in section
    assert "GALAH_OBS_REPORT" in page and "GALAH_OBS_HEARTBEAT_S" in page
