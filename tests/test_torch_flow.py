"""The port's flow tracing (galah_tpu_torch/obs/flow.py) against
galah_tpu's: the recorder on the same call sequences, the critical path
and its rendering on galah_tpu's own test snapshots and on seeded random
ones, and a CPU `cluster --precluster-method finch` run below the
crossover whose report's flow section `flow analyze` reads as
galah_tpu's functions do.

Tolerance: none for the recorder's counts, the critical path and its
rendering (equal dicts, equal lines); blame sums to the wall within
1e-9 s.
"""

import json
import logging
import subprocess
import sys

import numpy as np
import pytest

from galah_tpu.obs import flow as jflow
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.obs import flow as tflow
from test_torch_cluster import REPO, _families

STAGES = ("ingest", "sketch", "pairs", "greedy", "fragment")


def _starved(mod):
    """galah_tpu's tests/test_flow.py starved pipeline, on `mod`."""
    rec = mod.FlowRecorder(enabled=True)
    rec.record_service("ingest", 0.5, items=10)
    rec.record_service("sketch", 8.0, items=10)
    rec.record_wait("sketch", "upstream-empty", 0.5)
    rec.record_service("pairs", 0.6, items=10)
    rec.record_wait("pairs", "upstream-empty", 8.0)
    rec.record_wait("pairs", "device-dispatch", 0.4)
    rec.record_service("greedy", 0.5)
    rec.record_wait("greedy", "upstream-empty", 9.0)
    for _ in range(10):
        rec.emit("ingest", rec.begin("genome_batch"))
        rec.absorb("ingest", "sketch")
        rec.emit("sketch", rec.begin("sketch_block"))
        rec.absorb("sketch", "pairs")
        rec.emit("pairs", rec.begin("edge_stripe"))
        rec.absorb("pairs", "greedy")
    return rec


def _strip_queue_times(snap):
    """A snapshot without the hand-off latencies (host clock reads)."""
    out = json.loads(json.dumps(snap))
    for e in out["edges"]:
        e["queue"] = e["queue"]["count"]
    return out


def _random_snapshot(seed):
    """A seeded random flow graph: 2-5 stages, random services, waits
    (every reason, unknown ones folded into host) and hand-offs."""
    rng = np.random.default_rng(seed)
    stages = list(STAGES[:int(rng.integers(2, 6))])
    rec = jflow.FlowRecorder(enabled=True)
    for s in stages:
        for _ in range(int(rng.integers(0, 4))):
            rec.record_service(s, float(rng.exponential(2.0)),
                               items=int(rng.integers(0, 5)))
        for reason in (*jflow.BLOCKED_REASONS, "weird"):
            if rng.random() < 0.5:
                rec.record_wait(s, reason, float(rng.exponential(1.0)))
    for _ in range(int(rng.integers(1, 30))):
        a, b = rng.choice(len(stages), 2, replace=False)
        rec.emit(stages[a], rec.begin("genome_batch"))
        rec.absorb(stages[a], stages[b])
    return rec.snapshot()


@pytest.mark.parametrize("mod", [jflow, tflow], ids=["jax", "port"])
def test_recorder_counts_match_galah_tpu(mod):
    """The same call sequence gives galah_tpu's snapshot (but the
    hand-off latencies, which are host clock reads) and queue depths."""
    got = _starved(mod)
    want = _starved(jflow)
    assert _strip_queue_times(got.snapshot()) == \
        _strip_queue_times(want.snapshot())
    assert got.queue_depths() == want.queue_depths() == {}
    got.emit("pairs", got.begin("edge_stripe"))
    assert got.queue_depths() == {"pairs": 1}


@pytest.mark.parametrize("wall", [10.0, 3.5, 0.0])
def test_critical_path_equals_galah_tpu_on_its_snapshot(wall):
    snap = _starved(jflow).snapshot()
    got = tflow.critical_path(snap, wall)
    assert got == jflow.critical_path(snap, wall)
    assert tflow.render_critical_path(got) == \
        jflow.render_critical_path(got)
    if wall:
        assert got["bottleneck"] == "sketch"
        assert abs(sum(e["blame_s"] for e in got["stages"].values())
                   - wall) < 1e-5  # rounded to 6 places a stage


def test_critical_path_empty_snapshot_equals_galah_tpu():
    for snap in ({}, {"stages": {}}):
        got = tflow.critical_path(snap, 10.0)
        assert got == jflow.critical_path(snap, 10.0)
        assert tflow.render_critical_path(got) == \
            jflow.render_critical_path(got)


@pytest.mark.parametrize("seed", range(8))
def test_critical_path_equals_galah_tpu_on_random_snapshots(seed):
    snap = _random_snapshot(seed)
    wall = float(np.random.default_rng(100 + seed).uniform(0.5, 50.0))
    got = tflow.critical_path(snap, wall)
    assert got == jflow.critical_path(snap, wall)
    assert tflow.render_critical_path(got, indent="  ") == \
        jflow.render_critical_path(got, indent="  ")
    # conservation, to the rounding of 6 places a stage
    n = max(1, len(got["stages"]))
    assert abs(sum(e["blame_s"] for e in got["stages"].values()) - wall) \
        < 1e-6 * n


def test_blame_sums_to_the_wall_exactly_before_rounding(monkeypatch):
    """With rounding taken out, the decomposition conserves the wall to
    1e-9 s on every seeded snapshot."""
    monkeypatch.setattr(tflow, "round", lambda x, n=0: x, raising=False)
    for seed in range(8):
        snap = _random_snapshot(seed)
        cp = tflow.critical_path(snap, 7.25)
        assert abs(sum(e["blame_s"] for e in cp["stages"].values())
                   - 7.25) < 1e-9


def test_disabled_recorder_records_nothing_but_blocked_measures():
    rec = tflow.FlowRecorder(enabled=False)
    assert rec.begin("genome_batch") == 0
    rec.emit("ingest", 1)
    assert rec.absorb("ingest", "sketch") is None
    with rec.blocked("pairs", "upstream-empty") as b:
        pass
    assert b.seconds >= 0.0
    assert rec.snapshot()["stages"] == {} and rec.queue_depths() == {}


def test_waited_brackets_each_pull_as_upstream_empty(monkeypatch):
    monkeypatch.setattr(tflow, "GLOBAL", tflow.FlowRecorder(enabled=True))
    assert list(tflow.waited(iter([1, 2, 3]), "pairs")) == [1, 2, 3]
    st = tflow.snapshot()["stages"]["pairs"]
    assert st["wait"]["upstream-empty"]["count"] == 4  # 3 items + the end


def test_read_threads_adopt_the_submitters_flow_context(monkeypatch):
    from galah_tpu_torch.io.prefetch import iter_prefetched

    monkeypatch.setattr(tflow, "GLOBAL", tflow.FlowRecorder(enabled=True))
    with tflow.span("sketch", 7):
        got = list(iter_prefetched(["a", "b", "c"],
                                   lambda p: (p, tflow.current()), 2))
    assert [v for _, v in got] == [("a", ("sketch", 7)),
                                   ("b", ("sketch", 7)),
                                   ("c", ("sketch", 7))]


# -- a whole finch run -------------------------------------------------


@pytest.fixture(scope="module")
def finch_runs(tmp_path_factory):
    """The port's `cluster --precluster-method finch` on 24 genomes (the
    streamed pass, one stripe, on the overlapped engine), with
    GALAH_OBS_FLOW unset (on) and 0."""
    root = tmp_path_factory.mktemp("flowruns")
    paths, _ = _families(root, 7, 8, 3, 30_000, 0.02)
    out = {}
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    mp = pytest.MonkeyPatch()
    try:
        for flag in ("1", "0"):
            mp.setenv("GALAH_OBS_FLOW", flag)
            d = root / f"flow{flag}"
            d.mkdir()
            assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                              "--precluster-method", "finch",
                              "--run-report", str(d / "report.json"),
                              "--output-cluster-definition",
                              str(d / "c.tsv")]) == 0
            out[flag] = d
    finally:
        mp.undo()
        log.handlers[:] = handlers
        log.setLevel(level)
    return out


def test_finch_run_reports_ingest_sketch_pairs(finch_runs):
    """The overlapped route (finch's default below the crossover, as in
    galah_tpu): ingest -> sketch -> pairs -> greedy, with the engine's
    speculative fragment batches, one eager round and one stripe."""
    rep = json.loads((finch_runs["1"] / "report.json").read_text())
    assert rep["counters"]["overlap-engaged"] == 1
    flow = rep["flow"]
    stages = {"ingest", "sketch", "pairs", "greedy", "fragment"}
    assert set(flow["stages"]) == stages
    assert {(e["from"], e["to"]) for e in flow["edges"]} == \
        {("ingest", "sketch"), ("sketch", "pairs"), ("pairs", "greedy")}
    assert flow["stages"]["ingest"]["items"] == 24
    kinds = flow["flows"]["kinds"]
    assert kinds.pop("fragment_batch") >= 1
    assert kinds == {"genome_batch": 1, "sketch_block": 1,
                     "edge_stripe": 1, "greedy_round": 1}
    cp = flow["critical_path"]
    assert set(cp["stages"]) == stages
    assert abs(sum(e["blame_s"] for e in cp["stages"].values())
               - rep["run"]["duration_s"]) < 1e-4
    assert "device-dispatch" in flow["stages"]["pairs"]["wait_s"]


def test_flow_off_keeps_the_tsv_and_drops_the_section(finch_runs):
    on, off = finch_runs["1"], finch_runs["0"]
    assert (on / "c.tsv").read_bytes() == (off / "c.tsv").read_bytes()
    rep = json.loads((off / "report.json").read_text())
    assert "stages" not in (rep.get("flow") or {})
    assert rep["flags"]["GALAH_OBS_FLOW"]["value"] == "0"


@pytest.mark.parametrize("as_json", [False, True])
def test_flow_analyze_prints_galah_tpus_analysis(finch_runs, as_json,
                                                 capsys):
    path = str(finch_runs["1"] / "report.json")
    rep = json.loads(open(path).read())
    want_cp = jflow.critical_path(rep["flow"], rep["run"]["duration_s"])
    argv = ["flow", "analyze", path] + (["--json"] if as_json else [])
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    if as_json:
        assert json.loads(out) == want_cp
    else:
        assert out.splitlines() == jflow.render_critical_path(want_cp)


def test_flow_analyze_refuses_as_galah_tpu_does(finch_runs, tmp_path):
    """Exit 1 on a report with no flow stages or no report at all; exit
    2 on a usage error; no torch imported by the tool."""
    flowless = str(finch_runs["0"] / "report.json")
    for argv, rc in ((["flow", "analyze", flowless], 1),
                     (["flow", "analyze", str(tmp_path / "none.json")], 1),
                     (["flow"], 1), (["flow", "analyze"], 2)):
        code = ("import sys\n"
                "from galah_tpu_torch.cli import main\n"
                "try:\n"
                f"    rc = main({argv!r})\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "assert 'torch' not in sys.modules, 'torch was imported'\n"
                "sys.exit(rc)\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True)
        assert proc.returncode == rc, (argv, proc.stderr[-2000:])
