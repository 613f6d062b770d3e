"""The port's telemetry units against galah_tpu/obs on the same call
sequences: the metrics registry, events and warn-once, the Chrome trace
recorder, the heartbeat, the StageClock's stage tree and dispatch
counters, the flag snapshot, the crash hooks and the nvcc build span.

Tolerance: none. Snapshots, trees (names, counts, nesting), trace
events (but for timestamps, thread and process ids) and beat records
(but for their clocks and RSS) are equal.
"""

import json
import logging
import os
import stat
import sys
import threading

import pytest
import torch

from galah_tpu.obs import events as jevents
from galah_tpu.obs import flow as jflow
from galah_tpu.obs import heartbeat as jheartbeat
from galah_tpu.obs import ledger as jledger
from galah_tpu.obs import metrics as jmetrics
from galah_tpu.obs import report as jreport
from galah_tpu.obs import trace as jtrace
from galah_tpu.utils.timing import StageTimer
from galah_tpu_torch import config as tconfig
from galah_tpu_torch import kernels
from galah_tpu_torch import obs as tobs
from galah_tpu_torch.kernels import build as kbuild
from galah_tpu_torch.obs import events as tevents
from galah_tpu_torch.obs import flow as tflow
from galah_tpu_torch.obs import heartbeat as theartbeat
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.obs import report as treport
from galah_tpu_torch.obs import trace as ttrace
from galah_tpu_torch.resilience import interrupt as tinterrupt
from galah_tpu_torch.timing import StageClock

CPU = torch.device("cpu")


@pytest.fixture
def fresh():
    """Both packages' registries, events and sinks (and both flow
    registries, which the heartbeats read) empty before and after the
    test."""
    def clear():
        for mod in (jmetrics, tmetrics, jevents, tevents, jflow, tflow):
            mod.reset()
        for mod in (jevents, tevents):
            mod.reset_warn_once()
        for mod in (jtrace, ttrace):
            mod.stop()
        for mod in (jheartbeat, theartbeat):
            mod.reset()
    clear()
    yield
    clear()


# -- metrics --------------------------------------------------------------

def _metric_calls(m):
    m.counter("cache.hits", help="hits").inc()
    m.counter("cache.hits").inc(4)
    m.gauge("index.generation", unit="generation").set(3.0)
    h = m.histogram("batch.seconds", unit="s")
    for v in (0.5, 2.0, float("nan"), 1.0):
        h.observe(v)
    m.pipeline_occupancy(1.7, stage="sketch")
    m.pipeline_occupancy(-0.2)


def test_metrics_snapshot_matches_galah_tpu(fresh):
    _metric_calls(jmetrics)
    _metric_calls(tmetrics)
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert tmetrics.snapshot()["batch.seconds"]["count"] == 3
    tmetrics.reset()
    assert tmetrics.snapshot() == {}


@pytest.mark.parametrize("misuse,error", [
    (lambda m: m.counter("x").inc(-1), ValueError),
    (lambda m: (m.counter("x"), m.gauge("x")), TypeError),
])
def test_metrics_refusals_match_galah_tpu(fresh, misuse, error):
    with pytest.raises(error):
        misuse(jmetrics)
    with pytest.raises(error):
        misuse(tmetrics)


def test_metrics_emission_is_thread_safe(fresh):
    """8 threads x 2000 increments under a short switch interval lose
    no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        c = tmetrics.counter("work")
        threads = [threading.Thread(
            target=lambda: [c.inc() for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tmetrics.snapshot()["work"]["value"] == 16000


# -- events ---------------------------------------------------------------

def _strip_time(rows):
    return [{k: v for k, v in r.items() if k != "time"} for r in rows]


def test_events_and_warn_once_match_galah_tpu(fresh, caplog):
    log = logging.getLogger("obs.test")
    for mod in (jevents, tevents):
        mod.record("quarantine", genome="a.fna", reason="empty",
                   detail="no FASTA records")
        for _ in range(3):
            mod.warn_once(log, "missing %s", "checkm", key="k")
        mod.warn_once(log, "other")
    assert _strip_time(tevents.snapshot()) == _strip_time(
        jevents.snapshot())
    kinds = [r["kind"] for r in tevents.snapshot()]
    assert kinds == ["quarantine", "warn-once-suppressed",
                     "warn-once-suppressed"]
    assert [r.getMessage() for r in caplog.records] == [
        "missing checkm", "other", "missing checkm", "other"]
    tevents.reset()
    assert tevents.snapshot() == []


# -- trace ----------------------------------------------------------------

def _trace_events(path):
    with open(path) as fh:
        events = json.load(fh)
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        if ev.get("ph") == "M":
            ev.pop("args")  # the process's name names the package
        out.append(ev)
    return out


def _trace_calls(trace_mod, events_mod):
    trace_mod.emit_complete("sketch", 0.0, 0.25, cat="stage",
                            args={"n": 3})
    trace_mod.emit_instant("marker", cat="event")
    trace_mod.emit_flow("s", "item", 7)
    trace_mod.emit_flow("f", "item", 7)
    events_mod.record("preempted", signal="SIGTERM", boundary="b")


def test_trace_file_matches_galah_tpu(fresh, tmp_path):
    for name, (trace_mod, events_mod) in {
            "jax": (jtrace, jevents), "port": (ttrace, tevents)}.items():
        trace_mod.start(str(tmp_path / f"{name}.json"))
        assert trace_mod.active()
        _trace_calls(trace_mod, events_mod)
        trace_mod.stop()
        trace_mod.stop()  # idempotent
        assert not trace_mod.active()
    got = _trace_events(tmp_path / "port.json")
    assert got == _trace_events(tmp_path / "jax.json")
    assert [e.get("ph") for e in got] == ["M", "X", "i", "s", "f", "i",
                                          None]


def test_trace_emission_without_a_recorder_is_a_no_op(fresh):
    _trace_calls(ttrace, tevents)
    assert not ttrace.active()


# -- the stage clock --------------------------------------------------------

def _nest(stage):
    with stage("a"):
        with stage("b"):
            pass
        with stage("b"):
            pass
        with stage("c"):
            with stage("b"):
                pass
    with stage("a"):
        pass
    with stage("d"):
        with stage("e"):
            pass


def _shape(tree):
    return [(n["name"], n["count"], _shape(n["children"])) for n in tree]


def test_stage_tree_matches_stage_timer_tree():
    timer, clock = StageTimer(), StageClock(CPU)
    _nest(timer.stage)
    _nest(clock.stage)
    want = timer.tree()
    got = clock.tree()
    assert _shape(got) == _shape(want)
    assert _shape(got) == [("a", 2, [("b", 2, []),
                                     ("c", 1, [("b", 1, [])])]),
                           ("d", 1, [("e", 1, [])])]
    # inclusive totals in the tree, exclusive seconds as before
    a = got[0]
    assert a["total_s"] >= sum(ch["total_s"] for ch in a["children"])
    assert sorted(clock.seconds) == ["a", "b", "c", "d", "e"]
    assert sum(clock.seconds.values()) == pytest.approx(
        sum(n["total_s"] for n in got), abs=1e-5)
    assert clock.elapsed() >= sum(n["total_s"] for n in got) - 1e-5


def test_stage_tree_of_a_stage_left_by_an_exception():
    clock = StageClock(CPU)
    with pytest.raises(RuntimeError):
        with clock.stage("outer"):
            with clock.stage("inner"):
                raise RuntimeError("stop")
    assert _shape(clock.tree()) == [("outer", 1, [("inner", 1, [])])]
    with clock.stage("next"):
        pass
    assert [n["name"] for n in clock.tree()] == ["outer", "next"]


def test_stages_and_reads_are_trace_spans(fresh, tmp_path):
    """A closed stage is an "X" span of category stage on the calling
    thread; a timed read on a worker thread is one of category work on
    that thread's id."""
    path = tmp_path / "t.json"
    ttrace.start(str(path))
    clock = StageClock(CPU)
    _nest(clock.stage)
    read = clock.timed(lambda x: x + 1, "read")
    got = []
    worker = threading.Thread(target=lambda: got.append(read(1)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and got == [2]
    ttrace.stop()
    with open(path) as fh:
        spans = [e for e in json.load(fh) if e.get("ph") == "X"]
    stage_spans = [e["name"] for e in spans if e["cat"] == "stage"]
    assert sorted(stage_spans) == sorted(
        ["b", "b", "b", "c", "a", "a", "e", "d"])
    (work,) = [e for e in spans if e["cat"] == "work"]
    assert work["name"] == "read"
    assert work["tid"] == worker.ident & 0xFFFFFFFF
    assert work["tid"] != threading.get_ident() & 0xFFFFFFFF
    assert clock.work_seconds["read"] > 0


def test_clock_dispatch_counters_are_launch_deltas(monkeypatch):
    """disp[<kernel>] counts the launches since the clock was made,
    and galah_tpu's splitter files them under the report's dispatch
    section."""
    monkeypatch.setattr(kernels, "LAUNCHES",
                        {name: 5 for name in kernels.KERNELS})
    clock = StageClock(CPU)
    clock.count("screen-kept-pairs", 4)
    kernels.LAUNCHES["window_hits"] += 3
    kernels.LAUNCHES["pairlist"] += 1
    counters = clock.counters()
    assert counters == {"screen-kept-pairs": 4, "disp[window_hits]": 3,
                        "disp[pairlist]": 1}
    assert dict(clock.counts) == {"screen-kept-pairs": 4}
    want = jreport._split_dispatch_counters(counters)
    assert treport._split_dispatch_counters(counters) == want
    assert want == ({"window_hits": 3, "pairlist": 1}, {})


# -- heartbeat ------------------------------------------------------------

_BEAT_CLOCKS = ("ts", "uptime_s", "rss_mb")


def _beat_metrics(m):
    m.counter("ani.exact_computed").inc(6)
    m.gauge("index.genomes").set(12.0)
    m.pipeline_occupancy(0.75, stage="sketch")


def test_heartbeat_record_matches_galah_tpu(fresh, tmp_path):
    _beat_metrics(jmetrics)
    _beat_metrics(tmetrics)
    beats = {}
    for name, mod in (("jax", jheartbeat), ("port", theartbeat)):
        d = str(tmp_path / name)
        hb = mod.Heartbeat(d, period_s=3600.0)
        hb.beat()
        hb.stop()  # no thread started: the final beat only
        records, torn = mod.load(d)
        assert torn == 0 and [r["beat"] for r in records] == [1, 2]
        beats[name] = [{k: v for k, v in r.items() if k not in _BEAT_CLOCKS}
                       for r in records]
        assert hb.snapshot()["beats"] == 2
    assert beats["port"] == beats["jax"]
    assert beats["port"][0]["occupancy"] == {"sketch": 0.75}


def test_heartbeat_thread_reads_with_galah_tpu(fresh, tmp_path,
                                               monkeypatch):
    """GALAH_OBS_HEARTBEAT_S starts the thread beside the report; its
    beats, and the final one at stop, read with galah_tpu's
    read_latest_beat; the thread touches no CUDA call."""
    def no_cuda(*a, **kw):
        raise AssertionError("the heartbeat called torch.cuda")

    for name in ("synchronize", "memory_allocated", "max_memory_allocated",
                 "is_initialized", "device_count", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setenv("GALAH_OBS_HEARTBEAT_S", "0.05")
    tmetrics.counter("work").inc(2)
    hb = theartbeat.maybe_start(str(tmp_path / "run" / "report.json"))
    assert hb is not None and theartbeat.active()
    seen = threading.Event()
    for _ in range(400):
        if seen.wait(0.05):
            break
        if hb.snapshot()["beats"] >= 2:
            seen.set()
    assert seen.is_set()
    theartbeat.stop()
    theartbeat.stop()  # one final beat however many stops
    beats, torn = theartbeat.load(str(tmp_path / "run"))
    assert torn == 0 and len(beats) >= 3
    latest = jheartbeat.read_latest_beat(str(tmp_path / "run"))
    assert latest == beats[-1]
    assert latest["beat"] == hb.snapshot()["beats"] == len(beats)
    assert latest["counters"] == {"work": 2}
    assert latest["queue_depths"] == {} and latest["flow_items"] == {}


@pytest.mark.parametrize("value,started", [("0", False), ("", False),
                                           ("soon", False), ("1", True)])
def test_heartbeat_flag(fresh, tmp_path, monkeypatch, value, started):
    monkeypatch.setenv("GALAH_OBS_HEARTBEAT_S", value)
    assert (theartbeat.maybe_start(str(tmp_path / "r.json"))
            is not None) == started
    theartbeat.reset()


# -- flags, schema, lifecycle -------------------------------------------

def test_flag_snapshot_shares_galah_tpu_flags(monkeypatch):
    """Every flag the port registers is one of galah_tpu's, in the same
    section, with the same default, and snapshots the same way."""
    monkeypatch.setenv("GALAH_OBS_HEARTBEAT_S", "0.25")
    monkeypatch.setenv("GALAH_IO_RETRY_SEED", "9")
    monkeypatch.delenv("GALAH_TPU_CACHE", raising=False)
    got = treport.flag_snapshot()
    want = jreport.flag_snapshot()
    assert set(got) == set(tconfig.FLAGS)
    assert {"GALAH_FI", "GALAH_TPU_CACHE", "GALAH_TPU_INDEX_DIR",
            "GALAH_OBS_REPORT", "GALAH_OBS_TRACE_EVENTS",
            "GALAH_OBS_HEARTBEAT_S", "GALAH_IO_RETRY_SEED"} <= set(got)
    for name, snap in got.items():
        assert snap == want[name], name
    assert got["GALAH_OBS_HEARTBEAT_S"]["value"] == "0.25"
    assert got["GALAH_OBS_HEARTBEAT_S"]["set"] is True
    # a flag of galah_tpu's that the port does not read (its lint's IR
    # cache; GALAH_TPU_PLATFORM, once this example, is read now)
    with pytest.raises(KeyError):
        # galah-lint: ignore[GL401] the read must raise: not registered
        tconfig.env_value("GALAH_TPU_IR_CACHE")


def test_schema_is_galah_tpus():
    with open(treport.SCHEMA_PATH, "rb") as a, \
            open(jreport.SCHEMA_PATH, "rb") as b:
        assert a.read() == b.read()
    assert treport.REPORT_VERSION == jreport.REPORT_VERSION


def test_finalize_never_fails_the_run(fresh, monkeypatch, caplog,
                                      tmp_path):
    """An assembly failure logs a warning, returns None and still
    closes the trace; without a report path or a ledger no report is
    built; with GALAH_OBS_LEDGER set the report is built and its entry
    appended, with no warning."""
    ttrace.start(str(tmp_path / "t.json"))

    def broken(*a, **kw):
        raise RuntimeError("assembly bug")

    monkeypatch.setattr(treport, "assemble", broken)
    with caplog.at_level(logging.WARNING):
        assert tobs.finalize("cluster", None,
                             report_path=str(tmp_path / "x.json")) is None
    assert not ttrace.active()
    assert "run report assembly failed" in caplog.text
    assert not os.path.exists(tmp_path / "x.json")
    # no report asked for: none is built
    monkeypatch.setattr(treport, "assemble", broken)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tobs.finalize("cluster", StageClock(CPU)) is None
    assert caplog.text == ""
    monkeypatch.undo()
    monkeypatch.setenv("GALAH_OBS_LEDGER", str(tmp_path / "ledger"))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        rep = tobs.finalize("cluster", StageClock(CPU),
                            report_path=str(tmp_path / "r.json"))
    assert jreport.validate(rep) == []
    assert caplog.text == ""
    entries, torn = jledger.read(str(tmp_path / "ledger"))
    assert torn == 0 and len(entries) == 1
    assert entries[0]["key"]["source"] == "cluster"


def test_crash_hooks_register_the_heartbeat_flush():
    tobs.install_crash_hooks()
    tobs.install_crash_hooks()
    assert tinterrupt._FLUSH_HOOKS.count(theartbeat.flush) == 1
    assert tobs._CRASH_HOOKS["installed"]


def test_a_kernel_build_is_an_nvcc_span(fresh, tmp_path, monkeypatch):
    """Each nvcc run of kernels/build.py is a trace span of category
    nvcc, with a stand-in compiler that writes its -o file; a library
    already built is no span."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kbuild, "_lib_path",
                        lambda name: str(tmp_path / "build" / f"{name}.so"))
    path = tmp_path / "t.json"
    ttrace.start(str(path))
    kbuild.build(["window_hits", "pairlist"])
    kbuild.build(["window_hits"])
    ttrace.stop()
    with open(path) as fh:
        spans = [e for e in json.load(fh) if e.get("cat") == "nvcc"]
    assert sorted(e["name"] for e in spans) == ["nvcc pairlist.cu",
                                                "nvcc window_hits.cu"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
