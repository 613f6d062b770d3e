"""GalahSan on the port: galah_tpu's deterministic two-thread
reproducers for every finding kind, run against both packages'
``Sanitizer`` on the same toy modules (the same kinds, counts and
summaries); the report and summary shapes; the gate that the port's
threaded modules run violation-free under a threaded CPU workload;
and sanitized CLI runs: the run report's ``sanitizer`` section (read
by both packages' ``report``), the standalone report, and the
``workload.pipeline_occupancy`` gauges a finch run reports beside
galah_tpu's.

Tolerance: none. Finding kinds, counts and summaries are equal
between the packages; the gate's error list is empty.
"""

import json
import logging
import os
import pathlib
import subprocess
import sys
import threading
import types

import pytest
import torch

from galah_tpu.analysis import sanitizer as jsan
from galah_tpu.cli import main as jmain
from galah_tpu.obs import report as jreport
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.analysis import sanitizer as tsan
from galah_tpu_torch.analysis.concurrency_check import THREADED_MODULES
from galah_tpu_torch.obs import report as treport

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
HERE = "tests/test_torch_sanitizer.py:"
PACKAGES = {"galah_tpu": jsan, "port": tsan}


def make_module(name="synth_mod", **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def errors_by_kind(san):
    out = {}
    for f in san.errors():
        out.setdefault(f["kind"], []).append(f)
    return out


def _shape(san):
    """What both packages must agree on: each finding's kind, locks,
    severity and count, and the summary."""
    return (sorted((f["kind"], tuple(f["locks"]), f["severity"],
                    f.get("count")) for f in san.findings()),
            san.summary())


def _both(scenario):
    """`scenario(sanitizer module)` run for each package; their shapes
    must be equal. Returns {package: Sanitizer}."""
    out = {name: scenario(mod) for name, mod in PACKAGES.items()}
    assert _shape(out["port"]) == _shape(out["galah_tpu"])
    return out


# ---------------------------------------------------------------------------
# SanLock mechanics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_sanlock_wraps_once_and_upgrades_to_declared(pkg):
    san = PACKAGES[pkg].Sanitizer()
    raw = threading.Lock()
    a = san._wrap_lock(raw, "m.py:_A", declared=False)
    assert isinstance(a, PACKAGES[pkg].SanLock) and not a.declared
    # same inner object -> same proxy; a declared wrap upgrades it
    b = san._wrap_lock(raw, "m.py:_A", declared=True)
    assert b is a and a.declared
    assert san._wrap_lock(a, "m.py:_A", declared=True) is a
    with a:
        assert a.locked()
    assert not a.locked()
    assert a.acquisitions == 1


def test_same_name_pair_records_no_edge():
    """Two SanLocks sharing a canonical name (per-instance locks of
    one class) must not produce a self-edge."""
    def scenario(mod):
        san = mod.Sanitizer()
        a = san._wrap_lock(threading.Lock(), "m.py:C._lock", declared=True)
        b = san._wrap_lock(threading.Lock(), "m.py:C._lock", declared=True)
        with a:
            with b:
                pass
        return san

    for san in _both(scenario).values():
        assert san.edges == {}


# ---------------------------------------------------------------------------
# Lock-order reproducers
# ---------------------------------------------------------------------------


def _ordered(mod, inverted):
    m = make_module(LOCK_ORDER=["_A", "_B"], _A=threading.Lock(),
                    _B=threading.Lock())
    san = mod.Sanitizer()
    san.install_module(m, "synth_mod.py")
    outer, inner = (m._B, m._A) if inverted else (m._A, m._B)
    with outer:
        with inner:
            pass
    return san


def test_inversion_reproducer():
    for san in _both(lambda mod: _ordered(mod, True)).values():
        by = errors_by_kind(san)
        assert list(by) == ["inversion"]
        (f,) = by["inversion"]
        assert f["locks"] == ["synth_mod.py:_B", "synth_mod.py:_A"]
        assert HERE in f["where"]
        assert "declares synth_mod.py:_A before" in f["detail"]
        assert san.summary()["inversions"] == 1
        assert san.summary()["unexercised"] == 1


def test_declared_order_exercised_is_clean():
    for san in _both(lambda mod: _ordered(mod, False)).values():
        assert san.errors() == []
        assert san.summary()["unexercised"] == 0
        assert san.summary()["edges_observed"] == 1


def test_undeclared_edge_reproducer():
    """Two DECLARED locks nested with no LOCK_ORDER pair covering
    them."""
    def scenario(mod):
        m = make_module(GUARDED_BY={"_X": "_A", "_Y": "_C"},
                        _A=threading.Lock(), _C=threading.Lock(),
                        _X={}, _Y={})
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")
        with m._A:
            with m._C:
                pass
        return san

    for san in _both(scenario).values():
        by = errors_by_kind(san)
        assert list(by) == ["undeclared_edge"]
        (f,) = by["undeclared_edge"]
        assert f["locks"] == ["synth_mod.py:_A", "synth_mod.py:_C"]
        assert "no LOCK_ORDER declares this pair" in f["detail"]


def test_undeclared_acquisition_reproducer():
    """A nested acquisition involving a lock absent from every
    annotation is an error; a bare acquisition of it is not."""
    def scenario(mod):
        m = make_module(GUARDED_BY={"_X": "_A"}, _A=threading.Lock(),
                        _U=threading.Lock(), _X={})
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")
        with m._U:  # bare: no finding
            pass
        assert san.errors() == []
        with m._A:
            with m._U:  # nested involvement: finding
                pass
        return san

    for san in _both(scenario).values():
        by = errors_by_kind(san)
        assert list(by) == ["undeclared_acquisition"]
        (f,) = by["undeclared_acquisition"]
        assert "synth_mod.py:_U" in f["detail"]
        assert HERE in f["where"]


# ---------------------------------------------------------------------------
# Race reproducers (GUARDED_BY mutation checks)
# ---------------------------------------------------------------------------


def _registry_module():
    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def good_add(self, item):
            with self._lock:
                self._items.append(item)

        def bad_add(self, item):
            self._items.append(item)

    return make_module(GUARDED_BY={"Registry._items": "Registry._lock"},
                       Registry=Registry)


def _run(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    t.join()


def test_unguarded_instance_mutation_from_worker_is_a_race():
    def scenario(mod):
        m = _registry_module()
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")
        reg = m.Registry()
        assert isinstance(reg._lock, mod.SanLock)
        assert isinstance(reg._items, mod.SanList)
        reg.good_add(1)          # locked: clean
        reg.bad_add(2)           # owner thread, lock never foreign
        assert san.errors() == []
        _run(reg.bad_add, 3)
        return san

    for san in _both(scenario).values():
        by = errors_by_kind(san)
        assert list(by) == ["race"]
        (f,) = by["race"]
        assert f["locks"] == ["synth_mod.py:Registry._lock"]
        assert "Registry._items mutated (append)" in f["detail"]
        assert HERE in f["where"]


@pytest.mark.parametrize("locked", [False, True])
def test_owner_rebind_after_foreign_touch(locked):
    """Once another thread took the lock, the owner's rebind needs it
    too: a race without it, clean with it."""
    def scenario(mod):
        m = _registry_module()
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")
        reg = m.Registry()
        reg._items = []          # still single-owner: clean
        assert san.errors() == []
        _run(reg.good_add, 1)
        if locked:
            with reg._lock:
                reg._items = []
        else:
            reg._items = []
        return san

    for san in _both(scenario).values():
        by = errors_by_kind(san)
        if locked:
            assert by == {}
        else:
            assert list(by) == ["race"]
            assert "_items rebind" in by["race"][0]["detail"]


def test_unguarded_global_container_mutation_is_a_race():
    def scenario(mod):
        m = make_module(GUARDED_BY={"_CACHE": "_LOCK"},
                        _LOCK=threading.Lock(), _CACHE={})
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")
        assert isinstance(m._CACHE, mod.SanDict)

        def locked_write():
            with m._LOCK:
                m._CACHE["a"] = 1

        def bare_write():
            m._CACHE["b"] = 2

        _run(locked_write)
        assert san.errors() == []
        _run(bare_write)
        return san

    for san in _both(scenario).values():
        by = errors_by_kind(san)
        assert list(by) == ["race"]
        (f,) = by["race"]
        assert "synth_mod.py:_CACHE mutated (__setitem__)" in f["detail"]


def test_duplicate_races_dedup_by_site():
    def scenario(mod):
        m = make_module(GUARDED_BY={"_CACHE": "_LOCK"},
                        _LOCK=threading.Lock(), _CACHE={})
        san = mod.Sanitizer()
        san.install_module(m, "synth_mod.py")

        def bare_write(i):
            m._CACHE[i] = i  # same site every iteration

        for i in range(3):
            _run(bare_write, i)
        return san

    for san in _both(scenario).values():
        assert san.summary()["races"] == 1


# ---------------------------------------------------------------------------
# Report / summary shapes
# ---------------------------------------------------------------------------


def test_summary_and_report_shape(tmp_path, monkeypatch):
    sans = _both(lambda mod: _ordered(mod, False))
    san = sans["port"]
    s = san.summary()
    assert s == {"enabled": True, "modules": 1, "locks": 2,
                 "declared_locks": 2, "acquisitions": 2,
                 "edges_observed": 1, "edges_declared": 1,
                 "undeclared_acquisitions": 0, "undeclared_edges": 0,
                 "inversions": 0, "races": 0, "unexercised": 0}
    rep = san.report()
    jrep = sans["galah_tpu"].report()
    for key in ("version", "summary", "modules", "locks",
                "declared_order"):
        assert rep[key] == jrep[key], key
    assert rep["edges"][0]["held"] == "synth_mod.py:_A"
    out = tmp_path / "san.json"
    assert san.write_report(str(out)) == str(out)
    assert json.loads(out.read_text())["summary"] == s
    # the flag's path, and write_report_if_asked only for an armed
    # process-wide sanitizer
    env_out = tmp_path / "env.json"
    monkeypatch.setenv("GALAH_SAN_REPORT", str(env_out))
    san.write_report()
    assert env_out.exists()
    monkeypatch.setattr(tsan.GLOBAL, "installed", False)
    assert tsan.write_report_if_asked() is None


def test_reset_observations_keeps_instrumentation():
    def scenario(mod):
        san = _ordered(mod, True)
        assert san.errors()
        san.reset_observations()
        return san

    for san in _both(scenario).values():
        assert san.errors() == []
        assert san.summary()["acquisitions"] == 0


@pytest.mark.parametrize("value, on", [(None, False), ("0", False),
                                       ("", False), ("1", True)])
def test_enabled_flag_parsing(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("GALAH_SAN", raising=False)
    else:
        monkeypatch.setenv("GALAH_SAN", value)
    assert tsan.enabled() is jsan.enabled() is on


def test_flags_are_registered_as_galah_tpus():
    from galah_tpu.config import FLAGS as JFLAGS
    from galah_tpu_torch.config import FLAGS
    from galah_tpu_torch.manpage import render_environment_section

    for name in ("GALAH_SAN", "GALAH_SAN_REPORT"):
        assert FLAGS[name].section == JFLAGS[name].section
        assert FLAGS[name].kind == JFLAGS[name].kind
        assert name in render_environment_section()


def test_install_instruments_only_the_ports_modules():
    """The port's install reads its own registry: every module path is
    the port's, and galah_tpu's instance is a different object."""
    assert tsan.GLOBAL is not jsan.GLOBAL
    assert all(p.startswith("galah_tpu_torch/") for p in THREADED_MODULES)
    if tsan.GLOBAL.installed:
        assert tsan.GLOBAL.modules == list(THREADED_MODULES)


# ---------------------------------------------------------------------------
# The gate: the port's threaded modules under a threaded workload
# ---------------------------------------------------------------------------


def _armed():
    tsan.maybe_install()
    if not tsan.GLOBAL.installed:
        pytest.skip("GALAH_SAN=0: the process-wide sanitizer is not armed")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 families x 3 members, 30 kb, ~1% divergence."""
    root = tmp_path_factory.mktemp("san_corpus")
    paths, _ = _families(root, 7, 3, 3, 30_000, 0.01)
    return paths


def _exercise_threaded_modules(paths, tmp_path):
    """Read-ahead at --threads 4, then worker threads touching metrics,
    warn-once events, flow spans under adoption, fault draws, the
    trace recorder, kernel-cost snapshots and a shared index store,
    beside the heartbeat's sampler thread."""
    from galah_tpu_torch import obs
    from galah_tpu_torch.index import incremental
    from galah_tpu_torch.index.store import IndexStore
    from galah_tpu_torch.io import prefetch
    from galah_tpu_torch.io.fasta import read_genome
    from galah_tpu_torch.obs import (events, flow, heartbeat, metrics,
                                     profile, trace)
    from galah_tpu_torch.resilience import faults
    from galah_tpu_torch.timing import StageClock

    log = logging.getLogger("galah_tpu_torch.san.gate")
    clock = StageClock(torch.device("cpu"))
    read = [p for p, _ in prefetch.iter_prefetched(
        paths, clock.timed(read_genome, "read"),
        depth=prefetch.ingest_depth(4))]
    assert read == paths and clock.work_seconds["read"] > 0
    idx_dir = str(tmp_path / "index")
    incremental.build(idx_dir, paths, 0.95, 0.90, device="cpu",
                      threads=4)
    store = IndexStore(idx_dir)
    inj = faults.FaultInjector([faults.FaultSpec(site="gate", kind="eio",
                                                 prob=0.0)])
    trace.start(str(tmp_path / "trace.json"))
    hb = heartbeat.start(str(tmp_path), 0.05)
    token = flow.token()

    def work(i):
        with flow.adopt(token), flow.span(f"san_gate_{i % 2}"):
            metrics.counter("san.gate.count").inc()
            metrics.gauge("san.gate.gauge").set(i)
            metrics.histogram("san.gate.hist").observe(float(i))
            metrics.pipeline_occupancy(0.5, stage="san_gate")
            events.warn_once(log, "san gate warning",
                             key=f"san-gate-{i % 2}")
            flow.record_wait(None, "host", 0.001)
            assert inj.filesystem("gate.write") is None
            assert store.load().n_genomes == len(paths)
            profile.snapshot()
            trace.emit_instant("san_gate")

    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        work(99)
        store.reload()
        hb.beat()
        metrics.snapshot()
        flow.snapshot()
    finally:
        heartbeat.stop()
        trace.stop()
        obs.reset_run()
    assert inj.fired() == 0


def test_port_runs_violation_free_under_sanitizer(corpus, tmp_path):
    """THE GATE: the port's declared lock annotations hold under a
    multi-threaded CPU workload: zero undeclared acquisitions, zero
    unordered edges, zero inversions, zero races. A failure means an
    annotation drifted from the code's behavior; fix the code or the
    annotation, not the gate."""
    _armed()
    _exercise_threaded_modules(corpus, tmp_path)
    errs = tsan.GLOBAL.errors()
    assert errs == [], json.dumps(errs, indent=1)
    s = tsan.GLOBAL.summary()
    assert s["modules"] == len(THREADED_MODULES)
    assert s["acquisitions"] > 0
    assert (s["undeclared_acquisitions"] == s["undeclared_edges"]
            == s["inversions"] == s["races"] == 0)


def test_profile_counters_lose_no_update_under_contention():
    """A kernel entry's counters and cost sums, which its helpers now
    add under the entry's own lock, from more threads than cores with
    a short switch interval: no update lost."""
    from galah_tpu_torch.obs.profile import ProfiledFunction

    pf = ProfiledFunction("stress")
    n_threads, n_calls = 4 * (os.cpu_count() or 1), 200

    def work(i):
        for _ in range(n_calls):
            pf.plain_call(("s", i), lambda: (3, 5))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = pf.snapshot(None)
    assert snap["plain_calls"] == n_threads * n_calls
    assert snap["signatures"] == n_threads
    assert snap["bytes_accessed"] == 3.0 * n_threads * n_calls
    assert snap["flops"] == 5.0 * n_threads * n_calls


# ---------------------------------------------------------------------------
# Sanitized CLI runs
# ---------------------------------------------------------------------------


def _cluster(main, paths, d, extra=()):
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        assert main(["cluster", "-f", *paths, "--ani", "95",
                     "--precluster-method", "finch", "--cluster-method",
                     "skani", *extra,
                     "--run-report", str(d / "report.json"),
                     "--output-cluster-definition",
                     str(d / "clusters.tsv")]) == 0
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    with open(d / "report.json") as fh:
        return json.load(fh)


def _clean(section):
    return (section["enabled"] is True
            and section["modules"] == len(THREADED_MODULES)
            and section["undeclared_acquisitions"]
            == section["undeclared_edges"] == section["inversions"]
            == section["races"] == 0)


def test_cluster_report_holds_the_sanitizer_section(corpus, tmp_path,
                                                    monkeypatch):
    """A CPU cluster run under GALAH_SAN=1: its report validates in
    both packages, holds a clean sanitizer section, and galah_tpu's
    report renders it and diffs it as its own."""
    monkeypatch.setenv("GALAH_SAN", "1")
    rep = _cluster(tcli.main, corpus, tmp_path,
                   ["--device", "cpu", "--threads", "4"])
    assert treport.validate(rep) == [] and jreport.validate(rep) == []
    assert _clean(rep["sanitizer"]), rep["sanitizer"]
    assert rep["sanitizer"]["acquisitions"] > 0
    for render in (jreport.render, treport.render):
        assert "concurrency sanitizer (GalahSan):" in render(rep)
    rep2 = json.loads(json.dumps(rep))
    rep2["sanitizer"]["races"] = 2
    for diff in (jreport.diff, treport.diff):
        out = diff(rep, rep2)
        assert "sanitizer drift:" in out
        assert "races: 0 -> 2 (+2)" in out


def test_cluster_subprocess_writes_the_standalone_report(corpus, tmp_path):
    """`python -m galah_tpu_torch cluster` with GALAH_SAN=1,
    GALAH_SAN_REPORT and a heartbeat: the TSV of an in-process run,
    and both reports clean."""
    ref = _cluster(tcli.main, corpus, tmp_path,
                   ["--device", "cpu", "--threads", "4"])
    assert ref["sanitizer"]
    sub = tmp_path / "sub"
    sub.mkdir()
    env = dict(os.environ, GALAH_SAN="1",
               GALAH_SAN_REPORT=str(sub / "san.json"),
               GALAH_OBS_HEARTBEAT_S="0.25",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "galah_tpu_torch", "cluster", "-f",
         *corpus, "--ani", "95", "--precluster-method", "finch",
         "--cluster-method", "skani", "--device", "cpu", "--threads", "4",
         "--run-report", str(sub / "report.json"),
         "--output-cluster-definition", str(sub / "clusters.tsv")],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ((sub / "clusters.tsv").read_bytes()
            == (tmp_path / "clusters.tsv").read_bytes())
    with open(sub / "report.json") as fh:
        rep = json.load(fh)
    assert _clean(rep["sanitizer"]) and rep["sanitizer"]["acquisitions"] > 0
    with open(sub / "san.json") as fh:
        full = json.load(fh)
    assert [f for f in full["findings"] if f["severity"] == "error"] == []
    assert full["modules"] == list(THREADED_MODULES)
    assert full["summary"]["races"] == 0


def test_finch_report_carries_galah_tpus_occupancy_gauges(corpus, tmp_path,
                                                          monkeypatch):
    """A finch run's workload.pipeline_occupancy gauges: the names of
    galah_tpu's report of the same run (its streamed pair pass, which
    takes a device sketch strategy and the stage-serial engine), each
    in [0, 1]."""
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "xla")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    # both packages read it: the stage-serial engine on both sides
    monkeypatch.setenv("GALAH_TPU_OVERLAP", "0")
    names = {}
    for side, main, extra in (("jax", jmain, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        rep = _cluster(main, corpus, d, extra)
        occ = {k: v["value"] for k, v in rep["metrics"].items()
               if k.startswith("workload.pipeline_occupancy")}
        assert all(0.0 <= v <= 1.0 for v in occ.values()), (side, occ)
        names[side] = sorted(occ)
    assert names["port"] == names["jax"] == [
        "workload.pipeline_occupancy",
        "workload.pipeline_occupancy[ingest]",
        "workload.pipeline_occupancy[pairs]",
        "workload.pipeline_occupancy[sketch]"]
