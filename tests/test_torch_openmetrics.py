"""The port's OpenMetrics page (galah_tpu_torch/obs/openmetrics.py) and
`top` against galah_tpu's: the page for the same registry snapshot and
fleet rollup, its atomic swap on a heartbeat tick, and `top [--json]`
on the same heartbeat file and fleet directory, with the same exit
codes and no torch imported.

Tolerance: none (equal pages, equal JSON, equal lines).
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from galah_tpu.cli import main as jmain
from galah_tpu.obs import heartbeat as jheartbeat
from galah_tpu.obs import metrics as jmetrics
from galah_tpu.obs import openmetrics as jom
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.obs import flow as tflow
from galah_tpu_torch.obs import heartbeat as theartbeat
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.obs import openmetrics as tom
from test_torch_cluster import REPO
from test_torch_fleet_view import NOW, _fleet_dir


@pytest.fixture
def fresh():
    for mod in (jmetrics, tmetrics):
        mod.reset()
    tom.reset()
    theartbeat.reset()
    yield
    for mod in (jmetrics, tmetrics):
        mod.reset()
    tom.reset()
    theartbeat.reset()


def _emit(m, seed):
    """Seeded metric calls: counters, gauges (one unset), histograms,
    bracketed names (site and stage labels, an escaped quote)."""
    rng = np.random.default_rng(seed)
    m.counter("cache.hits", help="sketch cache hits").inc(
        int(rng.integers(0, 50)))
    m.counter('retries[io.read "x"]', help="retries\nat a site").inc(3)
    m.gauge("workload.n_genomes", help="genomes").set(
        float(rng.integers(1, 5000)))
    m.gauge("index.generation")
    m.gauge("distributed.exchange_seconds", unit="s").set(
        float(rng.exponential(1.0)))
    h = m.histogram("batch.seconds", unit="s")
    for v in rng.exponential(0.5, size=int(rng.integers(0, 6))):
        h.observe(float(v))
    m.pipeline_occupancy(float(rng.random()), stage="sketch")
    m.pipeline_occupancy(float(rng.random()))


def _rollup(seed):
    rng = np.random.default_rng(seed)
    return {"fleet_wall_s": float(rng.uniform(1, 100)),
            "components": {c: {"blame_s": float(rng.uniform(0, 10)),
                               "share": float(rng.random())}
                           for c in ("compute", "merge", "scheduler",
                                     'odd"name')},
            "shards": {str(s): {"wall_s": float(rng.uniform(0, 9)),
                                "blame_s": float(rng.uniform(0, 9))}
                       for s in range(int(rng.integers(0, 5)))}}


@pytest.mark.parametrize("seed", range(4))
def test_page_equals_galah_tpus(fresh, seed):
    _emit(jmetrics, seed)
    _emit(tmetrics, seed)
    snap = tmetrics.snapshot()
    assert snap == jmetrics.snapshot()
    assert tom.render(snap) == jom.render(snap)
    ru = _rollup(seed)
    assert tom.render(snap, rollup=ru) == jom.render(snap, rollup=ru)
    assert tom.render({}, rollup=None) == jom.render({}, rollup=None)


def test_page_is_swapped_atomically_on_a_beat(fresh, tmp_path, monkeypatch):
    """A beat with GALAH_OBS_OPENMETRICS set writes the page of the
    registry (with the rollup provider's series), leaves no temporary
    file, and the next beat replaces it whole."""
    prom = tmp_path / "m" / "page.prom"
    prom.parent.mkdir()
    monkeypatch.setenv("GALAH_OBS_OPENMETRICS", str(prom))
    ru = _rollup(1)
    tom.set_rollup_provider(lambda: ru)
    _emit(tmetrics, 0)
    hb = theartbeat.Heartbeat(str(tmp_path), 3600.0)
    hb.beat()
    assert prom.read_text() == jom.render(tmetrics.snapshot(), rollup=ru)
    assert "galah_fleet_wall_seconds" in prom.read_text()
    tmetrics.counter("cache.hits").inc(1000)
    tom.set_rollup_provider(lambda: 1 / 0)  # a torn fleet dir: no series
    hb.beat()
    assert prom.read_text() == jom.render(tmetrics.snapshot())
    assert os.listdir(prom.parent) == ["page.prom"]
    monkeypatch.delenv("GALAH_OBS_OPENMETRICS")
    assert tom.maybe_export() is None


def test_beats_carry_flow_queue_depths_and_items(fresh, tmp_path,
                                                 monkeypatch):
    rec = tflow.FlowRecorder(enabled=True)
    monkeypatch.setattr(tflow, "GLOBAL", rec)
    rec.record_service("ingest", 0.1, items=5)
    rec.emit("ingest", rec.begin("genome_batch"))
    rec.emit("ingest", rec.begin("genome_batch"))
    rec.absorb("ingest", "sketch")
    theartbeat.Heartbeat(str(tmp_path), 3600.0).beat()
    beat = theartbeat.read_latest_beat(str(tmp_path))
    assert beat["queue_depths"] == {"ingest": 1}
    assert beat["flow_items"] == {"ingest": 5, "sketch": 1}


def _both(argv, capsys):
    """(port rc, port stdout, galah_tpu rc, galah_tpu stdout)."""
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    out = []
    try:
        for main in (tcli.main, jmain):
            rc = main(argv)
            out += [rc, capsys.readouterr().out]
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    return out


@pytest.mark.parametrize("as_json", [False, True])
def test_top_equals_galah_tpus_on_a_heartbeat(fresh, tmp_path, capsys,
                                              monkeypatch, as_json):
    _emit(tmetrics, 2)
    hb = theartbeat.Heartbeat(str(tmp_path), 3600.0)
    for _ in range(3):
        hb.beat()
    with open(tmp_path / theartbeat.HEARTBEAT_FILENAME, "ab") as fh:
        fh.write(b'{"beat": 4, "ts"')  # a kill mid-append
    monkeypatch.setattr(time, "time", lambda: NOW)
    flag = ["--json"] if as_json else []
    for target in (str(tmp_path),
                   str(tmp_path / theartbeat.HEARTBEAT_FILENAME)):
        t_rc, t_out, j_rc, j_out = _both(["top", target, *flag], capsys)
        assert t_rc == j_rc == 0
        assert t_out == j_out
    if as_json:
        assert json.loads(t_out) == theartbeat.load(str(tmp_path))[0][-1]
    else:
        assert t_out == jheartbeat.render_latest(str(tmp_path)) == \
            theartbeat.render_latest(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    t_rc, t_out, j_rc, j_out = _both(["top", str(empty), *flag], capsys)
    assert t_rc == j_rc == 1 and t_out == j_out


@pytest.mark.parametrize("as_json", [False, True])
def test_top_equals_galah_tpus_on_a_fleet_dir(tmp_path, capsys, frozen,
                                              as_json):
    d = _fleet_dir(tmp_path, "port", running=True)
    t_rc, t_out, j_rc, j_out = _both(
        ["top", d, *(["--json"] if as_json else [])], capsys)
    assert t_rc == j_rc == 0
    assert t_out == j_out
    if as_json:
        assert json.loads(t_out)["shards"]


def test_top_follow_stops_on_interrupt_and_imports_no_torch(tmp_path):
    hb_dir = tmp_path / "run"
    hb_dir.mkdir()
    theartbeat.Heartbeat(str(hb_dir), 3600.0).beat()
    code = ("import sys, time\n"
            "from galah_tpu_torch.cli import main\n"
            "calls = []\n"
            "def stop(s):\n"
            "    calls.append(s)\n"
            "    raise KeyboardInterrupt\n"
            "time.sleep = stop\n"
            f"rc = main(['top', {str(hb_dir)!r}, '--follow', "
            "'--interval', '0.01'])\n"
            "assert calls == [0.1], calls\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "heartbeat" in proc.stdout


@pytest.fixture
def frozen(monkeypatch):
    """Both packages' fleet clocks read NOW (beat ages are then equal)."""
    from galah_tpu.fleet import scheduler as jsched
    from galah_tpu.obs import fleet_view as jfv
    from galah_tpu_torch.fleet import scheduler as tsched
    from galah_tpu_torch.obs import fleet_view as tfv

    for mod in (tfv, jfv, tsched, jsched):
        monkeypatch.setattr(mod, "_wall", lambda: NOW)
