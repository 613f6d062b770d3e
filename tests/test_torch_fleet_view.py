"""The port's fleet observability (obs/fleet_view.py, `fleet status`,
the supervisor report's `fleet` and `fleet_rollup` sections) against
galah_tpu's, on synthetic fleet directories: an event log with a torn
tail, shard reports of both packages, heartbeats, and one shard whose
report is missing; each directory written by either package's plan and
log writers and read by both.

Tolerance: none, but for the blame conservation, where the components
(each rounded to 1e-6 s) must sum to the fleet wall within 1e-5 s.
"""

import json
import os

import pytest

from galah_tpu import fleet as jfleet_pkg
from galah_tpu.fleet import plan as jplan
from galah_tpu.fleet import scheduler as jsched
from galah_tpu.io import atomic as jatomic
from galah_tpu.obs import fleet_view as jfv
from galah_tpu.obs import report as jreport
from galah_tpu_torch import fleet as tfleet_pkg
from galah_tpu_torch import obs as tobs
from galah_tpu_torch.fleet import plan as tplan
from galah_tpu_torch.fleet import scheduler as tsched
from galah_tpu_torch.io import atomic as tatomic
from galah_tpu_torch.obs import fleet_view as tfv
from galah_tpu_torch.obs import report as treport

T0 = 1_700_000_000.0
NOW = T0 + 20.0

WRITERS = {"jax": (jplan, jsched, jatomic), "port": (tplan, tsched, tatomic)}

# (event, shard, seconds after T0, fields): shard 1 is SIGKILLed and
# relaunched after a backoff, shard 3 finishes but its report is
# missing, and the merge closes the log
EVENTS = [
    ("shard-launched", 0, 0.0, {"attempt": 1, "resume": False, "pid": -1}),
    ("shard-started", 0, 0.1, {"attempt": 1, "pid": 101}),
    ("shard-launched", 1, 0.2, {"attempt": 1, "resume": False, "pid": -1}),
    ("shard-started", 1, 0.3, {"attempt": 1, "pid": 102}),
    ("shard-preempted", 1, 2.0, {"attempt": 1, "reason": "signal-9"}),
    ("shard-backoff", 1, 2.0, {"backoff_s": 0.5}),
    ("shard-launched", 1, 2.6, {"attempt": 2, "resume": True, "pid": -1}),
    ("shard-started", 1, 2.7, {"attempt": 2, "pid": 103}),
    ("shard-done", 0, 5.0, {"attempt": 1}),
    ("shard-launched", 2, 5.1, {"attempt": 1, "resume": False, "pid": -1}),
    ("shard-started", 2, 5.2, {"attempt": 1, "pid": 104}),
    ("shard-done", 1, 7.0, {"attempt": 2}),
    ("shard-launched", 3, 7.1, {"attempt": 1, "resume": False, "pid": -1}),
    ("shard-started", 3, 7.2, {"attempt": 1, "pid": 105}),
    ("shard-done", 2, 9.5, {"attempt": 1}),
    ("shard-done", 3, 11.0, {"attempt": 1}),
    ("fleet-supervise-done", None, 11.2, {"shards_done": 4,
                                          "retry_spend_s": 0.5}),
    ("fleet-merge-done", None, 13.0, {"wall_s": 1.7}),
]


def _jax_report():
    """A galah_tpu shard report's shape: a flow critical path."""
    return {"version": 10, "kind": "galah-tpu-run-report",
            "flow": {"critical_path": {
                "bottleneck": "exact-ani",
                "stages": {"profile": {"share": 0.625},
                           "exact-ani": {"share": 0.375}}}}}


@pytest.fixture
def frozen(monkeypatch):
    """Both packages' fleet clocks read NOW (beat ages are then equal)."""
    for mod in (tfv, jfv, tsched, jsched):
        monkeypatch.setattr(mod, "_wall", lambda: NOW)


def _fleet_dir(root, writer, running=False):
    """A fleet dir of 4 shards over 8 genomes by `writer`'s package:
    the plan, EVENTS (all of them, or with `running` the first 11, shard
    2 then still running) and a torn tail; shard reports from galah_tpu
    (shards 0, 2) and the port (shard 1), none for shard 3; heartbeats
    for shards 1 and 2, shard 2's with a torn tail."""
    plan_mod, sched_mod, atomic = WRITERS[writer]
    d = str(root)
    plan_mod.save_plan(d, {"ani": 0.95},
                       plan_mod.build_plan([f"g{i}.fna" for i in range(8)],
                                           4))
    log = plan_mod.events_path(d)
    for ev, shard, dt, fields in EVENTS[:11] if running else EVENTS:
        rec = {"ev": ev, "ts": T0 + dt, **fields}
        if shard is not None:
            rec["shard"] = shard
        atomic.append_jsonl(log, rec)
    with open(log, "ab") as fh:
        fh.write(b'{"ev": "shard-done", "ts": 17')  # a kill mid-append
    port_rep = treport.assemble("cluster", None, started_at=T0)
    for sid, rep in ((0, _jax_report()), (1, port_rep),
                     (2, dict(_jax_report(), version=8))):
        path = sched_mod.shard_report_path(d, sid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(rep, fh)
    for sid, ts in ((1, 6.5), (2, 9.0)):
        hb = sched_mod.shard_heartbeat_path(d, sid)
        for beat in range(1, 3):
            atomic.append_jsonl(hb, {
                "beat": beat, "ts": T0 + ts + beat * 0.1, "role": "worker",
                "shard": sid, "occupancy": {"profile": 0.5 * beat},
                "rss_mb": 100.0 + sid})
    with open(sched_mod.shard_heartbeat_path(d, 2), "ab") as fh:
        fh.write(b'{"beat": 3, "ts"')
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("running", [False, True])
def test_views_equal_galah_tpus(tmp_path, frozen, writer, running):
    """rollup, render_rollup, fleet_grid, render_fleet_grid and
    render_status equal galah_tpu's on the same dir, whichever package
    wrote it; the blame sums to the fleet wall."""
    d = _fleet_dir(tmp_path, writer, running)
    ru = tfv.rollup(d)
    assert ru == jfv.rollup(d)
    assert ru["source"]["torn_events"] == 1
    assert ru["source"]["shards_missing"] == [3]
    assert ru["source"]["schema_versions"] == [8, 10]
    blame = sum(c["blame_s"] for c in ru["components"].values())
    assert abs(blame - ru["fleet_wall_s"]) <= 1e-5
    assert tfv.render_rollup(ru) == jfv.render_rollup(ru)
    assert tfv.render_rollup(ru, "  ") == jfv.render_rollup(ru, "  ")
    grid = tfv.fleet_grid(d)
    assert grid == jfv.fleet_grid(d)
    assert tfv.render_fleet_grid(grid) == jfv.render_fleet_grid(grid)
    assert tsched.render_status(d) == jsched.render_status(d)
    assert tfv.is_fleet_dir(d) and jfv.is_fleet_dir(d)
    shards = ru["shards"]
    assert shards["0"]["bottleneck"] == "exact-ani"
    # the port's report carries no flow critical path: unsplit blame
    assert "bottleneck" not in shards["1"] and "stages" not in shards["1"]
    assert shards["1"]["preemptions"] == 1 and shards["1"]["attempts"] == 2
    if running:
        assert shards["2"]["status"] == "running"
        assert "beat-age 10.8s" in tsched.render_status(d)
    else:
        assert ru["components"]["merge"]["blame_s"] == 1.7
        # the stamped backoff, bounded by the time no shard ran
        sched = ru["components"]["scheduler"]
        assert sched["backoff_s"] == min(0.5, sched["blame_s"]) > 0


def test_dirs_without_a_fleet(tmp_path, frozen):
    """No event log: no rollup; neither plan nor log: no grid; a plan
    alone renders every shard pending."""
    assert tfv.rollup(str(tmp_path)) is None is jfv.rollup(str(tmp_path))
    assert tfv.fleet_grid(str(tmp_path)) is None
    assert not tfv.is_fleet_dir(str(tmp_path))
    assert "no fleet plan" in tsched.render_status(str(tmp_path))
    tplan.save_plan(str(tmp_path), {}, tplan.build_plan(["a", "b"], 2))
    assert tfv.rollup(str(tmp_path)) is None
    assert tfv.fleet_grid(str(tmp_path)) == jfv.fleet_grid(str(tmp_path))
    assert tsched.render_status(str(tmp_path)) == jsched.render_status(
        str(tmp_path))
    assert tsched.render_status(str(tmp_path)).count("pending") == 2


def test_fleet_report_and_supervisor_report(tmp_path, frozen):
    """fleet_report.json passes galah_tpu's validate with the rollup as
    its fleet_rollup; a supervisor report assembled with a fleet
    snapshot carries the fleet and fleet_rollup sections, passes
    galah_tpu's validate, and renders the rollup as galah_tpu does;
    reset_run clears the snapshot."""
    d = _fleet_dir(tmp_path, "port")
    ru = tfv.rollup(d)
    path = tfv.write_fleet_report(d, ru, argv=["fleet", "analyze", d],
                                  started_at=T0)
    assert path == os.path.join(d, "fleet_report.json")
    with open(path) as fh:
        rep = json.load(fh)
    assert jreport.validate(rep) == []
    assert rep["fleet_rollup"] == ru
    assert rep["run"]["subcommand"] == "fleet-analyze"

    snap = {"fleet_dir": os.path.abspath(d), "n_shards": 4, "workers": 2,
            "shards_done": 4, "shards_failed": 0, "preemptions": 1,
            "reassignments": 1, "retry_spend_s": 0.5, "resumed": False,
            "merge_wall_s": 1.7, "n_genomes": 8,
            "shards": [{"shard_id": s, "lo": 2 * s, "hi": 2 * s + 2,
                        "n_genomes": 2, "attempts": 1, "status": "done",
                        "preemptions": []} for s in range(4)]}
    tfleet_pkg.set_snapshot(snap)
    jfleet_pkg.set_snapshot(snap)
    try:
        got = treport.assemble("fleet", None, started_at=T0)
        want = jreport.assemble("fleet", started_at=T0)
        assert got["fleet"] == want["fleet"] == snap
        assert got["fleet_rollup"] == want["fleet_rollup"] == ru
        assert jreport.validate(got) == [] and treport.validate(got) == []
        text = treport.render(got)
        assert "\n".join(jfv.render_rollup(ru)) in text
        assert "\n".join(tfv.render_rollup(ru)) in jreport.render(got)
    finally:
        jfleet_pkg.reset()
        tobs.reset_run()
    assert tfleet_pkg.snapshot() is None
    assert "fleet" not in treport.assemble("cluster", None)
