"""The port's perf ledger (galah_tpu_torch/obs/ledger.py) and `perf`
subcommand against galah_tpu's: entries from the same reports, verdicts
over seeded histories, each package's ledger file read by the other
(a torn tail skipped), and `perf record|history|check` with the same
output and exit codes, importing no torch.

Tolerance: none (equal dicts, equal lines, equal exit codes).
"""

import json
import logging
import subprocess
import sys

import numpy as np
import pytest

from galah_tpu.cli import main as jmain
from galah_tpu.obs import ledger as jledger
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.obs import ledger as tledger
from test_torch_cluster import REPO


def _report(duration=12.0, n=256, backend="cpu", kind="cpu", flow=True):
    """A report in galah_tpu's shape (its tests/test_perf_ledger.py),
    with a flow critical path."""
    rep = {
        "version": 10,
        "run": {"subcommand": "cluster", "duration_s": duration},
        "device": {"backend": backend, "device_count": 1,
                   "devices": [{"device_kind": kind}]},
        "flags": {"GALAH_TPU_PAIRLIST_BLOCK": {"value": "8"},
                  "GALAH_TPU_GREEDY_STRATEGY": {"value": "device"}},
        "metrics": {"workload.n_genomes": {"value": n},
                    "workload.sketch_k": {"value": 1000},
                    "bench.e2e_genomes_per_sec": {"value": n / duration}},
        "stages": {"tree": [
            {"name": "precluster-distances", "total_s": 7.5,
             "children": [{"name": "sketch", "total_s": 3.0,
                           "children": [{"name": "deep",
                                         "total_s": 1.0}]}]},
            {"name": "greedy", "total_s": 4.0}]},
        "dispatch": {"total_dispatches": 42, "total_syncs": 2},
        "device_costs": {
            "profiling_enabled": True,
            "entries": {"tile_stats": {
                "calls": 5, "signatures": 1, "dispatch_wall_s": 1.25,
                "compile_wall_s": 0.5, "device_s": 0.01}},
            "hbm": {"peak_bytes": 1 << 20, "source": "memory_stats",
                    "per_stage": {}},
            "peaks": {}},
    }
    if flow:
        rep["flow"] = {"critical_path": {
            "e2e_wall_s": duration, "bottleneck": "sketch",
            "host": {"blame_s": 2.0, "share": 2.0 / duration},
            "stages": {"sketch": {"blame_s": duration - 2.0,
                                  "share": 1 - 2.0 / duration}}}}
    return rep


def _port_report(tmp_path_factory):
    from test_torch_cluster import _families

    root = tmp_path_factory.mktemp("ledger_run")
    paths, _ = _families(root, 7, 8, 3, 30_000, 0.02)
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                          "--precluster-method", "finch", "--run-report",
                          str(root / "r.json"),
                          "--output-cluster-definition",
                          str(root / "c.tsv")]) == 0
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    return json.loads((root / "r.json").read_text())


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    return _port_report(tmp_path_factory)


@pytest.mark.parametrize("which", ["galah_tpu", "port"])
def test_entry_from_report_equals_galah_tpus(which, port_report):
    rep = _report() if which == "galah_tpu" else port_report
    for shard in (None, 3):
        got = tledger.entry_from_report(rep, "cluster", ts=5.0,
                                        sha="abc1234", shard=shard)
        want = jledger.entry_from_report(rep, "cluster", ts=5.0,
                                         sha="abc1234", shard=shard)
        assert got == want
    if which == "port":
        key = got["key"]
        assert key["workload"] == {"n": 24, "k": 1000, "p": None}
        assert key["strategy"] == "auto/auto/auto/auto/auto/auto"
        assert "flow.pairs.blame_s" in got["metrics"]
        # the plain versions' calls have no dispatch wall: no profile.*
        assert any(m.startswith("stage.") for m in got["metrics"])


def test_port_key_never_shares_a_band_with_a_tpu_entry():
    tpu = jledger.entry_from_report(_report(backend="tpu",
                                            kind="TPU v4"), "cluster")
    gpu = tledger.entry_from_report(
        _report(backend="cuda", kind="NVIDIA H100 80GB HBM3"), "cluster")
    assert tledger.key_of(tpu) != tledger.key_of(gpu)
    assert gpu["key"]["backend"] == "cuda"
    v = tledger.check([tpu] * 5, gpu)
    assert {x["verdict"] for x in v} == {"insufficient-history"}


def _history(seed):
    """Seeded entries over two keys: noisy walls, one neutral metric."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(2, 14))):
        kind = "cpu" if rng.random() < 0.7 else "other"
        rep = _report(duration=float(rng.normal(10.0, 0.5)), kind=kind,
                      flow=bool(rng.random() < 0.8))
        e = jledger.entry_from_report(rep, "cluster", ts=float(i),
                                      sha="s")
        e["metrics"]["funny_metric"] = float(rng.normal(5.0, 1.0))
        out.append(e)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_check_and_regressions_equal_galah_tpus(seed):
    hist = _history(seed)
    rng = np.random.default_rng(1000 + seed)
    cur = jledger.entry_from_report(
        _report(duration=float(rng.choice([10.0, 13.0, 7.0]))),
        "cluster", ts=99.0, sha="s")
    for window, mad_k, min_history in ((8, 4.0, 3), (3, 1.0, 1),
                                       (20, 2.5, 5)):
        got = tledger.check(hist, cur, window=window, mad_k=mad_k,
                            min_history=min_history)
        want = jledger.check(hist, cur, window=window, mad_k=mad_k,
                             min_history=min_history)
        assert got == want
        assert tledger.regressions(got) == jledger.regressions(want)
    for name in ("flow.host.share", "run.duration_s", "x_per_sec",
                 "profile.hbm_peak_bytes", "funny_metric"):
        assert tledger.metric_direction(name) == \
            jledger.metric_direction(name)


@pytest.mark.parametrize("writer", ["port", "galah_tpu"])
def test_ledger_files_cross_over_and_skip_a_torn_tail(writer, tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    w, r = (tledger, jledger) if writer == "port" else (jledger, tledger)
    entries = [w.entry_from_report(_report(duration=10.0 + i), "cluster",
                                   ts=float(i), sha="s") for i in range(3)]
    for e in entries:
        w.append(path, e)
    with open(path, "a") as fh:  # a run killed mid-append
        fh.write('{"v": 1, "ts": 3.0, "metr')
    for reader in (r, w):
        got, skipped = reader.read(path)
        assert got == entries and skipped == 1
    with open(path, "a") as fh:
        fh.write("\n")
    w.append(path, entries[0])
    got, skipped = r.read(path)
    assert got == entries + entries[:1] and skipped == 1


def _write(tmp_path, name, duration):
    p = tmp_path / name
    p.write_text(json.dumps(_report(duration=duration)))
    return str(p)


def _both(tmp_path, argv, capsys):
    """`argv` through the port's main on one ledger and galah_tpu's on
    a copy: (port rc, port stdout, galah_tpu rc, galah_tpu stdout)."""
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    out = []
    try:
        for side, main in (("port", tcli.main), ("jax", jmain)):
            a = [x.replace("LEDGER", str(tmp_path / f"{side}.jsonl"))
                 for x in argv]
            try:
                rc = main(a)
            except SystemExit as e:
                rc = e.code
            out += [rc, capsys.readouterr().out.replace(
                str(tmp_path / f"{side}.jsonl"), "LEDGER")]
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
    return out


def test_perf_output_and_exit_codes_equal_galah_tpus(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.delenv("GALAH_OBS_LEDGER", raising=False)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    steps = [(["perf", "check"], 1),
             (["perf", "--ledger", "LEDGER"], 1),
             (["perf", "--ledger", "LEDGER", "check"], 0),
             (["perf", "--ledger", "LEDGER", "record", str(bad)], 1),
             (["perf", "--ledger", "LEDGER", "record",
               str(tmp_path / "missing.json")], 1)]
    for i, dur in enumerate((10.0, 10.2, 9.9, 10.1)):
        steps.append((["perf", "--ledger", "LEDGER", "record",
                       _write(tmp_path, f"r{i}.json", dur), "--source",
                       "cluster"], 0))
    slow = _write(tmp_path, "slow.json", 30.0)
    steps += [
        (["perf", "--ledger", "LEDGER", "history", "run.duration_s"], 0),
        (["perf", "--ledger", "LEDGER", "history", "nothing"], 0),
        (["perf", "--ledger", "LEDGER", "history", "run.duration_s",
          "--key", "cpu"], 0),
        (["perf", "--ledger", "LEDGER", "check"], 0),
        (["perf", "--ledger", "LEDGER", "check", "--window", "2",
          "--min-history", "1"], 0),
        (["perf", "--ledger", "LEDGER", "check", "--report", slow,
          "--source", "cluster"], 1),
        (["perf", "--ledger", "LEDGER", "check", "--report", slow,
          "--source", "cluster", "--soft"], 0),
        (["perf", "--ledger", "LEDGER", "check", "--report", slow,
          "--source", "cluster", "--mad-k", "1000"], 0),
        (["perf", "--ledger", "LEDGER", "check", "--report",
          str(bad)], 1)]
    for argv, want_rc in steps:
        t_rc, t_out, j_rc, j_out = _both(tmp_path, argv, capsys)
        assert t_rc == j_rc == want_rc, argv
        assert t_out == j_out, argv
    assert "REGRESSION: run.duration_s" in \
        _both(tmp_path, steps[-4][0], capsys)[1]


def test_finalize_keys_a_fleet_workers_entry_by_its_shard(
        tmp_path, monkeypatch):
    from galah_tpu_torch import obs as tobs
    from galah_tpu_torch.timing import StageClock
    import torch

    led = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("GALAH_OBS_LEDGER", str(led))
    monkeypatch.setenv("GALAH_TPU_FLEET_WORKER", str(tmp_path))
    shard_dir = tmp_path / "shards" / "shard_002"
    shard_dir.mkdir(parents=True)
    tobs.reset_run()
    rep = tobs.finalize("cluster", StageClock(torch.device("cpu")),
                        report_path=str(shard_dir / "report.json"))
    assert rep is not None
    monkeypatch.delenv("GALAH_TPU_FLEET_WORKER")
    tobs.finalize("cluster", StageClock(torch.device("cpu")))
    entries, torn = jledger.read(str(led))
    assert torn == 0 and [e["key"].get("shard") for e in entries] == [2, None]
    assert entries[0]["key"]["backend"] == "cpu"


def test_perf_imports_no_torch(tmp_path):
    rp = _write(tmp_path, "r.json", 10.0)
    led = str(tmp_path / "l.jsonl")
    for argv in (["perf", "--ledger", led, "record", rp],
                 ["perf", "--ledger", led, "history", "run.duration_s"],
                 ["perf", "--ledger", led, "check"]):
        code = ("import sys\n"
                "from galah_tpu_torch.cli import main\n"
                f"rc = main({argv!r})\n"
                "assert 'torch' not in sys.modules, 'torch was imported'\n"
                "sys.exit(rc)\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-2000:]
