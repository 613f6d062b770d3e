"""The port's kill-anywhere chaos harness
(galah_tpu_torch/resilience/chaos.py): tests/test_chaos.py's fast
cases (the artifact audit, the fault specs, the mode and fleet
schedules), held against galah_tpu's scripts/chaos_run.py where both
define the same thing, and one kill at a dispatch site, resumed to the
uninterrupted TSV, byte for byte. The bounded smoke loops are the slow
`chaos` tier, as galah_tpu's are.

Tolerance: none. TSVs are compared byte for byte.
"""

import importlib.util
import os
import pathlib

import pytest

from galah_tpu_torch.io import atomic
from galah_tpu_torch.resilience import chaos
from galah_tpu_torch.resilience import faults as tfaults

_SCRIPT = (pathlib.Path(__file__).parent.parent / "scripts"
           / "chaos_run.py")


def _load_chaos_run():
    spec = importlib.util.spec_from_file_location("chaos_run",
                                                  str(_SCRIPT))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_modes_and_specs_are_galah_tpus():
    jchaos = _load_chaos_run()
    assert chaos.MODES == jchaos.MODES
    assert chaos.FLEET_MODES == jchaos.FLEET_MODES
    assert chaos.FLEET_CHAOS_ENV == jchaos.FLEET_CHAOS_ENV
    for mode in chaos.MODES:
        assert chaos.fault_env(mode, seed=3) == jchaos.fault_env(mode, 3)
    # the workload's genomes are the same bytes
    assert chaos.make_workload.__defaults__ == \
        jchaos.make_workload.__defaults__


@pytest.mark.parametrize("n", [5, 10, 25])
def test_schedule_covers_every_mode(n):
    """Any 5+ iterations draw every mode, in galah_tpu's order for the
    same seed."""
    jchaos = _load_chaos_run()
    import random

    want = [jchaos.MODES[i % len(jchaos.MODES)] for i in range(n)]
    random.Random(7).shuffle(want)
    assert chaos.mode_schedule(chaos.MODES, n, 7) == want
    assert set(want) == set(chaos.MODES)


def test_fleet_schedule_covers_scheduler_kills():
    """Any 3+ fleet iterations must kill the scheduler itself at least
    once: worker kills alone never exercise event-log replay or orphan
    adoption."""
    for n in (3, 10):
        schedule = chaos.mode_schedule(chaos.FLEET_MODES, n, 11)
        assert "sched-kill" in schedule
        assert set(schedule) == set(chaos.FLEET_MODES)


def test_scan_artifacts_flags_debris_and_corruption(tmp_path):
    """.tmp debris and unparseable json are findings; checksum-rejected
    torn jsonl lines are recoverable by design and are not."""
    ck = tmp_path / "ck"
    ck.mkdir()
    assert chaos.scan_artifacts(str(ck)) == []
    atomic.append_jsonl(str(ck / "clusters.jsonl"), {"i": 0})
    with open(ck / "clusters.jsonl", "ab") as f:
        f.write(b'{"torn')  # a torn tail: readable with recovery, fine
    atomic.write_json(str(ck / "fingerprint.json"), {"ok": True})
    assert chaos.scan_artifacts(str(ck)) == []
    (ck / "fingerprint.json.123.tmp").write_bytes(b"debris")
    (ck / "bad.json").write_bytes(b"{not json")
    (ck / "bad.npz").write_bytes(b"not an npz")
    problems = chaos.scan_artifacts(str(ck))
    assert len(problems) == 3
    assert any(".tmp" in p for p in problems)
    assert any("bad.json" in p for p in problems)
    assert any("bad.npz" in p for p in problems)
    assert problems == _load_chaos_run().scan_artifacts(str(ck))


@pytest.mark.parametrize("mode", chaos.MODES + chaos.EXTRA_MODES)
def test_fault_env_specs_parse(monkeypatch, mode):
    """Every GALAH_FI spec the harness makes parses into an injector of
    its kind (a typo here would chaos-test nothing)."""
    env = chaos.fault_env(mode, seed=3)
    if mode == "sigterm":
        assert env is None
        return
    monkeypatch.setenv("GALAH_FI", env["GALAH_FI"])
    tfaults.reset()
    try:
        inj = tfaults.get_injector()
        assert inj is not None
        kinds = {s.kind for s in inj._specs}
        assert kinds == {"kill" if mode.startswith("kill") else mode}
    finally:
        monkeypatch.delenv("GALAH_FI")
        tfaults.reset()


def test_device_env_and_modes_are_checked():
    assert chaos.device_env("cuda") == {"GALAH_TPU_PLATFORM": "cuda"}
    # no --device: the children keep the CLI's default and the caller's
    # GALAH_TPU_PLATFORM
    assert chaos.device_env(None) == {}
    with pytest.raises(ValueError):
        chaos.device_env("tpu")
    with pytest.raises(SystemExit):
        chaos.main(["--modes", "kill,explode", "--iterations", "0"])
    assert chaos.sigterm_window(10.0) == pytest.approx((4.5, 10.5))
    assert chaos.sigterm_window(10.0, started=3.5) == (3.5, 10.0)


def test_kill_at_a_dispatch_site_then_resume_bytes_equal(tmp_path):
    """One iteration: a GALAH_FI kill at the first guarded dispatch of
    a checkpointed skani run on 6 x 20 kb genomes (exit 137), a resume
    with the faults cleared, and the TSV byte-equal to the
    uninterrupted run's; no debris, and the report records the
    resume."""
    genomes = chaos.make_workload(str(tmp_path), seed=0)
    assert len(genomes) == 6
    env = chaos.device_env("cpu")
    ref = tmp_path / "reference"
    ref.mkdir()
    proc = chaos.launch(chaos.cluster_argv(
        genomes, str(ref / "clusters.tsv"), str(ref / "ckpt"),
        str(ref / "report.json"), resume=False), env)
    out, _ = proc.communicate(timeout=chaos.RUN_TIMEOUT_S)
    assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
    reference = (ref / "clusters.tsv").read_bytes()
    assert reference.count(b"\n") == 6

    ok, detail = chaos.run_iteration(genomes, reference, str(tmp_path),
                                     "kill-dispatch", seed=0,
                                     extra_env=env)
    assert ok, detail
    assert f"interrupted run exited {tfaults.KILL_EXIT_CODE}" in detail
    assert "resume attempt 0 exited 0 (resume=True)" in detail
    work = tmp_path / "iter_0_kill-dispatch"
    assert (work / "clusters.tsv").read_bytes() == reference
    assert not [n for n in os.listdir(work / "ckpt")
                if n.endswith(".tmp")]


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_smoke_ten_kill_points(tmp_path):
    failures = chaos.run_harness(iterations=10, seed=11,
                                 workdir=str(tmp_path), verbose=False,
                                 device="cpu")
    assert failures == 0


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_overlap_and_index_smoke(tmp_path):
    assert chaos.run_harness(iterations=4, seed=11,
                             workdir=str(tmp_path / "overlap"),
                             verbose=False, overlap=True,
                             device="cpu") == 0
    assert chaos.run_index_harness(iterations=5, seed=11,
                                   workdir=str(tmp_path / "index"),
                                   verbose=False, device="cpu") == 0


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_fleet_smoke(tmp_path):
    """One iteration per FLEET_MODES entry: SIGKILL a worker group,
    SIGKILL the scheduler, SIGTERM the scheduler, each resumed and held
    to byte-identical clusters, zero debris and a coherent
    reassignment chain."""
    failures = chaos.run_fleet_harness(iterations=3, seed=11,
                                       workdir=str(tmp_path),
                                       verbose=False, device="cpu")
    assert failures == 0
