"""The port's fleet (galah_tpu_torch/fleet/, `fleet run|status|analyze`)
against galah_tpu's: shard plans and their file bytes, the scheduler's
lifecycle and event log over the same fake workers, the merge over the
same shard checkpoints, `distances_subset` on small genomes, the
supervisor's signal forwarding, and one whole `python -m
galah_tpu_torch fleet run --device cpu` against the single-process
`cluster` runs of both packages.

Tolerance: none. Plans, snapshots, event records (less their time
stamps and pids), cluster lists, pair dicts and TSV bytes are compared
for equality.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from galah_tpu.backends import ProfileStore as JStore
from galah_tpu.backends import SkaniPreclusterer as JSkaniPre
from galah_tpu.cli import main as jmain
from galah_tpu.cluster import cache as jcache
from galah_tpu.cluster import checkpoint as jckpt
from galah_tpu.fleet import merge as jmerge
from galah_tpu.fleet import plan as jplan
from galah_tpu.fleet import scheduler as jsched
from galah_tpu.obs import report as jreport
from galah_tpu.ops import collision as jcollision
from galah_tpu.resilience.policy import RetryPolicy as JPolicy
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.backends import ProfileStore as TStore
from galah_tpu_torch.backends import SkaniPreclusterer as TSkaniPre
from galah_tpu_torch.cluster import cache as tcache
from galah_tpu_torch.cluster import checkpoint as tckpt
from galah_tpu_torch.fleet import merge as tmerge
from galah_tpu_torch.fleet import plan as tplan
from galah_tpu_torch.fleet import scheduler as tsched
from galah_tpu_torch.io import atomic
from galah_tpu_torch.ops import collision as tcollision
from galah_tpu_torch.resilience import interrupt as tinterrupt
from galah_tpu_torch.resilience.policy import RetryPolicy as TPolicy

from test_torch_cluster import _families

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "jax": (jplan, jsched, JPolicy),
    "port": (tplan, tsched, TPolicy),
}


@pytest.fixture
def root_logger():
    """main's -v/-q replace the root logger's handlers; put them back."""
    import logging

    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def fleet_corpus(tmp_path_factory):
    """3 families x 3 members, 20 kb, ~1% divergence, listed family by
    family but rotated by one genome, so three shards of three each
    hold a within-shard pair and every family crosses a shard bound."""
    paths, labels = _families(tmp_path_factory.mktemp("fleet"), 11, 3, 3,
                              20_000, 0.01)
    return paths[1:] + paths[:1], labels[1:] + labels[:1]


# -- plan ----------------------------------------------------------------


@pytest.mark.parametrize("n,shards", [(0, 1), (1, 3), (5, 8), (6, 3),
                                      (7, 3), (10, 4)])
def test_plan_and_file_equal_galah_tpus(tmp_path, n, shards):
    """build_plan, empty shards dropped, and fleet_plan.json's bytes
    (fingerprint fields of each package's checkpoint module) equal
    galah_tpu's; a rerun keeps the plan and its bytes."""
    genomes = [f"g{i}.fna" for i in range(n)]
    want = [s.to_dict() for s in jplan.build_plan(genomes, shards)]
    assert [s.to_dict() for s in tplan.build_plan(genomes, shards)] == want
    assert all(s["hi"] > s["lo"] for s in want)
    assert len(want) == min(n, shards)
    docs = {}
    for side, ck in (("jax", jckpt), ("port", tckpt)):
        plan_mod = SIDES[side][0]
        fields = ck.fingerprint_fields(genomes, "skani", "skani", 0.95,
                                       0.95, 0.15, 3000, {"k": 15})
        d = str(tmp_path / side)
        got = plan_mod.ensure_plan(d, genomes, fields, shards)
        assert [s.to_dict() for s in got] == want
        with open(plan_mod.plan_path(d), "rb") as fh:
            docs[side] = fh.read()
        again = plan_mod.ensure_plan(d, genomes, fields, shards,
                                     require_match=True)
        assert [s.to_dict() for s in again] == want
        with open(plan_mod.plan_path(d), "rb") as fh:
            assert fh.read() == docs[side]
    assert docs["port"] == docs["jax"]
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        tplan.build_plan(genomes, 0)


def test_ensure_plan_mismatch_names_the_field(tmp_path):
    """--resume under another configuration is refused naming the
    fields that differ; without it the stale plan and event log go."""
    d = str(tmp_path)
    genomes = [f"g{i}.fna" for i in range(4)]
    fields = tckpt.fingerprint_fields(genomes, "skani", "skani", 0.95, 0.95)
    tplan.ensure_plan(d, genomes, fields, 2)
    tsched.append_stamp(d, "shard-launched", shard=0)
    other = dict(fields, ani=0.97)
    with pytest.raises(ValueError, match=r"mismatched fields: ani\)$"):
        tplan.ensure_plan(d, genomes, other, 2, require_match=True)
    with pytest.raises(ValueError, match="mismatched fields: n_shards"):
        tplan.ensure_plan(d, genomes, fields, 3, require_match=True)
    with pytest.raises(ValueError, match="no fleet plan"):
        tplan.ensure_plan(str(tmp_path / "none"), genomes, fields, 2,
                          require_match=True)
    shards = tplan.ensure_plan(d, genomes, other, 3)
    assert len(shards) == 3
    assert not os.path.exists(tplan.events_path(d))
    assert tplan.load_plan(d)["fields"]["ani"] == 0.97


@pytest.mark.parametrize("case", ["resume-mismatch", "non-skani",
                                  "zero-workers"])
def test_fleet_run_refusals_exit_1(fleet_corpus, tmp_path, capsys,
                                   root_logger, case):
    """`fleet run` exits 1 naming the cause, before any worker starts:
    a --resume against another run's plan, a method other than
    skani/skani (the merge is byte-identical only there), --workers 0."""
    paths = fleet_corpus[0][:2]
    fleet_dir = str(tmp_path / "fleet")
    argv = ["fleet", "run", "--device", "cpu", "-f", *paths,
            "--fleet-dir", fleet_dir, "--output-cluster-definition",
            str(tmp_path / "c.tsv")]
    if case == "resume-mismatch":
        tplan.save_plan(fleet_dir, {"ani": "something-else"},
                        tplan.build_plan(paths, 2))
        argv.append("--resume")
        message = "mismatched fields"
    elif case == "non-skani":
        argv += ["--precluster-method", "finch"]
        message = "fleet run requires --precluster-method skani"
    else:
        argv += ["--workers", "0"]
        message = "--workers must be >= 1"
    assert tcli.main(argv) == 1
    assert message in capsys.readouterr().err
    assert not os.path.exists(tplan.events_path(fleet_dir))


def _actions(parser):
    return {(a.option_strings[-1] if a.option_strings else a.dest):
            (a.default, a.required) for a in parser._actions}


def _action_parser(parser, action):
    return next(a.choices[action] for a in parser._actions
                if isinstance(a.choices, dict) and action in a.choices)


@pytest.mark.parametrize("action", ["run", "status", "analyze"])
def test_fleet_parser_matches_galah_tpus(action, capsys):
    """`fleet run|status|analyze` take galah_tpu's options with its
    defaults, and `run` also the port's --device (its default None
    stands for cuda); --platform, once refused by name, goes on `fleet`
    before the action, as in galah_tpu, and after it is an
    unrecognized argument in both packages."""
    from galah_tpu.cli import build_parser as jbuild_parser

    want = _actions(_action_parser(jbuild_parser()._subcommand_parsers[
        "fleet"], action))
    got = _actions(_action_parser(tcli.build_parser().subcommand_parsers[
        "fleet"], action))
    if action == "run":
        assert got.pop("--device") == (None, False)
    assert got == want
    rest = ["--fleet-dir", "d"] if action == "run" else ["d"]
    for parse in (jbuild_parser().parse_args, tcli.parse_args):
        assert parse(["fleet", "--platform", "cpu", action,
                      *rest]).platform == "cpu"
        with pytest.raises(SystemExit) as e:
            parse(["fleet", action, *rest, "--platform", "cpu"])
        assert e.value.code == 2
        assert "unrecognized arguments: --platform cpu" in \
            capsys.readouterr().err


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("resume", [False, True])
def test_worker_argv_is_galah_tpus(device, resume):
    """A worker's command line is galah_tpu's with `-m galah_tpu_torch`
    for `-m galah_tpu.cli` and the supervisor's --device at its end
    (before --sketch-cache and --resume)."""
    from galah_tpu.cli import _fleet_worker_argv as jworker_argv
    from galah_tpu.cli import build_parser as jbuild_parser

    common = ["-f", "a.fna", "b.fna", "--fleet-dir", "fl", "--ani", "97",
              "--threads", "4", "--ani-subsample", "125"]
    jargs = jbuild_parser().parse_args(["fleet", "run", *common])
    targs = tcli.parse_args(["fleet", "run", *common, "--device", device])
    spec = tplan.build_plan(["a.fna", "b.fna"], 1)[0]
    want = jworker_argv(jargs, "fl", "cache")(spec, resume)
    got = tcli._fleet_worker_argv(targs, "fl", "cache")(spec, resume)
    at = want.index("--sketch-cache")
    want = [*want[:at], "--device", device, *want[at:]]
    assert want[1:3] == ["-m", "galah_tpu.cli"]
    assert got == [want[0], "-m", "galah_tpu_torch", *want[3:]]


def test_fleet_run_defaults_to_the_card(fleet_corpus, tmp_path,
                                        monkeypatch, root_logger):
    """Without --device the supervisor asks for the card, and without
    one it raises before it plans or launches anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fleet_dir = tmp_path / "fleet"
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["fleet", "run", "-f", *fleet_corpus[0][:2],
                   "--fleet-dir", str(fleet_dir)])
    assert not fleet_dir.exists()


# -- scheduler (fake workers) ----------------------------------------------


def _fake_argv(fleet_dir, behaviour):
    """Worker command lines of a fake `behaviour` (the same paths in
    both packages): 'done' leaves the merge artifact and exits 0;
    'exit-75-once' exits 75 on its first attempt; 'exit-3' always
    exits 3; 'no-distances' exits 0 and leaves nothing; 'hang' sleeps
    without a beat."""
    def argv(spec, resume):
        path = tsched.shard_distances_path(fleet_dir, spec.shard_id)
        marker = os.path.join(fleet_dir, f"seen_{spec.shard_id}")
        done = (f"p = {path!r}\n"
                "os.makedirs(os.path.dirname(p), exist_ok=True)\n"
                "open(p, 'wb').write(b'npz')\n")
        code = {
            "done": done,
            "exit-75-once": (f"if not os.path.exists({marker!r}):\n"
                             f"    open({marker!r}, 'w').close()\n"
                             "    sys.exit(75)\n" + done),
            "exit-3": "sys.exit(3)\n",
            "no-distances": "sys.exit(0)\n",
            "hang": "time.sleep(60)\n",
        }[behaviour]
        return [sys.executable, "-c", "import os, sys, time\n" + code]
    return argv


# behaviour, genomes, shards, workers, retry budget, stale seconds,
# prior event records (a killed supervisor's launches)
SCENARIOS = {
    "done": ("done", 6, 3, 2, 3, 0, []),
    "exit-75-reassigned": ("exit-75-once", 4, 2, 2, 3, 0, []),
    "budget-quarantine": ("exit-3", 2, 1, 1, 2, 0, []),
    "no-distances": ("no-distances", 2, 1, 1, 2, 0, []),
    "stale-heartbeat": ("hang", 2, 1, 1, 1, 0.5, []),
    "replay-orphaned": ("done", 4, 2, 2, 3, 0, [
        {"ev": "shard-launched", "shard": 0, "pid": -1, "attempt": 1,
         "ts": 1.0},
        {"ev": "shard-launched", "shard": 1, "pid": -1, "attempt": 1,
         "ts": 1.0}]),
}


def _drive(side, fleet_dir, scenario):
    plan_mod, sched_mod, policy_cls = SIDES[side]
    behaviour, n, shards, workers, budget, stale, prior = SCENARIOS[
        scenario]
    specs = plan_mod.build_plan([f"g{i}.fna" for i in range(n)], shards)
    for rec in prior:
        atomic.append_jsonl(plan_mod.events_path(fleet_dir), rec)
    sched = sched_mod.FleetScheduler(
        fleet_dir, specs, _fake_argv(fleet_dir, behaviour),
        workers=workers, poll_s=0.02, heartbeat_s=1 if stale else 0,
        stale_s=stale, policy=policy_cls(max_attempts=budget,
                                         base_delay=0.01, max_delay=0.02,
                                         jitter=0.0, seed=0))
    snap = sched.run()
    snap.pop("fleet_dir")
    records, torn = atomic.read_jsonl(plan_mod.events_path(fleet_dir))
    assert torn == 0
    by_shard = {}
    for rec in records:
        assert isinstance(rec["ts"], float)
        rec = {k: v for k, v in rec.items() if k not in ("ts", "pid")}
        by_shard.setdefault(rec.get("shard"), []).append(rec)
    return snap, by_shard


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_equals_galah_tpus(tmp_path, scenario):
    """Over the same fake workers the port's scheduler gives galah_tpu's
    snapshot and, shard by shard, its event records (less time stamps
    and pids; workers race each other, so the shards' interleaving may
    differ)."""
    got = {side: _drive(side, str(tmp_path / side), scenario)
           for side in SIDES}
    assert got["port"] == got["jax"]
    snap, by_shard = got["port"]
    chains = [s["preemptions"] for s in snap["shards"]]
    if scenario == "done":
        assert snap["shards_done"] == 3 and snap["preemptions"] == 0
        assert [s["attempts"] for s in snap["shards"]] == [1, 1, 1]
    elif scenario == "exit-75-reassigned":
        assert snap["shards_done"] == 2 and snap["reassignments"] == 2
        assert chains == [["exit-75"], ["exit-75"]]
        assert [r["resume"] for r in by_shard[0]
                if r["ev"] == "shard-launched"] == [False, False]
    elif scenario in ("budget-quarantine", "no-distances"):
        reason = "exit-3" if scenario == "budget-quarantine" \
            else "no-distances"
        assert snap["shards_failed"] == 1 and chains == [[reason] * 2]
        assert by_shard[0][-1] == {"ev": "fleet-shard-failed", "shard": 0,
                                   "attempts": 2, "faults": 2}
    elif scenario == "stale-heartbeat":
        assert snap["shards_failed"] == 1
        assert chains == [["stale-heartbeat"]]
    else:
        assert snap["resumed"] is True and snap["shards_done"] == 2
        assert chains == [["orphaned"], ["orphaned"]]
        assert [s["attempts"] for s in snap["shards"]] == [2, 2]
        assert snap["retry_spend_s"] == 0.0
    assert by_shard[None][-1]["ev"] == "fleet-supervise-done"


def _sleeper(env):
    """A process in a session of its own that sleeps; returns it once it
    has exec'd (its /proc environ is then its own)."""
    ready = "print('ready', flush=True); import time; time.sleep(60)"
    proc = subprocess.Popen([sys.executable, "-c", ready], env=env,
                            stdout=subprocess.PIPE, start_new_session=True)
    proc.stdout.readline()
    return proc


def test_replay_adopts_only_stamped_orphans(tmp_path):
    """A restarted supervisor kills the workers of its dir that a killed
    predecessor left running (by the GALAH_TPU_FLEET_WORKER stamp in
    their environment), whether or not an event names their pid, and
    never a process without the stamp whose pid an event names."""
    fleet_dir = str(tmp_path)
    specs = tplan.build_plan([f"g{i}.fna" for i in range(3)], 3)
    sched = tsched.FleetScheduler(
        fleet_dir, specs, _fake_argv(fleet_dir, "done"), workers=3,
        poll_s=0.02, heartbeat_s=0,
        policy=TPolicy(max_attempts=3, base_delay=0.01, jitter=0.0))
    clean = {k: v for k, v in os.environ.items()
             if k != "GALAH_TPU_FLEET_WORKER"}
    named, unnamed = _sleeper(sched.base_env), _sleeper(sched.base_env)
    bystander = _sleeper(clean)
    try:
        log = tplan.events_path(fleet_dir)
        for sid, proc in ((0, named), (1, bystander)):
            atomic.append_jsonl(log, {"ev": "shard-launched", "shard": sid,
                                      "attempt": 1, "pid": -1, "ts": 1.0})
            atomic.append_jsonl(log, {"ev": "shard-started", "shard": sid,
                                      "attempt": 1, "pid": proc.pid,
                                      "ts": 1.0})
        atomic.append_jsonl(log, {"ev": "shard-launched", "shard": 2,
                                  "attempt": 1, "pid": -1, "ts": 1.0})
        snap = sched.run()
        assert named.wait(timeout=10) == -signal.SIGKILL
        assert unnamed.wait(timeout=10) == -signal.SIGKILL
        assert bystander.poll() is None
        assert snap["shards_done"] == 3
        assert [s["preemptions"] for s in snap["shards"]] == [["orphaned"]] * 3
    finally:
        for proc in (named, unnamed, bystander):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()


def test_stale_probe_ages_from_this_attempt(tmp_path):
    """A beat left by an earlier attempt does not age a new one: the
    probe counts from this attempt's launch, and fires once the attempt
    itself has gone quiet; a launch drops the earlier attempt's
    heartbeat file."""
    fleet_dir = str(tmp_path)
    specs = tplan.build_plan(["g0.fna", "g1.fna"], 1)
    sched = tsched.FleetScheduler(
        fleet_dir, specs, _fake_argv(fleet_dir, "done"), workers=1,
        poll_s=0.02, heartbeat_s=1, stale_s=30,
        policy=TPolicy(max_attempts=3, base_delay=0.01, jitter=0.0))
    hb = tsched.shard_heartbeat_path(fleet_dir, 0)
    os.makedirs(os.path.dirname(hb), exist_ok=True)
    atomic.append_jsonl(hb, {"beat": 7, "ts": 1.0})

    class _StillRunning:
        def poll(self):
            return None

    rt = sched.shards[0]
    rt.proc, rt.pgid, rt.status = _StillRunning(), None, "running"
    rt.launched_wall = time.time()
    sched._poll_one(rt)
    assert rt.status == "running" and sched.preemptions == 0
    rt.launched_wall = time.time() - 3600
    sched._poll_one(rt)
    assert rt.status == "pending" and rt.preemptions == ["stale-heartbeat"]
    sched._launch(rt)
    try:
        assert not os.path.exists(hb)
    finally:
        rt.proc.wait(timeout=10)
        tinterrupt.unregister_worker_group(rt.pgid)


def test_worker_stamp_is_required(tmp_path):
    """Only a process whose environment carries this fleet dir's stamp
    is ours; a bystander whose command line names the shard dir is
    not, and a pid that is gone is not."""
    fleet_dir = str(tmp_path)
    sched = tsched.FleetScheduler(fleet_dir, tplan.build_plan(["g"], 1),
                                  _fake_argv(fleet_dir, "done"))
    assert sched.base_env["GALAH_TPU_FLEET_WORKER"] == os.path.abspath(
        fleet_dir)
    clean = {k: v for k, v in os.environ.items()
             if k != "GALAH_TPU_FLEET_WORKER"}
    shard_path = os.path.join(fleet_dir, "shards", "shard_000")
    ready = "print('ready', flush=True); import time; time.sleep(60)"
    bystander = subprocess.Popen(
        [sys.executable, "-c", ready, shard_path, "galah_tpu_torch"],
        env=clean, stdout=subprocess.PIPE)
    worker = subprocess.Popen([sys.executable, "-c", ready],
                              env=sched.base_env, stdout=subprocess.PIPE)
    try:
        bystander.stdout.readline()
        worker.stdout.readline()
        assert sched._is_our_worker(bystander.pid) is False
        assert sched._is_our_worker(worker.pid) is True
        assert sched._is_our_worker(2 ** 22 + 1234) is False
    finally:
        for p in (bystander, worker):
            p.kill()
            p.wait()
            p.stdout.close()


def test_cooperative_stop_shuts_workers_down(tmp_path):
    """A stop requested while workers run: every live worker gets
    SIGTERM, its shard goes back to pending uncharged
    (fleet-interrupted), the log records fleet-interrupted, and run()
    raises PreemptionRequested at fleet-poll with no worker left."""
    fleet_dir = str(tmp_path)
    specs = tplan.build_plan([f"g{i}.fna" for i in range(4)], 2)
    sched = tsched.FleetScheduler(
        fleet_dir, specs, _fake_argv(fleet_dir, "hang"), workers=2,
        poll_s=0.02, heartbeat_s=0, stale_s=5,
        policy=TPolicy(max_attempts=3, base_delay=0.01, jitter=0.0))
    real_launch = sched._launch
    launched = []

    def launch(rt):
        real_launch(rt)
        launched.append(rt.proc)
        if len(launched) == 2:
            tinterrupt.request_stop("SIGTERM")

    sched._launch = launch
    tinterrupt.reset()
    try:
        with pytest.raises(tinterrupt.PreemptionRequested) as e:
            sched.run()
    finally:
        tinterrupt.reset()
    assert e.value.boundary == "fleet-poll"
    assert [p.poll() for p in launched] == [-signal.SIGTERM] * 2
    snap = sched.snapshot()
    assert [s["preemptions"] for s in snap["shards"]] == [
        ["fleet-interrupted"]] * 2
    assert all(rt.faults == 0 for rt in sched.shards)
    evs = [r["ev"] for r in atomic.read_jsonl(
        tplan.events_path(fleet_dir))[0]]
    assert evs[-1] == "fleet-interrupted"


def test_second_signal_forwards_sigterm_to_worker_groups():
    """The first signal only requests a stop; the second sends SIGTERM
    to every registered worker group, then exits 75."""
    child = textwrap.dedent(f"""
        import subprocess, sys, time
        sys.path.insert(0, {REPO!r})
        from galah_tpu_torch.resilience import interrupt
        interrupt.install()
        worker = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(120)"],
            start_new_session=True)
        interrupt.register_worker_group(worker.pid)
        print(worker.pid, flush=True)
        while True:
            time.sleep(0.05)
    """)
    proc = subprocess.Popen([sys.executable, "-c", child],
                            stdout=subprocess.PIPE)
    wpid = None
    try:
        wpid = int(proc.stdout.readline())
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.3)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert rc == 75
    deadline = time.monotonic() + 5
    alive = True
    while alive and time.monotonic() < deadline:
        try:
            os.kill(wpid, 0)
            time.sleep(0.05)
        except ProcessLookupError:
            alive = False
    if alive:
        os.kill(wpid, signal.SIGKILL)
    assert not alive, "the worker outlived the supervisor's hard exit"


def test_worker_groups_reset_and_unregister():
    tinterrupt.reset()
    tinterrupt.register_worker_group(12345)
    tinterrupt.register_worker_group(12345)
    assert tinterrupt._WORKER_GROUPS == [12345]
    tinterrupt.unregister_worker_group(12345)
    tinterrupt.unregister_worker_group(12345)
    assert tinterrupt._WORKER_GROUPS == []
    tinterrupt.register_worker_group(2 ** 22 + 1234)  # gone: skipped
    tinterrupt.forward_to_worker_groups()
    assert not tinterrupt.stop_requested()
    tinterrupt.request_stop()
    assert tinterrupt.stop_requested()
    tinterrupt.reset()
    assert tinterrupt._WORKER_GROUPS == [] and not tinterrupt.stop_requested()


# -- merge -----------------------------------------------------------------


class _Stub:
    """distances_subset over a prebuilt cross-pair dict, checking that
    the keep predicate passes every cross-shard pair."""

    def __init__(self, cross, cache_cls):
        self.cross, self.cache_cls = cross, cache_cls

    def distances_subset(self, genome_paths, keep):
        cache = self.cache_cls()
        for (i, j), v in self.cross.items():
            assert keep(i, j), (i, j)
            cache.insert((i, j), v)
        return cache


def _write_shard_npz(fleet_dir, shard_id, local_pairs):
    path = tsched.shard_distances_path(fleet_dir, shard_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys = sorted(local_pairs)
    atomic.write_npz(path, {
        "ii": np.array([k[0] for k in keys], dtype=np.int64),
        "jj": np.array([k[1] for k in keys], dtype=np.int64),
        "vals": np.array([local_pairs[k] or 0.0 for k in keys],
                         dtype=np.float64),
        "has_val": np.array([local_pairs[k] is not None for k in keys],
                            dtype=bool)})


@pytest.mark.parametrize("cross,want", [
    # g3 first joins rep 0 at 99.1, then re-homes to the later rep g5
    # (99.2 beats 99.1), leaving g4 alone: the cross-shard rep/member
    # flip that a merge of shard representatives would miss
    ({(0, 3): 99.1}, [[0, 1, 2], [4], [5, 3]]),
    ({}, [[0, 1, 2], [3, 4, 5]]),
])
def test_merge_equals_galah_tpus(tmp_path, cross, want):
    fleet_dir = str(tmp_path)
    genomes = [f"g{i}.fna" for i in range(6)]
    shards = tplan.build_plan(genomes, 2)
    _write_shard_npz(fleet_dir, 0, {(0, 1): 99.0, (0, 2): 98.5,
                                    (1, 2): None})
    _write_shard_npz(fleet_dir, 1, {(0, 1): 97.5, (0, 2): 99.2})
    # shard 1 spans [3, 6): its local (0, 2) is global (3, 5); the
    # screen miss (has_val False) is dropped, not merged as 0.0
    pairs = tmerge.load_shard_pairs(fleet_dir, shards)
    assert pairs == jmerge.load_shard_pairs(
        fleet_dir, jplan.build_plan(genomes, 2))
    assert pairs == {(0, 1): 99.0, (0, 2): 98.5, (3, 4): 97.5,
                     (3, 5): 99.2}
    got = tmerge.merge(fleet_dir, genomes, shards,
                       _Stub(cross, tcache.PairDistanceCache), 95.0)
    assert got == jmerge.merge(fleet_dir, genomes,
                               jplan.build_plan(genomes, 2),
                               _Stub(cross, jcache.PairDistanceCache),
                               95.0) == want
    lookup = tmerge.shard_lookup(shards)
    assert [lookup(g) for g in range(6)] == [0, 0, 0, 1, 1, 1]
    with pytest.raises(IndexError):
        lookup(6)


def _pair_dict(cache):
    return {k: cache.get(k) for k in cache.keys()}


@pytest.mark.parametrize("route", ["tiles", "collision"])
def test_distances_subset(fleet_corpus, monkeypatch, route):
    """The port's distances_subset equals its distances() restricted to
    the kept pairs, on the tiled screen and on the collision screen
    (the route above the N >= 1024 crossover), and equals galah_tpu's
    distances_subset."""
    paths, _ = fleet_corpus
    if route == "collision":
        monkeypatch.setattr(tcollision, "SPARSE_SCREEN_MIN_N", 0)
    monkeypatch.setattr(jcollision, "SPARSE_SCREEN_MIN_N", 0)
    lookup = tmerge.shard_lookup(tplan.build_plan(paths, 3))

    def keep(i, j):
        return lookup(i) != lookup(j)

    pre = TSkaniPre(0.95, 0.15, TStore(CPU))
    full = _pair_dict(pre.distances(paths))
    got = _pair_dict(pre.distances_subset(paths, keep))
    assert got == {k: v for k, v in full.items() if keep(*k)}
    assert got and len(got) < len(full)
    want = _pair_dict(JSkaniPre(0.95, 0.15, JStore(k=15))
                      .distances_subset(paths, keep))
    assert got == want


# -- one whole fleet run ---------------------------------------------------


def _fleet_cli(*argv, torch_free=False):
    """`python -m galah_tpu_torch fleet ...` in a fresh interpreter;
    with `torch_free`, it must end with no torch in sys.modules."""
    code = ("import sys\n"
            "from galah_tpu_torch.cli import main\n"
            f"rc = main(['fleet', *{list(argv)!r}])\n"
            "assert 'torch' not in sys.modules or not "
            f"{torch_free!r}, 'torch was imported'\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)


def test_fleet_run_equals_cluster_runs(fleet_corpus, tmp_path, monkeypatch,
                                       root_logger):
    """`python -m galah_tpu_torch fleet run --device cpu --workers 2
    --shards 3` writes the TSV bytes of the port's `cluster` and of
    galah_tpu's; `fleet status` shows every shard done and `fleet
    analyze` a blame table summing to the fleet wall, both without
    torch; the supervisor's report passes galah_tpu's validate."""
    paths, _ = fleet_corpus
    fleet_dir = tmp_path / "fl"
    out, report = tmp_path / "fleet.tsv", tmp_path / "supervisor.json"
    run = subprocess.run(
        [sys.executable, "-m", "galah_tpu_torch", "fleet", "run",
         "--device", "cpu", "-f", *paths, "--workers", "2", "--shards",
         "3", "--stale-s", "300", "--fleet-dir", str(fleet_dir),
         "--run-report", str(report), "--output-cluster-definition",
         str(out)], cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    single, jtsv = tmp_path / "single.tsv", tmp_path / "jax.tsv"
    assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                      "--output-cluster-definition", str(single)]) == 0
    monkeypatch.setattr(jcollision, "SPARSE_SCREEN_MIN_N", 0)
    assert jmain(["cluster", "-f", *paths,
                  "--output-cluster-definition", str(jtsv)]) == 0
    assert out.read_bytes() == single.read_bytes() == jtsv.read_bytes()
    assert len(out.read_text().splitlines()) == len(paths)

    rep = json.loads(report.read_text())
    assert jreport.validate(rep) == []
    assert rep["fleet"]["shards_done"] == 3
    assert rep["fleet"]["n_genomes"] == len(paths)
    assert rep["counters"]["fleet-within-shard-pairs"] > 0
    assert rep["counters"]["fleet-cross-shard-pairs"] > 0
    assert "fleet_rollup" in rep
    for sid in range(3):
        shard_rep = json.loads(open(tsched.shard_report_path(
            str(fleet_dir), sid)).read())
        assert jreport.validate(shard_rep) == []

    status = _fleet_cli("status", str(fleet_dir), torch_free=True)
    assert status.returncode == 0, status.stderr
    assert status.stdout == jsched.render_status(str(fleet_dir))
    rows = [ln for ln in status.stdout.splitlines()
            if ln.lstrip().startswith("shard ")]
    assert len(rows) == 3 and all(" done " in ln for ln in rows)
    analyze = _fleet_cli("analyze", "--json", str(fleet_dir),
                         torch_free=True)
    assert analyze.returncode == 0, analyze.stderr
    ru = json.loads(analyze.stdout)
    blame = sum(c["blame_s"] for c in ru["components"].values())
    assert abs(blame - ru["fleet_wall_s"]) <= 1e-5
    fleet_report = json.loads((fleet_dir / "fleet_report.json").read_text())
    assert jreport.validate(fleet_report) == []
    assert _fleet_cli("analyze", str(tmp_path / "none")).returncode == 1
