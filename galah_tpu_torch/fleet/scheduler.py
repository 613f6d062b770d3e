"""The fleet supervisor: launch, watch and reassign preemptible workers.
The port's copy of ``galah_tpu/fleet/scheduler.py``.

One ``python -m galah_tpu_torch cluster`` worker subprocess per shard,
each in its own session (pgid == pid, so a signal reaches the worker's
whole tree), at most ``workers`` live at once. Three things mean the
same event, preemption: exit 75 (a cooperative stop), death by signal
(a SIGKILLed spot worker) and a stale heartbeat (a wedged worker, which
the supervisor kills). A preempted shard goes back to pending and is
reassigned to a fresh worker that resumes from the shard's checkpoint.
Worker faults are budgeted by ``RetryPolicy.from_env(
"GALAH_TPU_FLEET_RETRY")``; a shard that spends its budget is
quarantined with a ``fleet-shard-failed`` event instead of wedging the
fleet.

Every decision is appended to ``fleet_events.jsonl`` (framed, fsynced
appends of ``io/atomic.py``) before it is acted on, so a supervisor that
is itself SIGKILLed replays the log on restart, kills the orphaned
workers it finds (only processes whose environment carries this fleet
directory's ``GALAH_TPU_FLEET_WORKER`` stamp) and continues.

The supervisor is a single-threaded poll loop on the main thread; the
workers' parallelism lives in their processes. This module imports no
torch: ``fleet status`` renders from it on any host.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from galah_tpu_torch.fleet import plan as plan_mod
from galah_tpu_torch.fleet.plan import ShardSpec
from galah_tpu_torch.io import atomic
from galah_tpu_torch.obs import events as obs_events
from galah_tpu_torch.obs import metrics
from galah_tpu_torch.obs.heartbeat import read_latest_beat
from galah_tpu_torch.resilience import interrupt
from galah_tpu_torch.resilience.policy import RetryPolicy

logger = logging.getLogger(__name__)

#: the shard artifact a worker must leave for the merge (the
#: checkpoint's distance pass, ``cluster/checkpoint.py``)
DISTANCES_FILENAME = "precluster_distances.npz"

#: preemption reasons on the supervisor's side (its own stop, orphan
#: adoption): they reassign the shard but never charge its retry
#: budget, or an interrupted and resumed fleet would quarantine healthy
#: shards
UNCHARGED_REASONS = frozenset({"fleet-interrupted", "orphaned"})


# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): the
# supervisor is a single-threaded poll loop on the main thread; worker
# parallelism lives in subprocesses, not threads, so there is no locked
# shared state to declare.
GUARDED_BY = {}
LOCK_ORDER = []


def _wall() -> float:
    # galah-lint: ignore[GL701] event timestamps and beat ages, not durations
    return time.time()


def append_stamp(fleet_dir: str, ev: str, **fields: Any) -> None:
    """Append one timestamped event to the fleet's event log; the
    scheduler and the CLI's merge phase share it, so ``obs/fleet_view``
    reads the fleet wall from one ordered log."""
    rec: Dict[str, Any] = {"ev": ev, "ts": _wall()}
    rec.update(fields)
    atomic.append_jsonl(plan_mod.events_path(fleet_dir), rec,
                        site="fleet-events")


def shard_root(fleet_dir: str, shard_id: int) -> str:
    return plan_mod.shard_dir(fleet_dir, shard_id)


def shard_ckpt_dir(fleet_dir: str, shard_id: int) -> str:
    return os.path.join(shard_root(fleet_dir, shard_id), "ckpt")


def shard_report_path(fleet_dir: str, shard_id: int) -> str:
    return os.path.join(shard_root(fleet_dir, shard_id), "run_report.json")


def shard_heartbeat_path(fleet_dir: str, shard_id: int) -> str:
    # the worker's heartbeat thread writes beside its run report
    return os.path.join(shard_root(fleet_dir, shard_id), "heartbeat.jsonl")


def shard_tsv_path(fleet_dir: str, shard_id: int) -> str:
    return os.path.join(shard_root(fleet_dir, shard_id), "clusters.tsv")


def shard_distances_path(fleet_dir: str, shard_id: int) -> str:
    return os.path.join(shard_ckpt_dir(fleet_dir, shard_id),
                        DISTANCES_FILENAME)


@dataclass
class _ShardRuntime:
    spec: ShardSpec
    attempts: int = 0              # launches over the fleet's life
    faults: int = 0                # preemptions charged to the budget
    status: str = "pending"        # pending|running|done|failed
    proc: Optional[subprocess.Popen] = None
    pgid: Optional[int] = None
    launched_wall: float = 0.0
    next_eligible_mono: float = 0.0
    preemptions: List[str] = field(default_factory=list)


class FleetScheduler:
    """Supervise one fleet run over ``shards`` inside ``fleet_dir``.

    ``worker_argv(spec, resume)`` builds a worker's command line (the
    CLI owns the flags, the scheduler the lifecycle). ``run()`` returns
    the snapshot that becomes the run report's ``fleet`` section; it
    raises ``interrupt.PreemptionRequested`` when the supervisor itself
    is stopped.
    """

    def __init__(self, fleet_dir: str, shards: Sequence[ShardSpec],
                 worker_argv: Callable[[ShardSpec, bool], List[str]],
                 workers: int = 2, stale_s: float = 30.0,
                 poll_s: float = 0.2, heartbeat_s: float = 1.0,
                 policy: Optional[RetryPolicy] = None,
                 env: Optional[Dict[str, str]] = None) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.fleet_dir = fleet_dir
        self.worker_argv = worker_argv
        self.workers = workers
        self.stale_s = stale_s
        self.poll_s = poll_s
        self.heartbeat_s = heartbeat_s
        self.policy = policy or RetryPolicy.from_env(
            "GALAH_TPU_FLEET_RETRY", defaults={"seed": 0})
        self.base_env = dict(os.environ if env is None else env)
        # faults are injected into a fleet by killing its processes;
        # an io fault inside a worker would change what it computes
        self.base_env.pop("GALAH_FI", None)
        self.base_env["GALAH_OBS_HEARTBEAT_S"] = (
            str(self.heartbeat_s) if self.heartbeat_s > 0 else "0")
        # the stamp depends only on the fleet dir, so a later supervisor
        # of the same dir recognises an earlier one's workers; matching
        # /proc/<pid>/environ rather than the command line means a
        # bystander whose argv merely names a shard path is never killed
        self._worker_stamp = ("GALAH_TPU_FLEET_WORKER="
                              + os.path.abspath(self.fleet_dir))
        self.base_env["GALAH_TPU_FLEET_WORKER"] = os.path.abspath(
            self.fleet_dir)
        self.shards = [_ShardRuntime(spec=s) for s in shards]
        self.preemptions = 0
        self.reassignments = 0
        self.retry_spend_s = 0.0
        self.resumed = False

    # -- the event log ---------------------------------------------------

    def _append_event(self, ev: str, **fields: Any) -> None:
        append_stamp(self.fleet_dir, ev, **fields)

    def _replay_events(self) -> List[Dict[str, Any]]:
        records, torn = atomic.read_jsonl(
            plan_mod.events_path(self.fleet_dir))
        if torn:
            logger.warning("fleet event log: %d torn record(s) skipped",
                           torn)
        launched_pids: Dict[int, int] = {}
        for rec in records:
            if not isinstance(rec, dict):
                continue
            ev = rec.get("ev")
            sid = rec.get("shard")
            rt = (self.shards[sid] if isinstance(sid, int)
                  and 0 <= sid < len(self.shards) else None)
            if rt is None:
                continue
            if ev == "shard-launched":
                rt.attempts += 1
                launched_pids[sid] = int(rec.get("pid") or 0)
            elif ev == "shard-started":
                launched_pids[sid] = int(rec.get("pid") or 0)
            elif ev == "shard-preempted":
                reason = str(rec.get("reason") or "unknown")
                rt.preemptions.append(reason)
                self.preemptions += 1
                self.reassignments += 1
                if reason not in UNCHARGED_REASONS:
                    rt.faults += 1
                launched_pids.pop(sid, None)
            elif ev == "shard-done":
                rt.status = "done"
                launched_pids.pop(sid, None)
            elif ev == "fleet-shard-failed":
                rt.status = "failed"
                launched_pids.pop(sid, None)
        if records:
            self.resumed = True
        # a pid launched and never accounted for is an orphan of a
        # killed supervisor: kill it (its checkpoint makes the relaunch
        # cheap), once its environment proves it is ours and not a
        # recycled pid
        for sid, pid in launched_pids.items():
            rt = self.shards[sid]
            if rt.status in ("done", "failed"):
                continue
            if pid > 0 and self._is_our_worker(pid):
                try:
                    os.killpg(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            self._preempt(rt, "orphaned", charge=False)
        if self.resumed:
            self._sweep_orphans()
        return records

    def _sweep_orphans(self) -> None:
        """A supervisor killed between the pre-act launch record and the
        pid record leaves a worker that no event names: kill every
        process group that carries this fleet dir's stamp before
        relaunching anything, since two writers on one shard
        checkpoint would race."""
        try:
            pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
        except OSError:
            return
        me = os.getpid()
        for pid in pids:
            if pid != me and self._is_our_worker(pid):
                try:
                    os.killpg(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

    def _is_our_worker(self, pid: int) -> bool:
        # the environment (NUL-framed, readable by the same uid) cannot
        # be spoofed as a command line can: only our workers inherit it
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env_blob = f.read()
        except OSError:
            return False
        return self._worker_stamp.encode() in env_blob.split(b"\0")

    # -- lifecycle -------------------------------------------------------

    def _launch(self, rt: _ShardRuntime) -> None:
        sid = rt.spec.shard_id
        os.makedirs(shard_root(self.fleet_dir, sid), exist_ok=True)
        # a worker killed mid report-write leaves *.tmp in its shard
        # root; the root has one owner between launches (the worker's
        # checkpoint open sweeps the ckpt subdir)
        atomic.sweep_tmp(shard_root(self.fleet_dir, sid))
        # the previous attempt's heartbeat must not outlive it: its last
        # beat would read as stale before the new worker's first lands
        try:
            os.unlink(shard_heartbeat_path(self.fleet_dir, sid))
        except OSError:
            pass
        resume = os.path.exists(os.path.join(
            shard_ckpt_dir(self.fleet_dir, sid), "fingerprint.json"))
        argv = self.worker_argv(rt.spec, resume)
        rt.attempts += 1
        self._append_event("shard-launched", shard=sid,
                           attempt=rt.attempts, resume=resume, pid=-1)
        proc = subprocess.Popen(argv, env=self.base_env,
                                stdout=subprocess.DEVNULL,
                                start_new_session=True)
        rt.proc = proc
        rt.pgid = proc.pid
        rt.launched_wall = _wall()
        rt.status = "running"
        interrupt.register_worker_group(proc.pid)
        # a second record with the real pid: the pre-act record above
        # keeps the attempt visible to a replay even if the supervisor
        # dies inside Popen
        self._append_event("shard-started", shard=sid,
                           attempt=rt.attempts, pid=proc.pid)
        logger.info("fleet: shard %d attempt %d -> pid %d%s", sid,
                    rt.attempts, proc.pid, " (resume)" if resume else "")

    def _preempt(self, rt: _ShardRuntime, reason: str,
                 charge: bool = True) -> None:
        sid = rt.spec.shard_id
        if rt.pgid is not None:
            interrupt.unregister_worker_group(rt.pgid)
        rt.proc = None
        rt.pgid = None
        self._append_event("shard-preempted", shard=sid,
                           attempt=rt.attempts, reason=reason)
        obs_events.record("fleet-preempted", shard=sid, reason=reason)
        rt.preemptions.append(reason)
        self.preemptions += 1
        self.reassignments += 1
        if charge and reason not in UNCHARGED_REASONS:
            rt.faults += 1
        if rt.faults >= self.policy.max_attempts:
            rt.status = "failed"
            self._append_event("fleet-shard-failed", shard=sid,
                               attempts=rt.attempts, faults=rt.faults)
            obs_events.record("fleet-shard-failed", shard=sid,
                              attempts=rt.attempts)
            logger.error("fleet: shard %d quarantined after %d fault(s) "
                         "(retry budget %d)", sid, rt.faults,
                         self.policy.max_attempts)
            return
        backoff = self.policy.delay(max(0, rt.faults - 1),
                                    site=f"fleet-shard-{sid}")
        if reason in UNCHARGED_REASONS:
            backoff = 0.0
        rt.next_eligible_mono = time.monotonic() + backoff
        self.retry_spend_s += backoff
        if backoff > 0:
            # fleet_view charges this window to the scheduler's backoff
            # without re-deriving the retry policy
            self._append_event("shard-backoff", shard=sid,
                               backoff_s=round(backoff, 6))
        rt.status = "pending"
        logger.warning("fleet: shard %d preempted (%s), reassigning",
                       sid, reason)

    def _kill_group(self, rt: _ShardRuntime) -> None:
        if rt.pgid is None:
            return
        try:
            os.killpg(rt.pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        if rt.proc is not None:
            try:
                rt.proc.wait(timeout=10)
            except Exception:
                logger.debug("worker wait after kill failed",
                             exc_info=True)

    def _poll_one(self, rt: _ShardRuntime) -> None:
        sid = rt.spec.shard_id
        proc = rt.proc
        if proc is None:
            return
        rc = proc.poll()
        if rc is None:
            if self.heartbeat_s > 0 and self.stale_s > 0:
                beat = read_latest_beat(
                    shard_heartbeat_path(self.fleet_dir, sid))
                # a beat older than this attempt's launch must not age
                # it, or every relaunched worker is killed at once
                ref = rt.launched_wall
                if beat:
                    ref = max(ref, float(beat.get("ts") or 0.0))
                if _wall() - ref > self.stale_s:
                    self._kill_group(rt)
                    self._preempt(rt, "stale-heartbeat")
            return
        if rc == 0:
            if os.path.exists(shard_distances_path(self.fleet_dir, sid)):
                if rt.pgid is not None:
                    interrupt.unregister_worker_group(rt.pgid)
                rt.proc = None
                rt.pgid = None
                rt.status = "done"
                self._append_event("shard-done", shard=sid,
                                   attempt=rt.attempts)
                logger.info("fleet: shard %d done (attempt %d)", sid,
                            rt.attempts)
            else:
                # an exit 0 without the merge's artifact is a fault, so
                # the budget bounds a worker that "succeeds" wrongly
                self._preempt(rt, "no-distances")
        elif rc == interrupt.EXIT_PREEMPTED:
            self._preempt(rt, "exit-75")
        elif rc < 0:
            self._preempt(rt, f"signal-{-rc}")
        else:
            self._preempt(rt, f"exit-{rc}")

    def _launch_eligible(self) -> None:
        live = sum(1 for rt in self.shards if rt.status == "running")
        now = time.monotonic()
        for rt in self.shards:  # shard order: deterministic placement
            if live >= self.workers:
                return
            if rt.status == "pending" and rt.next_eligible_mono <= now:
                self._launch(rt)
                live += 1

    def _shutdown_workers(self) -> None:
        """The cooperative stop: SIGTERM every live worker group, give
        them one staleness window to reach a safe boundary, then SIGKILL
        the stragglers. Their shards go back to pending, uncharged; the
        resume relaunches them."""
        live = [rt for rt in self.shards if rt.status == "running"]
        for rt in live:
            if rt.pgid is None:
                continue
            try:
                os.killpg(rt.pgid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.monotonic() + max(self.stale_s, 5.0)
        for rt in live:
            if rt.proc is None:
                continue
            remaining = deadline - time.monotonic()
            try:
                rt.proc.wait(timeout=max(0.1, remaining))
            except subprocess.TimeoutExpired:
                self._kill_group(rt)
            self._preempt(rt, "fleet-interrupted", charge=False)

    def _update_gauges(self) -> None:
        live = sum(1 for rt in self.shards if rt.status == "running")
        done = sum(1 for rt in self.shards if rt.status == "done")
        metrics.gauge("fleet.workers_live",
                      help="live fleet worker subprocesses").set(live)
        metrics.gauge("fleet.shards_done",
                      help="shards completed").set(done)
        metrics.gauge("fleet.preemptions",
                      help="worker preemptions observed"
                      ).set(self.preemptions)
        metrics.gauge("fleet.reassignments",
                      help="shard reassignments to fresh workers"
                      ).set(self.reassignments)

    # -- run -------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        os.makedirs(self.fleet_dir, exist_ok=True)
        # the fleet dir has one owner, the supervisor: a supervisor
        # killed mid plan or event write leaves *.tmp only here
        atomic.sweep_tmp(self.fleet_dir)
        self._replay_events()
        try:
            while True:
                if interrupt.stop_requested():
                    self._shutdown_workers()
                    self._append_event("fleet-interrupted")
                    self._update_gauges()
                    interrupt.check("fleet-poll")
                for rt in self.shards:
                    self._poll_one(rt)
                self._launch_eligible()
                self._update_gauges()
                if all(rt.status in ("done", "failed")
                       for rt in self.shards):
                    break
                time.sleep(self.poll_s)
        finally:
            # never leak workers past the supervisor, whatever raised
            for rt in self.shards:
                if rt.status == "running":
                    self._kill_group(rt)
        self._update_gauges()
        # the supervise phase's end, so the rollup can split the fleet
        # wall into supervise and merge even without the final report
        self._append_event(
            "fleet-supervise-done",
            shards_done=sum(1 for rt in self.shards
                            if rt.status == "done"),
            retry_spend_s=round(self.retry_spend_s, 6))
        return self.snapshot()

    def snapshot(self) -> Dict[str, Any]:
        shards = [{
            "shard_id": rt.spec.shard_id,
            "lo": rt.spec.lo,
            "hi": rt.spec.hi,
            "n_genomes": len(rt.spec.genomes),
            "attempts": rt.attempts,
            "status": rt.status,
            "preemptions": list(rt.preemptions),
        } for rt in self.shards]
        return {
            "fleet_dir": os.path.abspath(self.fleet_dir),
            "n_shards": len(self.shards),
            "workers": self.workers,
            "shards_done": sum(1 for s in shards if s["status"] == "done"),
            "shards_failed": sum(1 for s in shards
                                 if s["status"] == "failed"),
            "preemptions": self.preemptions,
            "reassignments": self.reassignments,
            "retry_spend_s": round(self.retry_spend_s, 6),
            "resumed": self.resumed,
            "shards": shards,
        }


def render_status(fleet_dir: str) -> str:
    """The ``fleet status`` body: a fleet dir's plan, event log and
    heartbeat ages, rendered without a device."""
    doc = plan_mod.load_plan(fleet_dir)
    if doc is None:
        return (f"no fleet plan at {plan_mod.plan_path(fleet_dir)} "
                "(run `galah_tpu_torch fleet run` first)\n")
    shards = [ShardSpec.from_dict(d) for d in doc.get("shards", [])]
    records, torn = atomic.read_jsonl(plan_mod.events_path(fleet_dir))
    state: Dict[int, str] = {s.shard_id: "pending" for s in shards}
    attempts: Dict[int, int] = {s.shard_id: 0 for s in shards}
    preempts: Dict[int, int] = {s.shard_id: 0 for s in shards}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        sid = rec.get("shard")
        if sid not in state:
            continue
        ev = rec.get("ev")
        if ev == "shard-launched":
            attempts[sid] += 1
            state[sid] = "running"
        elif ev == "shard-preempted":
            preempts[sid] += 1
            state[sid] = "pending"
        elif ev == "shard-done":
            state[sid] = "done"
        elif ev == "fleet-shard-failed":
            state[sid] = "failed"
    lines = [f"fleet {fleet_dir}",
             f"  shards {len(shards)}  events {len(records)}"
             + (f"  ({torn} torn)" if torn else "")]
    for s in shards:
        hb = read_latest_beat(shard_heartbeat_path(fleet_dir, s.shard_id))
        age = ""
        if hb is not None and state[s.shard_id] == "running":
            age = (f"  beat-age "
                   f"{max(0.0, _wall() - float(hb.get('ts') or 0.0)):.1f}s")
        lines.append(
            f"  shard {s.shard_id:3d} [{s.lo}:{s.hi})  "
            f"{state[s.shard_id]:<8} attempts={attempts[s.shard_id]} "
            f"preemptions={preempts[s.shard_id]}{age}")
    return "\n".join(lines) + "\n"
