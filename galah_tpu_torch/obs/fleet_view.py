"""Fleet-wide observability: one view over every shard. The port's copy
of ``galah_tpu/obs/fleet_view.py``.

A fleet run (``fleet/scheduler.py``) leaves its telemetry in pieces: one
``fleet_events.jsonl`` for the supervisor, and for each shard a
``run_report.json`` and a ``heartbeat.jsonl`` under
``<fleet_dir>/shards/shard_NNN/``. This module stitches them together,
with no device and no live process state, so it runs on any host and
against any fleet dir, one that a kill left half-written included:

* :func:`rollup`: the run report's ``fleet_rollup`` section, the fleet
  wall split into scheduler blame (launch and backoff), compute blame
  for each shard, straggler wait (the fleet wall beyond the median shard
  wall, charged to the slowest shards by name) and the merge wall, whose
  seconds sum exactly to the fleet wall. A shard report with a flow
  critical path has its compute blame split by stage; the port's shard
  reports carry none, so their blame stays unsplit, as for
  ``galah_tpu``'s older reports;
* :func:`fleet_grid` / :func:`render_fleet_grid`: the per-shard grid
  (state, attempts, beat age, preemption chain, recent events);
* :func:`write_fleet_report`: a schema-valid ``fleet_report.json`` for
  ``fleet analyze``.

Torn event and heartbeat tails are skipped (framed records), a shard
dir deleted mid-read contributes nothing, and shard reports of either
package are read. :func:`rollup` returns ``None`` only when the dir
holds no event log (no fleet timeline to roll up). The module imports
no torch.
"""

from __future__ import annotations

import os
import re
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

from galah_tpu_torch.io import atomic

#: the aggregated report that ``fleet analyze`` writes
FLEET_REPORT_FILENAME = "fleet_report.json"

#: How many named slowest shards the straggler component carries.
MAX_NAMED_STRAGGLERS = 4

#: Events that open / close a shard's running interval on the fleet
#: timeline. Unknown event types are ignored (forward compatibility).
_OPEN_EVS = frozenset({"shard-launched", "shard-started"})
_CLOSE_EVS = frozenset({"shard-preempted", "shard-done",
                        "fleet-shard-failed"})

_SHARD_DIR_RE = re.compile(r"shard_(\d+)$")


def _wall() -> float:
    return time.time()


def fleet_report_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, FLEET_REPORT_FILENAME)


def is_fleet_dir(directory: str) -> bool:
    """True when ``directory`` holds a fleet plan or event log."""
    from galah_tpu_torch.fleet import plan as plan_mod

    return (os.path.exists(plan_mod.plan_path(directory))
            or os.path.exists(plan_mod.events_path(directory)))


# ------------------------------------------------------------ loading


def _load_events(fleet_dir: str) -> Tuple[List[dict], int]:
    from galah_tpu_torch.fleet import plan as plan_mod

    records, torn = atomic.read_jsonl(plan_mod.events_path(fleet_dir))
    evs = [r for r in records
           if isinstance(r, dict) and isinstance(r.get("ts"),
                                                 (int, float))]
    evs.sort(key=lambda r: float(r["ts"]))
    return evs, torn


def _shard_ids(fleet_dir: str, events: List[dict]) -> List[int]:
    """Planned shard ids; falls back to ids seen in events, then to
    shard dirs on disk, so a dir whose plan was torn still rolls up."""
    from galah_tpu_torch.fleet import plan as plan_mod

    doc = plan_mod.load_plan(fleet_dir)
    if doc is not None:
        ids = sorted({int(d.get("shard_id"))
                      for d in doc.get("shards", [])
                      if isinstance(d.get("shard_id"), int)})
        if ids:
            return ids
    ids = {int(r["shard"]) for r in events
           if isinstance(r.get("shard"), int)}
    shards_root = os.path.join(fleet_dir, "shards")
    try:
        for name in os.listdir(shards_root):
            m = _SHARD_DIR_RE.match(name)
            if m:
                ids.add(int(m.group(1)))
    except OSError:
        pass
    return sorted(ids)


def _load_shard_report(fleet_dir: str, sid: int) -> Optional[dict]:
    """Torn/missing-tolerant shard report load (never raises): a shard
    mid-write or deleted mid-aggregate reads as absent."""
    import json

    from galah_tpu_torch.fleet import scheduler as sched_mod

    try:
        with open(sched_mod.shard_report_path(fleet_dir, sid)) as f:
            rep = json.load(f)
    except (OSError, ValueError):
        return None
    return rep if isinstance(rep, dict) else None


def _latest_beat(fleet_dir: str, sid: int) -> Optional[dict]:
    from galah_tpu_torch.fleet import scheduler as sched_mod
    from galah_tpu_torch.obs.heartbeat import read_latest_beat

    try:
        return read_latest_beat(
            sched_mod.shard_heartbeat_path(fleet_dir, sid))
    except Exception:
        return None


# ------------------------------------------------------- interval math


def _union_length(intervals: List[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    clipped = sorted((max(lo, a), min(hi, b)) for a, b in intervals
                     if min(hi, b) > max(lo, a))
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _replay_intervals(events: List[dict], t_end: float
                      ) -> Dict[int, List[Tuple[float, float]]]:
    """Per-shard running intervals from the event log. A shard whose
    last attempt never closed (scheduler killed) closes at ``t_end``."""
    intervals: Dict[int, List[Tuple[float, float]]] = {}
    open_at: Dict[int, float] = {}
    for rec in events:
        sid = rec.get("shard")
        if not isinstance(sid, int):
            continue
        ev, ts = rec.get("ev"), float(rec["ts"])
        if ev in _OPEN_EVS:
            open_at.setdefault(sid, ts)
        elif ev in _CLOSE_EVS:
            start = open_at.pop(sid, None)
            if start is not None and ts > start:
                intervals.setdefault(sid, []).append((start, ts))
    for sid, start in open_at.items():
        if t_end > start:
            intervals.setdefault(sid, []).append((start, t_end))
    return intervals


# -------------------------------------------------------------- rollup


def rollup(fleet_dir: str) -> Optional[dict]:
    """The cross-shard critical path for ``fleet_dir``, or ``None``
    when the dir has no fleet event log (rollup-impossible).

    Conservation: ``scheduler + compute + straggler_wait + merge``
    blame seconds sum exactly to ``fleet_wall_s`` by construction —
    each bucket is defined as a remainder of the one before it.
    """
    events, torn = _load_events(fleet_dir)
    if not events:
        return None
    shard_ids = _shard_ids(fleet_dir, events)

    reports: Dict[int, Optional[dict]] = {
        sid: _load_shard_report(fleet_dir, sid) for sid in shard_ids}
    beats: Dict[int, Optional[dict]] = {
        sid: _latest_beat(fleet_dir, sid) for sid in shard_ids}

    t0 = float(events[0]["ts"])
    t_end = float(events[-1]["ts"])
    for beat in beats.values():
        if beat and isinstance(beat.get("ts"), (int, float)):
            t_end = max(t_end, float(beat["ts"]))
    fleet_wall = max(0.0, t_end - t0)

    # merge wall: the post-supervise stamp the CLI appends after the
    # cross-shard merge; clamped so a clock-skewed stamp cannot break
    # conservation
    merge_s = 0.0
    for rec in events:
        if rec.get("ev") == "fleet-merge-done":
            try:
                merge_s = float(rec.get("wall_s") or 0.0)
            except (TypeError, ValueError):
                merge_s = 0.0
    merge_s = min(max(0.0, merge_s), fleet_wall)
    supervise_end = t0 + (fleet_wall - merge_s)

    intervals = _replay_intervals(events, t_end)
    all_ivals = [iv for ivs in intervals.values() for iv in ivs]
    coverage = _union_length(all_ivals, t0, supervise_end)

    # scheduler blame: supervise time where NO shard was running —
    # launch latency, poll slack, and retry backoff. The backoff
    # bucket is bounded by the stamped backoff_s events; the rest is
    # launch/poll.
    sched_s = max(0.0, (fleet_wall - merge_s) - coverage)
    stamped_backoff = sum(
        float(r.get("backoff_s") or 0.0) for r in events
        if r.get("ev") == "shard-backoff")
    backoff_s = min(max(0.0, stamped_backoff), sched_s)
    launch_s = sched_s - backoff_s

    # per-shard walls (clipped to the supervise window, so queued
    # relaunches after a preemption never double-charge merge time)
    walls = {sid: _union_length(intervals.get(sid, []),
                                t0, supervise_end)
             for sid in shard_ids}
    positive = [w for w in walls.values() if w > 0]
    med = statistics.median(positive) if positive else 0.0

    # straggler wait: coverage beyond the median shard wall, charged
    # to the shards that ran longer than the median; the remainder is
    # genuine parallel compute
    straggler_s = (max(0.0, coverage - med)
                   if len(positive) >= 2 else 0.0)
    compute_s = coverage - straggler_s
    slowest = sorted(
        ({"shard": sid, "wall_s": round(w, 6),
          "excess_s": round(w - med, 6)}
         for sid, w in walls.items() if w > med),
        key=lambda d: -d["excess_s"])[:MAX_NAMED_STRAGGLERS]

    wall_sum = sum(walls.values())

    # per-shard detail: compute blame proportional to shard wall,
    # split further by the shard's own flow critical path when its
    # report carries one (v6+; older/missing reports stay unsplit)
    schema_versions: List[int] = []
    missing: List[int] = []
    shard_out: Dict[str, dict] = {}
    state: Dict[int, str] = {sid: "pending" for sid in shard_ids}
    attempts: Dict[int, int] = {sid: 0 for sid in shard_ids}
    preempts: Dict[int, int] = {sid: 0 for sid in shard_ids}
    for rec in events:
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
    for sid in shard_ids:
        rep = reports[sid]
        if rep is None:
            missing.append(sid)
        else:
            v = rep.get("version")
            if isinstance(v, int) and v not in schema_versions:
                schema_versions.append(v)
        blame = (compute_s * walls[sid] / wall_sum
                 if wall_sum > 0 else 0.0)
        entry: Dict[str, Any] = {
            "wall_s": round(walls[sid], 6),
            "blame_s": round(blame, 6),
            "share": round(blame / fleet_wall, 6)
            if fleet_wall > 0 else 0.0,
            "status": state[sid],
            "attempts": attempts[sid],
            "preemptions": preempts[sid],
            "report_version": (rep or {}).get("version"),
        }
        cp = ((rep or {}).get("flow") or {}).get("critical_path")
        if isinstance(cp, dict) and isinstance(cp.get("stages"), dict):
            entry["bottleneck"] = cp.get("bottleneck")
            entry["stages"] = {
                name: {"blame_s": round(
                    blame * float(st.get("share") or 0.0), 6),
                    "share": round(float(st.get("share") or 0.0), 6)}
                for name, st in cp["stages"].items()
                if isinstance(st, dict)}
        beat = beats[sid]
        if beat and isinstance(beat.get("ts"), (int, float)):
            entry["beat_age_s"] = round(
                max(0.0, _wall() - float(beat["ts"])), 3)
            if beat.get("role") is not None:
                entry["role"] = beat.get("role")
        shard_out[str(sid)] = entry

    def _share(v: float) -> float:
        return round(v / fleet_wall, 6) if fleet_wall > 0 else 0.0

    # the named bottleneck: largest single blame bucket, with a
    # winning shard narrowed to its own critical-path stage
    candidates: List[Tuple[float, str]] = [
        (sched_s, "scheduler"),
        (straggler_s, "straggler-wait"),
        (merge_s, "merge"),
    ]
    for sid in shard_ids:
        entry = shard_out[str(sid)]
        name = f"shard-{sid}"
        if entry.get("bottleneck"):
            name = f"shard-{sid}:{entry['bottleneck']}"
        candidates.append((entry["blame_s"], name))
    bottleneck = max(candidates, key=lambda c: c[0])[1] \
        if fleet_wall > 0 else None

    from galah_tpu_torch.fleet import plan as plan_mod

    return {
        "fleet_wall_s": round(fleet_wall, 6),
        "source": {
            "events": len(events),
            "torn_events": torn,
            "plan": plan_mod.load_plan(fleet_dir) is not None,
            "shards_planned": len(shard_ids),
            "shards_reported": len(shard_ids) - len(missing),
            "shards_missing": missing,
            "schema_versions": sorted(schema_versions),
        },
        "components": {
            "scheduler": {
                "blame_s": round(sched_s, 6),
                "share": _share(sched_s),
                "launch_s": round(launch_s, 6),
                "backoff_s": round(backoff_s, 6),
            },
            "compute": {
                "blame_s": round(compute_s, 6),
                "share": _share(compute_s),
            },
            "straggler_wait": {
                "blame_s": round(straggler_s, 6),
                "share": _share(straggler_s),
                "slowest": slowest,
            },
            "merge": {
                "blame_s": round(merge_s, 6),
                "share": _share(merge_s),
            },
        },
        "shards": shard_out,
        "bottleneck": bottleneck,
    }


def render_rollup(ru: dict, indent: str = "") -> List[str]:
    """The blame table of a rollup dict (``fleet analyze``'s body)."""
    src = ru.get("source", {})
    comps = ru.get("components", {})
    wall = float(ru.get("fleet_wall_s") or 0.0)
    lines = [
        f"{indent}fleet critical path "
        f"(wall {wall:.2f}s, {src.get('shards_reported', 0)}/"
        f"{src.get('shards_planned', 0)} shard reports"
        + (f", {src.get('torn_events')} torn" if src.get("torn_events")
           else "") + ")"]
    order = ("scheduler", "compute", "straggler_wait", "merge")
    for name in order:
        c = comps.get(name)
        if not isinstance(c, dict):
            continue
        extra = ""
        if name == "scheduler":
            extra = (f"  (launch {c.get('launch_s', 0.0):.2f}s, "
                     f"backoff {c.get('backoff_s', 0.0):.2f}s)")
        elif name == "straggler_wait" and c.get("slowest"):
            names = ", ".join(f"shard-{d['shard']}"
                              for d in c["slowest"])
            extra = f"  (slowest: {names})"
        lines.append(
            f"{indent}  {name:<16} "
            f"{float(c.get('blame_s') or 0.0):8.2f}s "
            f"{100.0 * float(c.get('share') or 0.0):5.1f}%{extra}")
    for sid, entry in sorted(ru.get("shards", {}).items(),
                             key=lambda kv: int(kv[0])):
        bn = entry.get("bottleneck")
        lines.append(
            f"{indent}  shard {int(sid):3d} {entry.get('status', '?'):<8}"
            f" wall {float(entry.get('wall_s') or 0.0):7.2f}s "
            f"blame {float(entry.get('blame_s') or 0.0):7.2f}s"
            + (f"  bottleneck={bn}" if bn else ""))
    if ru.get("bottleneck"):
        lines.append(f"{indent}  bottleneck: {ru['bottleneck']}")
    return lines


# ---------------------------------------------------------- fleet grid


def fleet_grid(fleet_dir: str) -> Optional[dict]:
    """The per-shard grid and the scheduler's last events; ``None``
    when the dir has neither plan nor events."""
    if not is_fleet_dir(fleet_dir):
        return None
    events, torn = _load_events(fleet_dir)
    shard_ids = _shard_ids(fleet_dir, events)
    state = {sid: "pending" for sid in shard_ids}
    attempts = {sid: 0 for sid in shard_ids}
    chain: Dict[int, List[str]] = {sid: [] for sid in shard_ids}
    for rec in events:
        sid = rec.get("shard")
        if sid not in state:
            continue
        ev = rec.get("ev")
        if ev == "shard-launched":
            attempts[sid] += 1
            state[sid] = "running"
        elif ev == "shard-preempted":
            chain[sid].append(str(rec.get("reason") or "unknown"))
            state[sid] = "pending"
        elif ev == "shard-done":
            state[sid] = "done"
        elif ev == "fleet-shard-failed":
            state[sid] = "failed"
    now = _wall()
    shards = {}
    for sid in shard_ids:
        beat = _latest_beat(fleet_dir, sid)
        entry: Dict[str, Any] = {
            "state": state[sid],
            "attempts": attempts[sid],
            "chain": chain[sid],
        }
        if beat:
            ts = float(beat.get("ts") or 0.0)
            entry["beat_age_s"] = round(max(0.0, now - ts), 3)
            occ = beat.get("occupancy") or {}
            if occ:
                entry["occupancy"] = occ
            if beat.get("rss_mb") is not None:
                entry["rss_mb"] = beat.get("rss_mb")
            if beat.get("role") is not None:
                entry["role"] = beat.get("role")
        shards[str(sid)] = entry
    tail = [{"ev": r.get("ev"), "ts": r.get("ts"),
             **({"shard": r["shard"]} if isinstance(
                 r.get("shard"), int) else {})}
            for r in events[-8:]]
    return {"fleet_dir": fleet_dir, "shards": shards,
            "events": len(events), "torn_events": torn,
            "event_tail": tail}


def render_fleet_grid(grid: dict) -> str:
    lines = [f"fleet {grid.get('fleet_dir')}  "
             f"events {grid.get('events', 0)}"
             + (f"  ({grid['torn_events']} torn)"
                if grid.get("torn_events") else "")]
    for sid, e in sorted(grid.get("shards", {}).items(),
                         key=lambda kv: int(kv[0])):
        occ = e.get("occupancy") or {}
        occ_s = " ".join(f"{k}={v:.2f}" for k, v in
                         sorted(occ.items())) if occ else "-"
        beat = (f"{e['beat_age_s']:.1f}s"
                if e.get("beat_age_s") is not None else "-")
        rss = (f"{float(e['rss_mb']):.0f}MB"
               if e.get("rss_mb") is not None else "-")
        chain = "->".join(e.get("chain") or []) or "-"
        lines.append(
            f"  shard {int(sid):3d} {e.get('state', '?'):<8}"
            f" attempts={e.get('attempts', 0)}"
            f" beat-age={beat:<7} rss={rss:<7}"
            f" occ[{occ_s}] chain={chain}")
    tail = grid.get("event_tail") or []
    if tail:
        lines.append("  recent events:")
        for rec in tail:
            shard = (f" shard={rec['shard']}"
                     if "shard" in rec else "")
            lines.append(f"    {rec.get('ev')}{shard}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------- full report


def write_fleet_report(fleet_dir: str, ru: dict,
                       argv: Optional[List[str]] = None,
                       started_at: Optional[float] = None) -> str:
    """Assemble and atomically write ``fleet_report.json`` (a normal
    schema-valid run report whose ``fleet_rollup`` is ``ru``)."""
    from galah_tpu_torch.obs import report as report_mod

    rep = report_mod.assemble("fleet-analyze", argv=argv,
                              started_at=started_at)
    rep["fleet_rollup"] = ru
    path = fleet_report_path(fleet_dir)
    report_mod.write(path, rep)
    return path
