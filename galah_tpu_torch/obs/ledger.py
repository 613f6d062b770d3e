"""Cross-run performance ledger: append-only JSONL with regression
gating. The port's copy of ``galah_tpu/obs/ledger.py``.

Every finalized run with ``GALAH_OBS_LEDGER`` set appends one entry
(``obs.finalize``), ``perf record`` appends one from a run report, and
``perf check`` compares the newest entry against a median +- MAD noise
band over the last entries of the same key, exiting 1 on a regression.

Entry layout (one crc-framed JSON object a line, ``io/atomic``)::

    {"v": 1, "ts": 1754..., "sha": "9feb21d",
     "key": {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
             "n_devices": 1,
             "workload": {"n": 1024, "k": 1000, "p": null},
             "strategy": "auto/auto/auto/auto/auto/auto",
             "source": "cluster"},
     "metrics": {"run.duration_s": 6.5, "stage.profile_s": 1.9,
                 "profile.tile_stats.dispatch_wall_s": 0.001, ...}}

The key leaves out the git sha: the point is comparing one (backend,
topology, workload, strategy) configuration across commits; the sha of
each entry names the commit that moved a metric in ``perf history``.
The port keys its entries with backend ``cuda`` and the card's name, so
they never share a noise band with a TPU entry of ``galah_tpu``; the
strategy fingerprint reads ``galah_tpu``'s strategy flags, which the
port lacks, so it is ``auto`` throughout. Either package reads, checks
and appends to the other's ledger file.

A run killed mid-append leaves a torn last line; ``read()`` skips it
(and counts it), and ``append()`` writes whole lines only.

No torch here: the ``perf`` subcommand is file I/O.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

LEDGER_VERSION = 1

#: Defaults for the check window and noise band (flag-overridable:
#: GALAH_OBS_LEDGER_WINDOW / GALAH_OBS_LEDGER_MAD_K).
DEFAULT_WINDOW = 8
DEFAULT_MAD_K = 4.0
#: Entries needed before check() will issue a verdict at all.
MIN_HISTORY = 3

#: Absolute noise floor for seconds-scale metrics: a wall below this
#: spread is host-scheduler jitter, not a perf signal. A 0.5 ms
#: dispatch wall that triples is still meaningless; a 10 s stage that
#: doubles is not — the floor only widens bands that were narrower
#: than one scheduling quantum anyway.
SECONDS_NOISE_FLOOR = 0.05

#: Substrings that classify a metric's good direction. Checked against
#: the metric name; first family that matches wins.
_HIGHER_BETTER = ("per_sec", "per_s", "_rate", "speedup",
                  "utilization", "hit_rate")
_LOWER_BETTER = ("_s", "duration", "seconds", "wall", "_bytes",
                 "bytes_", "errors")
#: Exact-name directions checked before the substring families. The
#: host-blame share is the megakernel's headline gauge: host
#: orchestration migrating back above its ledger median is a
#: regression even though "share" matches no substring family.
_DIRECTION_OVERRIDES = {
    "flow.host.share": "lower",
    "flow.host.blame_s": "lower",
    "bench.megakernel_host_share": "lower",
}


def git_sha() -> Optional[str]:
    """Short HEAD sha of the checkout this process runs from, or None
    outside a git tree (the ledger records it, never requires it)."""
    try:
        here = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        proc = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=here,
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = proc.stdout.strip()
    return sha if proc.returncode == 0 and sha else None


def metric_direction(name: str) -> str:
    """'higher' / 'lower' / 'neutral' — which way is good for `name`.

    Inferred from naming conventions (rates up, walls and byte counts
    down); unknown metrics are 'neutral' and can drift but never gate.
    A few metrics carry an exact-name direction (see
    _DIRECTION_OVERRIDES) where the convention families would miss or
    misread them."""
    low = name.lower()
    override = _DIRECTION_OVERRIDES.get(low)
    if override is not None:
        return override
    if any(tok in low for tok in _HIGHER_BETTER):
        return "higher"
    if any(low.endswith(tok) or tok in low for tok in _LOWER_BETTER):
        return "lower"
    return "neutral"


def _is_seconds_metric(name: str) -> bool:
    low = name.lower()
    return (low.endswith("_s") or "duration" in low or "wall" in low
            or "seconds" in low)


def key_of(entry: Dict[str, Any]) -> str:
    """Canonical string identity of an entry's comparison key."""
    return json.dumps(entry.get("key", {}), sort_keys=True)


# ---------------------------------------------------------------------------
# File format
# ---------------------------------------------------------------------------


def append(path: str, entry: Dict[str, Any]) -> None:
    """Durably append one checksum-framed line (creating parent dirs).

    io/atomic.py owns the write discipline (O_APPEND single write +
    fsync + crc framing); this module keeps only the schema."""
    from galah_tpu_torch.io import atomic

    atomic.append_jsonl(path, entry, site="io.atomic.append[ledger]")


def read(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """All parseable entries in file order, plus the count of skipped
    (torn/corrupt) lines. A missing file is an empty ledger. Framed
    (crc-checked) and legacy plain lines both parse."""
    from galah_tpu_torch.io import atomic

    records, skipped = atomic.read_jsonl(path)
    entries: List[Dict[str, Any]] = []
    for obj in records:
        if isinstance(obj, dict) and isinstance(
                obj.get("metrics"), dict):
            entries.append(obj)
        else:
            skipped += 1
    return entries, skipped


# ---------------------------------------------------------------------------
# Building entries from run reports
# ---------------------------------------------------------------------------


def _flag_value(report: dict, name: str) -> Optional[str]:
    return (report.get("flags", {}).get(name) or {}).get("value")


def _gauge_value(report: dict, name: str) -> Optional[float]:
    m = report.get("metrics", {}).get(name) or {}
    v = m.get("value")
    return float(v) if isinstance(v, (int, float)) else None


def _int_or_none(v) -> Optional[int]:
    try:
        return int(v) if v is not None else None
    except (TypeError, ValueError):
        return None


def workload_fingerprint(report: dict) -> Dict[str, Optional[int]]:
    """N/K/P from the report: the workload gauges the engine sets
    (workload.n_genomes, workload.sketch_k) and the pairlist block
    flag. Nulls where a run did not say — two runs only share a key
    when they agree on all three."""
    return {
        "n": _int_or_none(_gauge_value(report, "workload.n_genomes")),
        "k": _int_or_none(_gauge_value(report, "workload.sketch_k")),
        "p": _int_or_none(_flag_value(report,
                                      "GALAH_TPU_PAIRLIST_BLOCK")),
    }


def strategy_fingerprint(report: dict) -> str:
    """The pinned-strategy tuple (pairlist/fragment/greedy/sketch/
    overlap/mesh-shape), 'auto' where unpinned — a pinned run must not
    share a noise band with an AUTO run (and a 2x4-mesh run must not
    share one with a 1-D run)."""
    parts = []
    for flag in ("GALAH_TPU_PAIRLIST_STRATEGY",
                 "GALAH_TPU_FRAGMENT_STRATEGY",
                 "GALAH_TPU_GREEDY_STRATEGY",
                 "GALAH_TPU_SKETCH_STRATEGY",
                 "GALAH_TPU_OVERLAP",
                 "GALAH_TPU_MESH_SHAPE"):
        parts.append(_flag_value(report, flag) or "auto")
    return "/".join(parts)


def _stage_metrics(tree: List[dict], prefix: str,
                   out: Dict[str, float], depth: int = 0) -> None:
    # Top two stage levels only: deeper nodes are per-batch noise.
    for node in tree or []:
        name = f"{prefix}{node.get('name')}"
        v = node.get("total_s")
        if isinstance(v, (int, float)):
            out[f"stage.{name}_s"] = float(v)
        if depth == 0:
            _stage_metrics(node.get("children"), name + "/", out,
                           depth + 1)


def metrics_of_report(report: dict) -> Dict[str, float]:
    """The ledger-worthy scalars of one run report: run duration, the
    stage walls (two levels), dispatch totals, ``bench.`` gauges, and the
    profiler's per-entry walls/compile seconds."""
    out: Dict[str, float] = {}
    dur = report.get("run", {}).get("duration_s")
    if isinstance(dur, (int, float)):
        out["run.duration_s"] = float(dur)
    _stage_metrics(report.get("stages", {}).get("tree", []), "", out)
    disp = report.get("dispatch", {})
    for key in ("total_dispatches", "total_syncs"):
        v = disp.get(key)
        if isinstance(v, (int, float)):
            out[f"dispatch.{key}"] = float(v)
    for name, m in (report.get("metrics", {}) or {}).items():
        if not name.startswith("bench."):
            continue
        v = m.get("value")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = float(v)
    dc = report.get("device_costs") or {}
    for name, e in (dc.get("entries") or {}).items():
        for field in ("dispatch_wall_s", "compile_wall_s"):
            v = e.get(field)
            if isinstance(v, (int, float)) and v:
                out[f"profile.{name}.{field}"] = float(v)
    hbm = (dc.get("hbm") or {}).get("peak_bytes")
    if isinstance(hbm, (int, float)):
        out["profile.hbm_peak_bytes"] = float(hbm)
    cp = (report.get("flow") or {}).get("critical_path") or {}
    for name, blame in (cp.get("stages") or {}).items():
        for field in ("blame_s", "share"):
            v = blame.get(field)
            if isinstance(v, (int, float)):
                out[f"flow.{name}.{field}"] = float(v)
    for field in ("blame_s", "share"):
        v = (cp.get("host") or {}).get(field)
        if isinstance(v, (int, float)):
            out[f"flow.host.{field}"] = float(v)
    return out


def entry_from_report(report: dict, source: str,
                      ts: Optional[float] = None,
                      sha: Optional[str] = None,
                      shard: Optional[int] = None) -> Dict[str, Any]:
    """One ledger entry from an assembled run report dict.

    ``shard`` is the fleet-worker shard id: a worker subprocess runs
    the same (backend, workload, strategy) configuration as a whole
    single-process run but over a SUBSET of the genomes, so without a
    shard key member its wall would land in — and poison — the e2e
    noise band that ``perf check`` gates on. Shard entries get their
    own key (and so their own band); non-fleet entries keep the exact
    pre-shard key shape, so existing histories keep matching."""
    dev = report.get("device", {}) or {}
    kinds = {d.get("device_kind") for d in dev.get("devices") or []}
    key: Dict[str, Any] = {
        "backend": dev.get("backend"),
        "device_kind": (sorted(kinds)[0] if kinds else None),
        "n_devices": dev.get("device_count"),
        "workload": workload_fingerprint(report),
        "strategy": strategy_fingerprint(report),
        "source": source,
    }
    if shard is not None:
        key["shard"] = int(shard)
    return {
        "v": LEDGER_VERSION,
        "ts": float(ts if ts is not None else time.time()),
        "sha": sha if sha is not None else git_sha(),
        "key": key,
        "metrics": metrics_of_report(report),
    }


def record_report(path: str, report: dict, source: str,
                  shard: Optional[int] = None) -> bool:
    """Append `report` to the ledger at `path`; False (and a log line)
    on failure — feeding the ledger must never fail the run."""
    try:
        append(path, entry_from_report(report, source, shard=shard))
        return True
    except Exception:
        logger.warning("perf ledger append failed", exc_info=True)
        return False


# ---------------------------------------------------------------------------
# History + regression check
# ---------------------------------------------------------------------------


def history(entries: List[dict], metric: str,
            key: Optional[str] = None) -> List[dict]:
    """File-order rows {ts, sha, key, value} of `metric`, optionally
    restricted to entries whose canonical key equals `key`."""
    rows = []
    for e in entries:
        if key is not None and key_of(e) != key:
            continue
        v = e.get("metrics", {}).get(metric)
        if isinstance(v, (int, float)):
            rows.append({"ts": e.get("ts"), "sha": e.get("sha"),
                         "key": key_of(e), "value": float(v)})
    return rows


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def check(entries: List[dict], current: dict,
          window: int = DEFAULT_WINDOW,
          mad_k: float = DEFAULT_MAD_K,
          min_history: int = MIN_HISTORY) -> List[dict]:
    """Verdicts for every metric of `current` against the last `window`
    same-key entries of `entries` (which must NOT contain `current`).

    Per metric: {"metric", "value", "n_history", "median", "mad",
    "band": [lo, hi], "direction", "verdict"} with verdict one of
    ok / regression / improvement / drift / insufficient-history.
    The band is median ± mad_k * MAD, with the MAD floored at 1% of
    |median| (an all-identical history would otherwise declare any
    epsilon a regression) and, for seconds-scale metrics, at
    SECONDS_NOISE_FLOOR absolute (sub-millisecond walls triple on
    scheduler jitter alone) — only a move outside the band in the bad
    direction is a regression; 'drift' marks neutral-direction metrics
    outside the band and never gates."""
    key = key_of(current)
    same = [e for e in entries if key_of(e) == key]
    tail = same[-window:]
    verdicts = []
    for metric, value in sorted(current.get("metrics", {}).items()):
        if not isinstance(value, (int, float)):
            continue
        hist = [e["metrics"][metric] for e in tail
                if isinstance(e.get("metrics", {}).get(metric),
                              (int, float))]
        direction = metric_direction(metric)
        v: Dict[str, Any] = {"metric": metric, "value": float(value),
                             "n_history": len(hist),
                             "direction": direction}
        if len(hist) < min_history:
            v.update(verdict="insufficient-history", median=None,
                     mad=None, band=None)
            verdicts.append(v)
            continue
        med = _median(hist)
        mad = _median([abs(x - med) for x in hist])
        spread = max(mad_k * mad, 0.01 * abs(med), 1e-12)
        if _is_seconds_metric(metric):
            spread = max(spread, SECONDS_NOISE_FLOOR)
        lo, hi = med - spread, med + spread
        if lo <= value <= hi:
            verdict = "ok"
        elif direction == "neutral":
            verdict = "drift"
        elif (value < lo) == (direction == "higher"):
            verdict = "regression"
        else:
            verdict = "improvement"
        v.update(verdict=verdict, median=med, mad=mad, band=[lo, hi])
        verdicts.append(v)
    return verdicts


def regressions(verdicts: List[dict]) -> List[dict]:
    return [v for v in verdicts if v["verdict"] == "regression"]
