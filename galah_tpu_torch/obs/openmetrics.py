"""Prometheus/OpenMetrics textfile exporter for the metrics registry.
The port's copy of ``galah_tpu/obs/openmetrics.py``.

``GALAH_OBS_OPENMETRICS=<path>`` makes every heartbeat tick render the
process-wide metrics registry (and, when a fleet rollup provider is
installed by ``fleet run``, the cross-shard blame rollup) to ``<path>``
in Prometheus text exposition format (0.0.4), swapped atomically
(``io/atomic.write_text``: tmp, fsync, rename), so a scraper or a
node-exporter textfile collector never reads a torn file.

Naming: registry names are dotted (``cache.hits``); exported names
are ``galah_`` + the name with every non-alphanumeric run collapsed
to ``_``. The ``name[key]`` suffix convention (``retries[site]``,
``workload.pipeline_occupancy[stage]``) becomes a label: ``stage=``
for occupancy gauges, ``site=`` for everything else. Counters gain
the conventional ``_total`` suffix; histograms export as summaries
(``_count``/``_sum``) plus ``_min``/``_max`` gauges. The page is
``galah_tpu``'s for the same registry snapshot and rollup.

No device, no locks: state is one module attribute written by the main
thread and read by the heartbeat thread (an atomic reference read).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from galah_tpu_torch.io import atomic

#: Metric-name prefix for everything this process exports.
PREFIX = "galah_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]+")
_BRACKET_RE = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<key>[^\[\]]*)\]$")

#: Optional fleet-rollup provider installed by ``fleet run`` (a
#: zero-arg callable returning the fleet_view.rollup dict or None).
_rollup_provider: Optional[Callable[[], Optional[dict]]] = None


def set_rollup_provider(
        provider: Optional[Callable[[], Optional[dict]]]) -> None:
    global _rollup_provider
    _rollup_provider = provider


def reset() -> None:
    """Drop run-scoped exporter state (obs.reset_run)."""
    set_rollup_provider(None)


def _sanitize(name: str) -> str:
    out = _NAME_RE.sub("_", name).strip("_")
    if out and out[0].isdigit():
        out = "_" + out
    return PREFIX + out


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _split_labels(name: str) -> Tuple[str, str]:
    """``name[key]`` -> (base, label string); plain names pass through
    with no labels."""
    m = _BRACKET_RE.match(name)
    if not m:
        return name, ""
    base, key = m.group("base"), m.group("key")
    label = "stage" if base.endswith("occupancy") else "site"
    return base, '{%s="%s"}' % (label, _escape_label(key))


def _fmt(value: Any) -> str:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return "0"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render(metrics_snapshot: Dict[str, dict],
           rollup: Optional[dict] = None) -> str:
    """The full exposition page for one registry snapshot (and an
    optional fleet rollup)."""
    lines: List[str] = []
    typed: set = set()

    def emit(name: str, mtype: str, help_text: str, labels: str,
             value: Any) -> None:
        if name not in typed:
            typed.add(name)
            if help_text:
                lines.append(f"# HELP {name} "
                             f"{_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {_fmt(value)}")

    for raw_name in sorted(metrics_snapshot):
        snap = metrics_snapshot[raw_name]
        if not isinstance(snap, dict):
            continue
        base, labels = _split_labels(raw_name)
        name = _sanitize(base)
        kind = snap.get("kind")
        help_text = snap.get("help") or ""
        if kind == "counter":
            emit(name + "_total", "counter", help_text, labels,
                 snap.get("value") or 0)
        elif kind == "gauge":
            if snap.get("value") is None:
                continue
            emit(name, "gauge", help_text, labels, snap["value"])
        elif kind == "histogram":
            if name not in typed:
                typed.add(name)
                if help_text:
                    lines.append(f"# HELP {name} "
                                 f"{_escape_help(help_text)}")
                lines.append(f"# TYPE {name} summary")
            lines.append(f"{name}_count{labels} "
                         f"{_fmt(snap.get('count') or 0)}")
            lines.append(f"{name}_sum{labels} "
                         f"{_fmt(snap.get('sum') or 0.0)}")
            for agg in ("min", "max"):
                if snap.get(agg) is not None:
                    emit(f"{name}_{agg}", "gauge",
                         f"{agg} observed {raw_name}", labels,
                         snap[agg])

    if rollup:
        emit(PREFIX + "fleet_wall_seconds", "gauge",
             "Fleet wall clock decomposed by the rollup", "",
             rollup.get("fleet_wall_s") or 0.0)
        # one contiguous block per metric: the text format requires
        # every sample of a metric grouped under its single TYPE line
        comps = [(comp, c) for comp, c in sorted(
            (rollup.get("components") or {}).items())
            if isinstance(c, dict)]
        for comp, c in comps:
            emit(PREFIX + "fleet_blame_seconds", "gauge",
                 "Fleet wall blamed on one rollup component",
                 '{component="%s"}' % _escape_label(comp),
                 c.get("blame_s") or 0.0)
        for comp, c in comps:
            emit(PREFIX + "fleet_blame_share", "gauge",
                 "Fraction of the fleet wall blamed on one "
                 "rollup component",
                 '{component="%s"}' % _escape_label(comp),
                 c.get("share") or 0.0)
        shards = [(sid, entry) for sid, entry in sorted(
            (rollup.get("shards") or {}).items(),
            key=lambda kv: str(kv[0])) if isinstance(entry, dict)]
        for sid, entry in shards:
            emit(PREFIX + "fleet_shard_wall_seconds", "gauge",
                 "Per-shard running wall inside the supervise "
                 "window", '{shard="%s"}' % _escape_label(str(sid)),
                 entry.get("wall_s") or 0.0)
        for sid, entry in shards:
            emit(PREFIX + "fleet_shard_blame_seconds", "gauge",
                 "Per-shard compute blame from the fleet rollup",
                 '{shard="%s"}' % _escape_label(str(sid)),
                 entry.get("blame_s") or 0.0)

    return "\n".join(lines) + "\n"


def export_path() -> Optional[str]:
    """The configured textfile path, or None when export is off."""
    from galah_tpu_torch.config import env_value

    return env_value("GALAH_OBS_OPENMETRICS") or None


def write_textfile(path: str,
                   metrics_snapshot: Optional[Dict[str, dict]] = None,
                   rollup: Optional[dict] = None) -> str:
    """Render and atomically swap the ``.prom`` file at ``path``."""
    if metrics_snapshot is None:
        from galah_tpu_torch.obs import metrics as obs_metrics

        metrics_snapshot = obs_metrics.snapshot()
    atomic.write_text(path, render(metrics_snapshot, rollup=rollup),
                      site="io.atomic.write[openmetrics]")
    return path


def maybe_export() -> Optional[str]:
    """One export tick: no-op unless GALAH_OBS_OPENMETRICS is set.

    Called from Heartbeat.beat() — failures must never take down the
    beat, so callers wrap this in try/except. The rollup provider is
    itself best-effort: a torn fleet dir mid-kill yields None and the
    page simply omits fleet series for that tick."""
    path = export_path()
    if not path:
        return None
    rollup = None
    provider = _rollup_provider
    if provider is not None:
        try:
            rollup = provider()
        except Exception:
            rollup = None
    return write_textfile(path, rollup=rollup)
