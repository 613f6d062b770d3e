"""run_report.json: assemble, validate, render and diff run reports.
The port's copy of ``galah_tpu/obs/report.py``.

One schema-valid JSON artifact per run (``--run-report PATH`` /
``GALAH_OBS_REPORT``): the config-flag snapshot (``config.FLAGS``), the
device, the run's stage tree (``timing.StageClock.tree``), the kernel
launches of the run as the ``dispatch`` section, the precluster funnel
(possible -> screened -> kept -> exact-ANI pairs, the sketch-cache hit
rate), every event (quarantines, preemptions, resumes, retries), the
run's counts and the typed metrics. The schema
(``run_report.schema.json``) is ``galah_tpu``'s file, and the report's
``kind`` and ``version`` are its, so either package validates, renders
and diffs the other's reports; the stage names differ (the README's
port section maps them), so a cross-package diff lines up the counters
and the funnel but not the stage rows.

Every report holds ``device_costs`` (``obs/profile.snapshot``: each
kernel's launches, shapes, dispatch and nvcc seconds, CUDA-event device
seconds, bytes and operations and their shares of the card's peaks, the
allocator's high-water) and, when flow tracing saw pipeline items or a
heartbeat ran, ``flow`` (``obs/flow.snapshot`` with its
``critical_path``, and the heartbeat's series). A fleet supervisor's
report (``fleet run``) adds the ``fleet`` section (``fleet.snapshot()``)
and the ``fleet_rollup`` section (``obs/fleet_view.rollup`` over the
fleet directory). ``lint --run-report`` adds the ``lint`` section
(``analysis.core.lint_summary``). A run armed by ``GALAH_SAN=1`` adds
the ``sanitizer`` section (``analysis/sanitizer.summary_if_enabled``:
the GalahSan counts over the port's threaded modules), as
``galah_tpu``'s report does.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

from galah_tpu_torch.obs.heartbeat import OCC_RE as _OCC_RE
from galah_tpu_torch.resilience import dispatch as rdispatch

logger = logging.getLogger(__name__)

SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                           "run_report.schema.json")
REPORT_VERSION = 10  # galah_tpu's version: v10 added the memory section

# disp[<kernel>] / sync[<stage>]: the dispatch counters
_DISP_RE = re.compile(r"^(disp|sync)\[(.*)\]$")


def flag_snapshot() -> Dict[str, dict]:
    """Every registered GALAH_* flag: effective value, default, and
    whether the environment set it."""
    from galah_tpu_torch.config import FLAGS, env_value

    snap = {}
    for name, flag in sorted(FLAGS.items()):
        raw = os.environ.get(name)
        snap[name] = {
            "value": env_value(name),
            "default": flag.default,
            "set": raw not in (None, ""),
            "section": flag.section,
        }
    return snap


def device_topology(device=None) -> dict:
    """Backend, devices and process layout of the run on `device` (a
    ``torch.device``, or None when the run never made one).

    Assembling a report never initializes CUDA when the run did not:
    the card is named only when ``torch.cuda.is_initialized()``."""
    topo: dict = {"backend": None, "device_count": None,
                  "process_index": None, "process_count": None,
                  "jax_version": None, "devices": []}
    torch = sys.modules.get("torch")
    if torch is None or device is None:
        return topo
    try:
        from galah_tpu_torch.parallel import distributed

        topo["backend"] = device.type
        topo["process_index"] = distributed.process_index()
        topo["process_count"] = distributed.process_count()
        if device.type == "cuda" and torch.cuda.is_initialized():
            n = torch.cuda.device_count()
            topo["device_count"] = n
            topo["devices"] = [
                {"id": i, "platform": "cuda",
                 "device_kind": torch.cuda.get_device_name(i)}
                for i in range(n)]
        elif device.type == "cpu":
            topo["device_count"] = 1
            topo["devices"] = [{"id": 0, "platform": "cpu",
                                "device_kind": "cpu"}]
    except Exception as exc:  # report assembly must never kill the run
        logger.debug("device topology unavailable: %s", exc)
    return topo


def _split_dispatch_counters(
        counters: Dict[str, int]
) -> Tuple[Dict[str, int], Dict[str, int]]:
    disp: Dict[str, int] = {}
    sync: Dict[str, int] = {}
    for name, value in counters.items():
        m = _DISP_RE.match(name)
        if not m:
            continue
        (disp if m.group(1) == "disp" else sync)[m.group(2)] = value
    return disp, sync


def assemble(subcommand: str, clock=None,
             argv: Optional[List[str]] = None,
             started_at: Optional[float] = None,
             lint: Optional[dict] = None) -> dict:
    """The full report dict from the run's `clock` (a
    ``timing.StageClock``, or None when the run stopped before it made
    one) and the process-wide telemetry (``obs.metrics``,
    ``obs.events``, the interruption state, the index snapshot, the
    heartbeat). `lint` is the static-analysis summary
    (``analysis.core.lint_summary``), attached by ``lint`` only."""
    import galah_tpu_torch
    from galah_tpu_torch.obs import events as obs_events
    from galah_tpu_torch.obs import metrics as obs_metrics

    counters = clock.counters() if clock is not None else {}
    disp, sync = _split_dispatch_counters(counters)
    # the guarded dispatch sites' retries in this run, among the
    # counters as galah_tpu's report has them
    retries = rdispatch.retry_counts()
    counters.update({f"retries[{site}]": n for site, n in retries.items()})
    elapsed = clock.elapsed() if clock is not None else 0.0

    metrics = obs_metrics.snapshot()

    def _metric_value(name: str, default=0):
        m = metrics.get(name)
        return m.get("value", default) if m else default

    hits = int(_metric_value("cache.hits") or 0)
    misses = int(_metric_value("cache.misses") or 0)
    finished = time.time()
    report = {
        "version": REPORT_VERSION,
        "kind": "galah-tpu-run-report",
        "run": {
            "subcommand": subcommand,
            "argv": list(argv) if argv is not None else list(sys.argv),
            "started_at": started_at,
            "finished_at": finished,
            "duration_s": (finished - started_at
                           if started_at is not None else elapsed),
            "galah_tpu_version": galah_tpu_torch.__version__,
        },
        "flags": flag_snapshot(),
        "device": device_topology(clock.device if clock is not None
                                  else None),
        "stages": {"total_s": elapsed,
                   "tree": clock.tree() if clock is not None else []},
        "dispatch": {
            "dispatches": disp,
            "syncs": sync,
            "total_dispatches": sum(disp.values()),
            "total_syncs": sum(sync.values()),
        },
        "funnel": {
            "possible_pairs": counters.get("screen-possible-pairs", 0),
            "screened_candidates": counters.get("screen-candidates", 0),
            "kept_pairs": counters.get("screen-kept-pairs", 0),
            "exact_ani_computed": counters.get("exact-ani-computed", 0),
            "exact_ani_wasted": counters.get("exact-ani-wasted", 0),
            "cache": {
                "hits": hits,
                "misses": misses,
                "hit_rate": (hits / (hits + misses)
                             if hits + misses else None),
            },
        },
        "resilience": {
            # the guarded dispatch sites' retries (genome reads retry
            # too, as `retry` events only); the port never demotes a
            # site to the CPU or a plain version, it raises
            "retries": retries,
            "demotions": [],
            "quarantined_genomes": counters.get(
                "quarantined-genomes", 0),
        },
        "counters": counters,
        "metrics": metrics,
        "events": obs_events.snapshot(),
    }
    try:
        from galah_tpu_torch.resilience import interrupt

        report["preemption"] = interrupt.snapshot()
    except Exception:  # additive section; never lose a report
        logger.debug("preemption snapshot failed", exc_info=True)
    try:
        from galah_tpu_torch import index as index_pkg

        idx_snap = index_pkg.snapshot()
        if idx_snap is not None:
            report["index"] = idx_snap
    except Exception:  # additive section; never lose a report
        logger.debug("index snapshot failed", exc_info=True)
    try:
        from galah_tpu_torch import fleet as fleet_pkg

        fleet_snap = fleet_pkg.snapshot()
        if fleet_snap is not None:
            report["fleet"] = fleet_snap
            fleet_dir = fleet_snap.get("fleet_dir")
            if fleet_dir:
                from galah_tpu_torch.obs import fleet_view

                ru = fleet_view.rollup(fleet_dir)
                if ru is not None:
                    report["fleet_rollup"] = ru
    except Exception:  # additive sections; never lose a report
        logger.debug("fleet snapshot failed", exc_info=True)
    try:
        from galah_tpu_torch.obs import profile as obs_profile

        report["device_costs"] = obs_profile.snapshot(
            clock.device if clock is not None else None)
    except Exception:  # additive section; never lose a report
        logger.debug("device-cost snapshot failed", exc_info=True)
    try:
        from galah_tpu_torch.analysis import sanitizer as galah_san

        san_summary = galah_san.summary_if_enabled()
        if san_summary is not None:
            report["sanitizer"] = san_summary
    except Exception:  # additive section; never lose a report
        logger.debug("sanitizer summary failed", exc_info=True)
    try:
        from galah_tpu_torch.obs import flow as obs_flow
        from galah_tpu_torch.obs import heartbeat as obs_heartbeat

        # a run with no clock ran no stage: whatever the recorder holds
        # is an earlier run's
        flow_snap = obs_flow.snapshot() if clock is not None else {}
        if flow_snap.get("stages"):
            flow_snap["critical_path"] = obs_flow.critical_path(
                flow_snap, report["run"]["duration_s"])
        hb_snap = obs_heartbeat.snapshot()
        if hb_snap is not None:
            flow_snap["heartbeat"] = hb_snap
        if flow_snap.get("stages") or hb_snap is not None:
            report["flow"] = flow_snap
    except Exception:  # additive sections; never lose a report
        logger.debug("flow snapshot failed", exc_info=True)
    try:
        mem = _memory_section(report)
        if mem:
            report["memory"] = mem
    except Exception:  # additive section; never lose a report
        logger.debug("memory section failed", exc_info=True)
    if lint is not None:
        report["lint"] = lint
    return report


def _memory_section(report: dict) -> dict:
    """The host-memory summary, as ``galah_tpu``'s: the heartbeat's
    per-beat RSS series (min/mean/peak), the page store's resident
    bytes and page-ins and -outs when the paged sketch path ran
    (``io/pagestore.py``), and the ingest prefilter's skips
    (``ops/prefilter.py``)."""
    mem: dict = {}
    rss = (((report.get("flow") or {}).get("heartbeat") or {})
           .get("rss_series"))
    if rss:
        mem["rss_mb"] = rss
    mets = report.get("metrics") or {}
    resident = (mets.get("pagestore.resident_bytes") or {}).get("value")
    if resident is not None:
        mem["pagestore"] = {
            "resident_bytes": resident,
            "page_ins": (mets.get("pagestore.page_ins") or {})
            .get("value", 0),
            "page_outs": (mets.get("pagestore.page_outs") or {})
            .get("value", 0),
        }
    skipped = (mets.get("prefilter.skipped") or {}).get("value")
    if skipped is not None:
        mem["prefilter_skipped"] = skipped
    return mem


def write(path: str, report: dict) -> None:
    from galah_tpu_torch.io import atomic

    atomic.write_json(path, report, indent=1,
                      site="io.atomic.write[report]")
    logger.info("Wrote run report to %s", path)


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def validate(report: dict) -> List[str]:
    """Schema-validation errors ([] == valid). Uses jsonschema against
    the committed schema when available; otherwise a structural check
    of the required top-level sections so report writing never gains a
    hard dependency."""
    with open(SCHEMA_PATH) as fh:
        schema = json.load(fh)
    try:
        import jsonschema
    except ImportError:
        required = schema.get("required", [])
        return [f"missing required section {k!r}" for k in required
                if k not in report]
    validator = jsonschema.Draft7Validator(schema)
    return [f"{'/'.join(str(p) for p in e.absolute_path) or '<root>'}: "
            f"{e.message}"
            for e in validator.iter_errors(report)]


# ---------------------------------------------------------------------------
# Human rendering + diffing (`galah_tpu_torch report [--diff]`)
# ---------------------------------------------------------------------------


def _fmt_s(v: float) -> str:
    return f"{v:.2f}s"


def _render_stage_tree(tree: List[dict], indent: int = 2) -> List[str]:
    out = []
    for node in tree:
        count = f" x{node['count']}" if node.get("count", 1) > 1 else ""
        out.append(f"{' ' * indent}{node['name']}: "
                   f"{_fmt_s(node['total_s'])}{count}")
        out.extend(_render_stage_tree(node.get("children", []),
                                      indent + 2))
    return out


def _occupancy_rows(metrics: Dict[str, dict]) -> List[Tuple[str, float]]:
    """(stage, occupancy) rows from the metrics snapshot, per-stage
    gauges first, the unlabelled whole-pipeline value last."""
    rows: List[Tuple[str, float]] = []
    whole: Optional[float] = None
    for name, m in sorted(metrics.items()):
        mm = _OCC_RE.match(name)
        if not mm:
            continue
        v = m.get("value")
        if v is None:
            continue
        if mm.group(1):
            rows.append((mm.group(1), float(v)))
        else:
            whole = float(v)
    if whole is not None:
        rows.append(("pipeline", whole))
    return rows


def render(report: dict) -> str:
    """One human-readable page per report."""
    run = report.get("run", {})
    dev = report.get("device", {})
    funnel = report.get("funnel", {})
    cache = funnel.get("cache", {})
    res = report.get("resilience", {})
    disp = report.get("dispatch", {})
    lines = [
        f"galah-tpu run report (v{report.get('version')})",
        f"  subcommand: {run.get('subcommand')}   "
        f"version: {run.get('galah_tpu_version')}   "
        f"duration: {_fmt_s(run.get('duration_s', 0.0))}",
        f"  device: backend={dev.get('backend')} "
        f"devices={dev.get('device_count')} "
        f"process={dev.get('process_index')}/{dev.get('process_count')}",
        "",
        f"stages (total {_fmt_s(report.get('stages', {}).get('total_s', 0.0))}):",
    ]
    lines.extend(_render_stage_tree(
        report.get("stages", {}).get("tree", [])))
    lines += [
        "",
        f"dispatch round trips: {disp.get('total_dispatches', 0)} "
        f"dispatches, {disp.get('total_syncs', 0)} syncs",
    ]
    for stage_name in sorted(set(disp.get("dispatches", {}))
                             | set(disp.get("syncs", {}))):
        lines.append(
            f"  {stage_name}: "
            f"disp={disp.get('dispatches', {}).get(stage_name, 0)} "
            f"sync={disp.get('syncs', {}).get(stage_name, 0)}")
    hit_rate = cache.get("hit_rate")
    lines += [
        "",
        "precluster funnel:",
        f"  possible pairs:     {funnel.get('possible_pairs', 0)}",
        f"  screened candidates:{funnel.get('screened_candidates', 0):>8}",
        f"  kept pairs:         {funnel.get('kept_pairs', 0)}",
        f"  exact ANI computed: {funnel.get('exact_ani_computed', 0)} "
        f"({funnel.get('exact_ani_wasted', 0)} wasted)",
        f"  sketch cache:       {cache.get('hits', 0)} hits / "
        f"{cache.get('misses', 0)} misses"
        + (f" ({100.0 * hit_rate:.0f}% hit rate)"
           if hit_rate is not None else ""),
    ]
    mets = report.get("metrics", {})
    pruned = (mets.get("precluster.bucket_pruned_pairs") or {}) \
        .get("value")
    if pruned is not None:
        frac = (mets.get("precluster.bucket_pruned_fraction") or {}) \
            .get("value") or 0.0
        bands = (mets.get("precluster.bucket_count") or {}) \
            .get("value") or 0
        lines.append(
            f"  HLL-band prefilter: {int(pruned)} pairs pruned "
            f"({100.0 * frac:.0f}% of lattice, {int(bands)} band(s))")
    dcn = (mets.get("mesh.dcn_bytes_per_row") or {}).get("value")
    if dcn is not None:
        lines.append(
            f"  mesh DCN model:     {int(dcn)} bytes/row replicated")
    occ = _occupancy_rows(report.get("metrics", {}))
    if occ:
        lines += ["", "pipeline occupancy (busy fraction of stage "
                      "wall; 1.0 = never starved):"]
        for stage, v in occ:
            bar = "#" * int(round(max(0.0, min(1.0, v)) * 20))
            lines.append(f"  {stage:<10} {v:5.2f} {bar}")
    flow_sec = report.get("flow") or {}
    cp = flow_sec.get("critical_path") or {}
    if cp.get("stages"):
        from galah_tpu_torch.obs import flow as obs_flow

        lines += [""] + obs_flow.render_critical_path(cp)
    hb = flow_sec.get("heartbeat") or {}
    series = hb.get("occupancy_series") or {}
    if series:
        lines += ["",
                  f"occupancy time-series ({hb.get('beats', 0)} "
                  f"heartbeat(s) every {hb.get('period_s')}s; "
                  "min/mean/last):"]
        for stage in sorted(series):
            s = series[stage]
            bar = "#" * int(round(
                max(0.0, min(1.0, s.get("mean", 0.0))) * 20))
            lines.append(
                f"  {stage:<10} {s.get('min', 0.0):.2f}/"
                f"{s.get('mean', 0.0):.2f}/{s.get('last', 0.0):.2f} "
                f"{bar}")
    mem = report.get("memory") or {}
    if mem:
        lines += ["", "memory:"]
        rss = mem.get("rss_mb") or {}
        if rss:
            lines.append(
                f"  rss: {rss.get('min_mb', 0.0):.0f}/"
                f"{rss.get('mean_mb', 0.0):.0f}/"
                f"{rss.get('peak_mb', 0.0):.0f} MB min/mean/peak "
                f"({rss.get('samples', 0)} beat(s))")
        pstore = mem.get("pagestore") or {}
        if pstore:
            lines.append(
                f"  pagestore: {int(pstore.get('resident_bytes', 0))} "
                f"bytes resident, {int(pstore.get('page_ins', 0))} "
                f"page-ins / {int(pstore.get('page_outs', 0))} "
                "page-outs")
        if mem.get("prefilter_skipped") is not None:
            lines.append(
                f"  prefilter skips: {int(mem['prefilter_skipped'])} "
                "genome(s) (bit-identical by construction)")
    lines += [
        "",
        "resilience:",
        f"  retries:    {res.get('retries', {}) or 'none'}",
        f"  demotions:  "
        f"{[d['site'] for d in res.get('demotions', [])] or 'none'}",
        f"  quarantined genomes: {res.get('quarantined_genomes', 0)}",
    ]
    events = report.get("events", [])
    if events:
        lines.append(f"  events ({len(events)}):")
        for ev in events[:20]:
            extra = {k: v for k, v in ev.items()
                     if k not in ("kind", "time")}
            lines.append(f"    {ev.get('kind')}: {extra}")
        if len(events) > 20:
            lines.append(f"    ... {len(events) - 20} more")
    dc = report.get("device_costs")
    if dc and dc.get("entries"):
        peaks = dc.get("peaks", {})
        hbm = dc.get("hbm", {})
        lines += ["", "device costs (profiled entry points):"]
        if peaks.get("device_kind"):
            pk = peaks.get("peak_flops_per_s")
            lines.append(
                f"  device kind: {peaks['device_kind']}"
                + (f" (peak {pk:.3g} FLOP/s)" if pk else ""))
        if hbm.get("peak_bytes") is not None:
            lines.append(
                f"  HBM high-water: {hbm['peak_bytes'] / 2**20:.1f} "
                f"MiB ({hbm.get('source')})")
        for name, e in sorted(dc["entries"].items()):
            flops = e.get("flops")
            byts = e.get("bytes_accessed")
            util = e.get("flops_utilization")
            parts = [f"calls={e.get('calls', 0)}",
                     f"compile={_fmt_s(e.get('compile_wall_s', 0.0))}",
                     f"dispatch={_fmt_s(e.get('dispatch_wall_s', 0.0))}"]
            if flops:
                parts.append(f"flops={flops:.3g}")
            if byts:
                parts.append(f"bytes={byts:.3g}")
            if util is not None:
                parts.append(f"mxu={100.0 * util:.2f}%")
            lines.append(f"  {name}: " + " ".join(parts))
    san = report.get("sanitizer")
    if san is not None:
        lines += [
            "",
            "concurrency sanitizer (GalahSan):",
            f"  {san.get('acquisitions', 0)} acquisitions across "
            f"{san.get('locks', 0)} locks in "
            f"{san.get('modules', 0)} modules",
            f"  edges: {san.get('edges_observed', 0)} observed / "
            f"{san.get('edges_declared', 0)} declared "
            f"({san.get('unexercised', 0)} declared-but-unexercised)",
            f"  violations: "
            f"{san.get('undeclared_acquisitions', 0)} undeclared, "
            f"{san.get('undeclared_edges', 0)} unordered, "
            f"{san.get('inversions', 0)} inversions, "
            f"{san.get('races', 0)} races",
        ]
    idx = report.get("index")
    if idx is not None:
        lines += [
            "",
            "sketch index:",
            f"  op: {idx.get('op')}   "
            f"generation: {idx.get('generation')}",
            f"  {idx.get('genomes', 0)} genome(s) in "
            f"{idx.get('clusters', 0)} cluster(s), "
            f"{idx.get('pairs', 0)} pair(s), "
            f"{idx.get('tombstones', 0)} tombstone(s)",
        ]
    fleet = report.get("fleet")
    if fleet is not None:
        lines += [
            "",
            "fleet:",
            f"  {fleet.get('n_shards', 0)} shard(s) over "
            f"{fleet.get('workers', 0)} worker(s): "
            f"{fleet.get('shards_done', 0)} done, "
            f"{fleet.get('shards_failed', 0)} failed",
            f"  {fleet.get('preemptions', 0)} preemption(s), "
            f"{fleet.get('reassignments', 0)} reassignment(s), "
            f"retry spend {fleet.get('retry_spend_s', 0)}s, "
            f"merge wall {fleet.get('merge_wall_s', 0)}s",
        ]
        for sh in fleet.get("shards") or []:
            chain = ",".join(sh.get("preemptions") or []) or "-"
            lines.append(
                f"    shard {sh.get('shard_id')} "
                f"[{sh.get('lo')}:{sh.get('hi')})  "
                f"{sh.get('status')}  attempts={sh.get('attempts')}  "
                f"chain={chain}")
    rollup = report.get("fleet_rollup")
    if isinstance(rollup, dict):
        from galah_tpu_torch.obs import fleet_view

        lines += [""] + fleet_view.render_rollup(rollup)
    lint = report.get("lint")
    if lint is not None:
        fams = ", ".join(f"{fam}={n}" for fam, n in
                         sorted(lint.get("by_family", {}).items()))
        lines += [
            "",
            "lint:",
            f"  {lint.get('errors', 0)} error(s), "
            f"{lint.get('warnings', 0)} warning(s), "
            f"{lint.get('notes', 0)} note(s), "
            f"{lint.get('suppressed', 0)} suppressed",
        ]
        if fams:
            lines.append(f"  by family: {fams}")
    metrics = report.get("metrics", {})
    if metrics:
        lines.append("")
        lines.append("metrics:")
        for name, m in sorted(metrics.items()):
            unit = f" {m['unit']}" if m.get("unit") else ""
            if m.get("kind") == "histogram":
                mean = m.get("mean")
                lines.append(
                    f"  {name}: n={m.get('count', 0)} "
                    f"mean={mean:.4g}{unit}" if mean is not None
                    else f"  {name}: n=0")
            else:
                lines.append(f"  {name}: {m.get('value')}{unit}")
    return "\n".join(lines) + "\n"


def _flatten_stages(tree: List[dict],
                    prefix: str = "") -> Dict[str, Tuple[float, int]]:
    flat: Dict[str, Tuple[float, int]] = {}
    for node in tree:
        path = f"{prefix}/{node['name']}" if prefix else node["name"]
        acc, count = flat.get(path, (0.0, 0))
        flat[path] = (acc + float(node.get("total_s", 0.0)),
                      count + int(node.get("count", 0)))
        flat.update(_flatten_stages(node.get("children", []), path))
    return flat


def _metric_scalar(m: dict) -> Optional[float]:
    if m.get("kind") == "histogram":
        return m.get("mean")
    v = m.get("value")
    return float(v) if isinstance(v, (int, float)) else None


def diff(a: dict, b: dict, label_a: str = "A",
         label_b: str = "B") -> str:
    """Per-stage and per-metric deltas between two reports (B - A)."""
    lines = [
        f"run report diff: {label_a} -> {label_b}",
        f"  duration: {_fmt_s(a['run']['duration_s'])} -> "
        f"{_fmt_s(b['run']['duration_s'])} "
        f"({b['run']['duration_s'] - a['run']['duration_s']:+.2f}s)",
        "",
        "per-stage wall clock:",
    ]
    sa = _flatten_stages(a.get("stages", {}).get("tree", []))
    sb = _flatten_stages(b.get("stages", {}).get("tree", []))
    for path in sorted(set(sa) | set(sb)):
        ta, _ = sa.get(path, (0.0, 0))
        tb, _ = sb.get(path, (0.0, 0))
        marker = ("" if path in sa and path in sb
                  else f"  [only in {label_a if path in sa else label_b}]")
        lines.append(f"  {path}: {_fmt_s(ta)} -> {_fmt_s(tb)} "
                     f"({tb - ta:+.2f}s){marker}")

    lines += ["", "dispatch round trips:"]
    for key in ("total_dispatches", "total_syncs"):
        va = a.get("dispatch", {}).get(key, 0)
        vb = b.get("dispatch", {}).get(key, 0)
        lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    lines += ["", "funnel:"]
    fa, fb = a.get("funnel", {}), b.get("funnel", {})
    for key in ("possible_pairs", "screened_candidates", "kept_pairs",
                "exact_ani_computed", "exact_ani_wasted"):
        va, vb = fa.get(key, 0), fb.get(key, 0)
        lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    oa = dict(_occupancy_rows(a.get("metrics", {})))
    ob = dict(_occupancy_rows(b.get("metrics", {})))
    if oa or ob:
        lines += ["", "pipeline occupancy:"]
        for stage in sorted(set(oa) | set(ob)):
            va, vb = oa.get(stage), ob.get(stage)
            delta = ("" if va is None or vb is None
                     else f" ({vb - va:+.2f})")
            lines.append(f"  {stage}: {va} -> {vb}{delta}")

    lines += ["", "per-metric deltas:"]
    ma = a.get("metrics", {})
    mb = b.get("metrics", {})
    for name in sorted(set(ma) | set(mb)):
        va = _metric_scalar(ma.get(name, {}))
        vb = _metric_scalar(mb.get(name, {}))
        if va is None and vb is None:
            continue
        delta = ("" if va is None or vb is None
                 else f" ({vb - va:+.6g})")
        lines.append(f"  {name}: {va} -> {vb}{delta}")

    ya = a.get("resilience", {}).get("retries", {}) or {}
    yb = b.get("resilience", {}).get("retries", {}) or {}
    if ya or yb:
        lines += ["", "retries:"]
        for site in sorted(set(ya) | set(yb)):
            va, vb = ya.get(site, 0), yb.get(site, 0)
            lines.append(f"  {site}: {va} -> {vb} ({vb - va:+d})")

    ra = {d["site"] for d in a.get("resilience", {}).get("demotions", [])}
    rb = {d["site"] for d in b.get("resilience", {}).get("demotions", [])}
    if ra != rb:
        lines += ["", f"demotions: {sorted(ra)} -> {sorted(rb)}"]

    # device-cost drift — .get throughout so a v2/v3 pair still diffs
    da = (a.get("device_costs") or {}).get("entries") or {}
    db = (b.get("device_costs") or {}).get("entries") or {}
    if da or db:
        lines += ["", "device costs:"]
        ha = ((a.get("device_costs") or {}).get("hbm")
              or {}).get("peak_bytes")
        hb = ((b.get("device_costs") or {}).get("hbm")
              or {}).get("peak_bytes")
        if ha is not None or hb is not None:
            lines.append(f"  hbm_peak_bytes: {ha} -> {hb}")
        for name in sorted(set(da) | set(db)):
            ea, eb = da.get(name, {}), db.get(name, {})
            for field in ("dispatch_wall_s", "compile_wall_s",
                          "calls"):
                va, vb = ea.get(field), eb.get(field)
                if va is None and vb is None:
                    continue
                delta = ("" if va is None or vb is None
                         else f" ({vb - va:+.6g})")
                lines.append(
                    f"  {name}.{field}: {va} -> {vb}{delta}")

    # sanitizer drift — additive v4 section, .get throughout
    na, nb = a.get("sanitizer"), b.get("sanitizer")
    if na is not None or nb is not None:
        na, nb = na or {}, nb or {}
        lines += ["", "sanitizer drift:"]
        for key in ("acquisitions", "edges_observed",
                    "edges_declared", "undeclared_acquisitions",
                    "undeclared_edges", "inversions", "races",
                    "unexercised"):
            va, vb = int(na.get(key, 0)), int(nb.get(key, 0))
            lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    # index drift — additive v5 section, .get throughout
    ia, ib = a.get("index"), b.get("index")
    if ia is not None or ib is not None:
        ia, ib = ia or {}, ib or {}
        lines += ["", "index drift:"]
        for key in ("generation", "genomes", "clusters", "pairs",
                    "tombstones"):
            va, vb = int(ia.get(key, 0)), int(ib.get(key, 0))
            lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    # fleet drift — additive v7 section, .get throughout
    fla, flb = a.get("fleet"), b.get("fleet")
    if fla is not None or flb is not None:
        fla, flb = fla or {}, flb or {}
        lines += ["", "fleet drift:"]
        for key in ("n_shards", "shards_done", "shards_failed",
                    "preemptions", "reassignments"):
            va, vb = int(fla.get(key, 0)), int(flb.get(key, 0))
            lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    # fleet rollup drift — additive v9 section, .get throughout;
    # tolerates one side being an older (v6-v8) report with no rollup
    ra, rb = a.get("fleet_rollup"), b.get("fleet_rollup")
    if ra is not None or rb is not None:
        ra, rb = ra or {}, rb or {}
        lines += ["", "fleet rollup drift:"]
        wa = float(ra.get("fleet_wall_s") or 0.0)
        wb = float(rb.get("fleet_wall_s") or 0.0)
        lines.append(f"  fleet_wall_s: {wa:.2f} -> {wb:.2f} "
                     f"({wb - wa:+.2f}s)")
        bna = ra.get("bottleneck")
        bnb = rb.get("bottleneck")
        lines.append(f"  bottleneck: {bna} -> {bnb}"
                     + ("  [MIGRATED]" if bna != bnb else ""))
        ca_ = ra.get("components") or {}
        cb_ = rb.get("components") or {}
        for comp in sorted(set(ca_) | set(cb_)):
            va = int(round(100 * ((ca_.get(comp) or {}).get("share")
                                  or 0.0)))
            vb = int(round(100 * ((cb_.get(comp) or {}).get("share")
                                  or 0.0)))
            lines.append(
                f"  share[{comp}]: {va}% -> {vb}% ({vb - va:+d}%)")

    # flow drift — additive v6 section, .get throughout. A migrated
    # bottleneck is THE regression signal the flow layer exists for.
    fa, fb = a.get("flow"), b.get("flow")
    if fa is not None or fb is not None:
        fa, fb = fa or {}, fb or {}
        ca = fa.get("critical_path") or {}
        cb = fb.get("critical_path") or {}
        lines += ["", "flow drift:"]
        bna, bnb = ca.get("bottleneck"), cb.get("bottleneck")
        lines.append(f"  bottleneck: {bna} -> {bnb}"
                     + ("  [MIGRATED]" if bna != bnb else ""))
        sa_, sb_ = ca.get("stages") or {}, cb.get("stages") or {}
        for stage in sorted(set(sa_) | set(sb_)):
            va = int(round(100 * (sa_.get(stage, {}).get("share")
                                  or 0.0)))
            vb = int(round(100 * (sb_.get(stage, {}).get("share")
                                  or 0.0)))
            lines.append(
                f"  share[{stage}]: {va}% -> {vb}% ({vb - va:+d}%)")
        da_ = (fa.get("flows") or {}).get("dropped", 0)
        db_ = (fb.get("flows") or {}).get("dropped", 0)
        if da_ or db_:
            lines.append(f"  dropped flows: {da_} -> {db_}")

    # memory drift — additive v10 section; peak RSS is the out-of-core
    # tier's acceptance metric, so its drift is the headline number.
    ma, mb = a.get("memory"), b.get("memory")
    if ma is not None or mb is not None:
        ma, mb = ma or {}, mb or {}
        lines += ["", "memory drift:"]
        pa = (ma.get("rss_mb") or {}).get("peak_mb")
        pb = (mb.get("rss_mb") or {}).get("peak_mb")
        if pa is not None or pb is not None:
            pa_f, pb_f = float(pa or 0.0), float(pb or 0.0)
            lines.append(
                f"  peak rss: {pa_f:.0f} -> {pb_f:.0f} MB "
                f"({pb_f - pa_f:+.0f} MB)")
        for key in ("page_ins", "page_outs"):
            va = int((ma.get("pagestore") or {}).get(key, 0))
            vb = int((mb.get("pagestore") or {}).get(key, 0))
            if va or vb:
                lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")

    la, lb = a.get("lint"), b.get("lint")
    if la is not None or lb is not None:
        la, lb = la or {}, lb or {}
        lines += ["", "lint drift:"]
        for key in ("errors", "warnings", "notes", "suppressed"):
            va, vb = int(la.get(key, 0)), int(lb.get(key, 0))
            lines.append(f"  {key}: {va} -> {vb} ({vb - va:+d})")
        famc_a = la.get("by_family", {})
        famc_b = lb.get("by_family", {})
        for fam in sorted(set(famc_a) | set(famc_b)):
            va, vb = int(famc_a.get(fam, 0)), int(famc_b.get(fam, 0))
            if va != vb:
                lines.append(
                    f"  {fam}: {va} -> {vb} ({vb - va:+d})")
    return "\n".join(lines) + "\n"
