"""Observability discipline (GL7xx): no ad-hoc timing in the pipeline.
The port's copy of ``galah_tpu/analysis/obs_check.py``.

The telemetry layer (``galah_tpu_torch/obs/``) is where durations
belong: stage spans through ``timing.StageClock``, host-clock seconds
outside a stage through ``timing.Stopwatch``, everything else through
an ``obs.metrics`` histogram's ``.time()`` context manager. A raw
``time.perf_counter()`` pair whose delta only ever reaches a log line
is invisible to the run report and to ``report --diff``, exactly the
number a regression hunt needs.

Pipeline modules are everything under ``galah_tpu_torch/`` EXCEPT the
infrastructure that implements the telemetry itself and the harnesses:

  * ``galah_tpu_torch/timing.py``     the sanctioned timer
  * ``galah_tpu_torch/obs/``          the metrics/trace/report layer
  * ``galah_tpu_torch/analysis/``     the lint suite (host-side tooling)
  * ``galah_tpu_torch/kernels/rehearse_*.py``  timing harnesses, as
    ``scripts/`` are to ``galah_tpu``

(``tests/`` and ``chip_smoke.py`` are outside the GL7xx scope
entirely: they are harnesses, not the pipeline.)

Checks
  GL701  direct wall-clock timing call (``time.time`` /
         ``time.perf_counter`` / ``time.perf_counter_ns`` /
         ``time.process_time``) in a pipeline module; import aliases
         (``import time as _t``, ``from time import perf_counter``)
         are resolved, so renaming does not evade the check.
         ``time.monotonic`` is deliberately NOT flagged: it is the
         deadline/budget accounting clock, not a measurement
         primitive. ``time.sleep`` is not timing at all.
  GL702  logging call whose literal message embeds a formatted
         seconds figure (``%.2fs`` / f-string ``{dt:.1f}s``): the
         signature of a measured duration that lives only in the log.
  GL703  direct device-cost introspection (``.memory_stats()`` /
         ``.cost_analysis()``) in a pipeline module. Device cost
         attribution belongs to ``obs/profile.py`` (the ``profiled``
         registry + ``sample_memory``), where the numbers reach the
         run report's ``device_costs`` section.
  GL704  flow discipline for pipeline-stage modules: a module that
         declares a ``PIPELINE_STAGE`` contract (``pipeline_check``)
         must emit its queue telemetry through ``obs/flow.py``: (a)
         the module never imports/calls ``galah_tpu_torch.obs.flow``
         at all (anchored at the ``PIPELINE_STAGE`` line), or (b) it
         hand-rolls queue-wait timing: an assignment to a ``*wait*``
         name computed from a raw clock read (``time.monotonic``
         included here: it is the sanctioned deadline clock, but a
         wait accumulated from it bypasses the flow recorder's
         blocked-on attribution and the report's critical path). Wrap
         the dequeue in ``obs.flow.blocked(stage, reason)`` and read
         ``.seconds``.

Suppression: the usual inline comment on the flagged line or the line
above, with a justification:

    started = time.time()  # galah-lint: ignore[GL701] wall-clock stamp

Legitimate cases are timestamps (not durations), the raw input of a
trace span, and log lines whose seconds figure is ALSO recorded in the
registry.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List

from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)

# The measurement clocks GL701 bans from pipeline modules.
TIMING_CALLS = frozenset({
    "time.time",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.process_time",
})

# Device-cost introspection methods GL703 reserves for obs/profile.py,
# matched as attribute calls (``<anything>.memory_stats()``).
DEVICE_COST_CALLS = frozenset({"memory_stats", "cost_analysis"})

# The clocks GL704 treats as hand-rolled queue timing when they feed a
# ``*wait*`` accumulator in a PIPELINE_STAGE module. time.monotonic is
# allowed everywhere else (deadline/budget accounting) but a wait
# derived from it bypasses obs/flow.py's blocked-on attribution.
_QUEUE_CLOCKS = TIMING_CALLS | frozenset({"time.monotonic"})

_EXEMPT_PREFIXES = ("galah_tpu_torch/obs/", "galah_tpu_torch/analysis/",
                    "galah_tpu_torch/kernels/rehearse_")
_EXEMPT_FILES = ("galah_tpu_torch/timing.py",)

# "%.2fs", "%.1f s", "%fs" inside a %-format log message.
_PCT_SECONDS_RE = re.compile(r"%\.?\d*f\s?s\b")
# ".2f"-style format_spec; the following literal must start with "s".
_SPEC_SECONDS_RE = re.compile(r"^\.\d+f$")

_LOG_METHODS = frozenset({"debug", "info", "warning", "error",
                          "critical", "exception", "log"})


def in_scope(path: str) -> bool:
    """True for pipeline modules: galah_tpu_torch/ minus the telemetry,
    the tooling and the harnesses (module docstring)."""
    p = path.replace("\\", "/")
    if not p.startswith("galah_tpu_torch/"):
        return False
    return not p.startswith(_EXEMPT_PREFIXES) and p not in _EXEMPT_FILES


def _time_aliases(tree: ast.Module,
                  banned: frozenset = TIMING_CALLS) -> Dict[str, str]:
    """name-as-written -> canonical dotted name for the time module
    and its banned members, resolving import aliases."""
    alias: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    alias[a.asname or a.name] = "time"
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                full = f"time.{a.name}"
                if full in banned:
                    alias[a.asname or a.name] = full
    return alias


def _resolve_clock(call: ast.Call, aliases: Dict[str, str],
                   banned: frozenset) -> "str | None":
    """Canonical dotted name of a banned clock call, alias-resolved;
    None when the call is not one."""
    name = dotted_name(call.func)
    if name in banned:
        return name
    if "." in name:
        head, _, tail = name.partition(".")
        if aliases.get(head) == "time" and f"time.{tail}" in banned:
            return f"time.{tail}"
        return None
    full = aliases.get(name)
    return full if full in banned else None


def _is_log_call(node: ast.Call) -> bool:
    """logger.warning(...), logging.info(...), self._log.debug(...)."""
    fn = node.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in _LOG_METHODS:
        return False
    owner = dotted_name(fn.value)
    base = owner.split(".")[-1].lower()
    return "log" in base


def _literal_has_seconds(node: ast.AST) -> bool:
    """A string literal (plain or f-string) formatting a seconds
    figure: '%.2fs' or f'{dt:.1f}s'."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return bool(_PCT_SECONDS_RE.search(node.value))
    if isinstance(node, ast.JoinedStr):
        parts = node.values
        for i, part in enumerate(parts):
            if not isinstance(part, ast.FormattedValue):
                continue
            spec = part.format_spec
            if not (isinstance(spec, ast.JoinedStr) and spec.values):
                continue
            s0 = spec.values[0]
            if not (isinstance(s0, ast.Constant)
                    and isinstance(s0.value, str)
                    and _SPEC_SECONDS_RE.match(s0.value)):
                continue
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            if (isinstance(nxt, ast.Constant)
                    and isinstance(nxt.value, str)
                    and nxt.value.startswith("s")):
                return True
    return False


def check_obs_file(src: SourceFile) -> List[Finding]:
    """GL701/GL702/GL703 over one source file (no-op outside the
    scope)."""
    if not in_scope(src.path):
        return []
    findings: List[Finding] = []
    aliases = _time_aliases(src.tree)
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        resolved = _resolve_clock(node, aliases, TIMING_CALLS)
        if resolved is not None:
            findings.append(Finding(
                "GL701", Severity.WARNING, src.path, node.lineno,
                f"direct {resolved}() in a pipeline module — measure "
                "durations with an obs.metrics histogram's .time() "
                "(or a timing.py stage) so they land in the run "
                "report, not only in locals"))
            continue
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in DEVICE_COST_CALLS):
            findings.append(Finding(
                "GL703", Severity.WARNING, src.path, node.lineno,
                f"direct .{node.func.attr}() in a pipeline module — "
                "device-cost introspection belongs to obs/profile.py "
                "(@profiled entry points + profile.sample_memory), "
                "where the numbers reach the run report's "
                "device_costs section and the perf ledger"))
            continue
        if _is_log_call(node) and any(
                _literal_has_seconds(a) for a in node.args):
            # anchor at the message literal so a suppression comment
            # sits next to the offending format, not the call head
            lit = next(a for a in node.args if _literal_has_seconds(a))
            findings.append(Finding(
                "GL702", Severity.WARNING, src.path, lit.lineno,
                "log message formats a seconds figure — a measured "
                "duration that lives only in the log; record it in "
                "the obs.metrics registry (and log it too if useful) "
                "so `galah_tpu_torch report --diff` can see it"))
    findings.extend(_check_flow_discipline(src))
    return findings


def _flow_imports(tree: ast.Module):
    """(module-alias names, directly imported function names) bound to
    galah_tpu_torch.obs.flow anywhere in the file: module-level or the
    lazy function-level imports the pipeline modules use."""
    mod_names = set()
    fn_names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "galah_tpu_torch.obs.flow" and a.asname:
                    mod_names.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "galah_tpu_torch.obs":
                for a in node.names:
                    if a.name == "flow":
                        mod_names.add(a.asname or "flow")
            elif node.module == "galah_tpu_torch.obs.flow":
                for a in node.names:
                    fn_names.add(a.asname or a.name)
    return mod_names, fn_names


def _check_flow_discipline(src: SourceFile) -> List[Finding]:
    """GL704 over one in-scope file: only fires on modules declaring a
    module-level ``PIPELINE_STAGE`` contract."""
    stage_line = None
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PIPELINE_STAGE"
                for t in node.targets):
            stage_line = node.lineno
            break
    if stage_line is None:
        return []
    findings: List[Finding] = []
    mod_names, fn_names = _flow_imports(src.tree)
    uses_flow = False
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if dotted_name(fn.value).partition(".")[0] in mod_names:
                uses_flow = True
                break
        elif isinstance(fn, ast.Name) and fn.id in fn_names:
            uses_flow = True
            break
    if not uses_flow:
        findings.append(Finding(
            "GL704", Severity.WARNING, src.path, stage_line,
            "module declares PIPELINE_STAGE but never emits flow "
            "spans — bracket its dequeues with obs.flow.blocked() and "
            "its work with obs.flow.record_service()/span() so the "
            "run report's critical path can attribute this stage"))
    aliases = _time_aliases(src.tree, banned=_QUEUE_CLOCKS)
    for node in src.walk():
        if not isinstance(node, (ast.Assign, ast.AugAssign)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        waitish = any(
            "wait" in (t.id if isinstance(t, ast.Name) else
                       t.attr if isinstance(t, ast.Attribute) else
                       "").lower()
            for t in targets)
        if not waitish:
            continue
        clock = next(
            (_resolve_clock(c, aliases, _QUEUE_CLOCKS)
             for c in ast.walk(node.value)
             if isinstance(c, ast.Call)
             and _resolve_clock(c, aliases, _QUEUE_CLOCKS)), None)
        if clock is not None:
            findings.append(Finding(
                "GL704", Severity.WARNING, src.path, node.lineno,
                f"hand-rolled queue-wait timing ({clock}() feeding a "
                "wait accumulator) in a PIPELINE_STAGE module — wrap "
                "the dequeue in obs.flow.blocked(stage, reason) and "
                "accumulate its .seconds so the wait carries blocked-"
                "on attribution in the report's critical path"))
    return findings
