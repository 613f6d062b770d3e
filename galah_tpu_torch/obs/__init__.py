"""Run observability: the port's copy of ``galah_tpu/obs/``' run-report
lifecycle.

  * ``obs.metrics``: the typed metrics registry (counters, gauges,
    histograms) with thread-safe emission;
  * ``obs.trace``: the Chrome-trace span/event recorder behind
    ``--trace-events PATH`` (Perfetto-loadable; stage spans, nvcc build
    spans); ``obs.events`` adds structured events (quarantines,
    preemptions, resumes, retries) to the same timeline and to the
    report;
  * ``obs.report``: assembles ``run_report.json`` at run end
    (``--run-report PATH`` / ``GALAH_OBS_REPORT``) from the run's
    ``timing.StageClock`` and the registries, and powers the ``report``
    subcommand (render and ``--diff``);
  * ``obs.heartbeat``: the periodic ``heartbeat.jsonl`` liveness
    snapshot (``GALAH_OBS_HEARTBEAT_S``), read by ``top``; each beat
    also writes the OpenMetrics page (``obs.openmetrics``,
    ``GALAH_OBS_OPENMETRICS``);
  * ``obs.profile``: per-kernel device costs, the report's
    ``device_costs`` (``GALAH_OBS_PROFILE``);
  * ``obs.flow``: flow items, per-stage service and waits, the report's
    ``flow`` critical path behind ``flow analyze`` (``GALAH_OBS_FLOW``);
  * ``obs.ledger``: the cross-run perf ledger (``GALAH_OBS_LEDGER``,
    the ``perf`` subcommand).

``reset_run()`` gives a run a clean slate; ``finalize()`` assembles and
validates the report when a report or a ledger entry is asked for,
writes the one and appends the other, and closes the trace. A
telemetry failure logs a warning and never fails the run; it never
moves a kernel to its plain version or the run to the CPU either.

``report`` and ``ledger`` are imported lazily, at assembly time.
"""

from __future__ import annotations

import atexit
import logging
import os
import re
import sys
from typing import List, Optional

from galah_tpu_torch.obs import (events, flow, heartbeat, metrics,
                                 openmetrics, profile, trace)

logger = logging.getLogger(__name__)


def reset_run() -> None:
    """Fresh metrics, events, kernel costs, flow recorder, heartbeat,
    OpenMetrics provider, index and fleet snapshots and dispatch retry
    counts for a new run (the trace recorder's lifetime is the CLI
    invocation, managed by start/stop)."""
    from galah_tpu_torch import fleet as fleet_pkg
    from galah_tpu_torch import index as index_pkg
    from galah_tpu_torch.resilience import dispatch as rdispatch

    metrics.reset()
    events.reset()
    profile.reset()
    flow.reset()
    heartbeat.reset()
    openmetrics.reset()
    index_pkg.reset()
    fleet_pkg.reset()
    rdispatch.reset_counts()


def _shard_context(report_path: Optional[str]) -> Optional[int]:
    """The fleet shard this process finalizes for, or None: a fleet
    worker carries the supervisor's GALAH_TPU_FLEET_WORKER stamp and
    reports under ``shards/shard_NNN/``; both must hold before its
    ledger entry gets a shard key (``galah_tpu/obs._shard_context``)."""
    if not os.environ.get("GALAH_TPU_FLEET_WORKER"):
        return None
    m = re.search(r"shard_(\d+)", os.path.abspath(report_path or ""))
    return int(m.group(1)) if m else None


def finalize(subcommand: str, clock=None,
             report_path: Optional[str] = None,
             argv: Optional[List[str]] = None,
             started_at: Optional[float] = None,
             lint: Optional[dict] = None) -> Optional[dict]:
    """Stop the heartbeat (its final beat); with a `report_path` or a
    ledger (``GALAH_OBS_LEDGER``) assemble the run report from the
    run's `clock` (a ``timing.StageClock``, or None when the run
    stopped before making one) and validate it against the schema;
    write it to `report_path`, append its entry to the ledger (a fleet
    worker's under its shard's key); then close the trace. Returns the
    report, or None. Telemetry failures log and return None; they never
    fail the run. `lint` attaches the static-analysis summary (lint runs
    only).

    ``galah_tpu`` assembles and validates a report on every run; the
    port only when a report or a ledger entry is asked for (the schema
    check alone imports jsonschema, which ``chip_smoke.py`` phase 4o
    times)."""
    from galah_tpu_torch.config import env_value

    out = None
    try:
        # stop the heartbeat first (it writes its final beat), so the
        # report's series covers the whole run; the stop in the finally
        # below is then an idempotent no-op
        heartbeat.stop()
        ledger_path = env_value("GALAH_OBS_LEDGER")
        if report_path or ledger_path:
            from galah_tpu_torch.obs import report as report_mod

            out = report_mod.assemble(subcommand, clock, argv=argv,
                                      started_at=started_at, lint=lint)
            problems = report_mod.validate(out)
            if problems:  # a bug in assembly, not in the user's run
                logger.warning("run report failed schema validation: %s",
                               "; ".join(problems[:5]))
            if report_path:
                report_mod.write(report_path, out)
            if ledger_path:
                from galah_tpu_torch.obs import ledger as ledger_mod

                ledger_mod.record_report(ledger_path, out, subcommand,
                                         shard=_shard_context(report_path))
    except Exception:
        logger.warning("run report assembly failed", exc_info=True)
    finally:
        heartbeat.stop()
        trace.stop()
    return out


# -- crash and preemption artifact flushing ----------------------------
#
# Three exits can interrupt a run mid-stream: the cooperative
# preemption path (first signal -> PreemptionRequested -> finalize),
# an unhandled exception, and the second-signal hard exit. finalize()
# covers the first; the hooks below cover the other two, so the trace
# gets its JSON terminator and the heartbeat its final beat: an
# interrupted run's artifacts must always load.

_CRASH_HOOKS = {"installed": False}


def flush_artifacts() -> None:
    """Best-effort drain of the streaming sinks (idempotent:
    trace.stop and heartbeat.stop both tolerate repeat calls)."""
    try:
        heartbeat.stop()
    except Exception:
        logger.debug("heartbeat flush failed", exc_info=True)
    try:
        trace.stop()
    except Exception:
        logger.debug("trace flush failed", exc_info=True)


def install_crash_hooks() -> None:
    """Arm atexit, the excepthook and the second-signal flush
    (idempotent, once a process; the CLI calls it next to
    ``interrupt.install``)."""
    if _CRASH_HOOKS["installed"]:
        return
    _CRASH_HOOKS["installed"] = True
    atexit.register(flush_artifacts)
    prev_hook = sys.excepthook

    def _excepthook(tp, val, tb):
        flush_artifacts()
        prev_hook(tp, val, tb)

    sys.excepthook = _excepthook
    # second-signal hard exit: only the lock-light heartbeat flush (one
    # O_APPEND write); the trace is durable per event, and closing it
    # could deadlock inside a signal handler
    from galah_tpu_torch.resilience import interrupt

    interrupt.register_flush(heartbeat.flush)
