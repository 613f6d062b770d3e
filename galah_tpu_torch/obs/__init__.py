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
    snapshot (``GALAH_OBS_HEARTBEAT_S``).

``reset_run()`` gives a run a clean slate; ``finalize()`` assembles,
validates and writes the report, when one is asked for, and closes the
trace. A telemetry failure logs a warning and never fails the run; it
never moves a kernel to its plain version or the run to the CPU
either.

``report`` is imported lazily, at assembly time.
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
from typing import List, Optional

from galah_tpu_torch.obs import events, heartbeat, metrics, trace

logger = logging.getLogger(__name__)

#: ``galah_tpu``'s cross-run perf ledger variable; the port has no
#: ledger yet, and says so when it is set
LEDGER_ENV = "GALAH_OBS_LEDGER"


def reset_run() -> None:
    """Fresh metrics, events, heartbeat and index snapshot for a new
    run (the trace recorder's lifetime is the CLI invocation, managed
    by start/stop)."""
    from galah_tpu_torch import index as index_pkg

    metrics.reset()
    events.reset()
    heartbeat.reset()
    index_pkg.reset()


def finalize(subcommand: str, clock=None,
             report_path: Optional[str] = None,
             argv: Optional[List[str]] = None,
             started_at: Optional[float] = None) -> Optional[dict]:
    """Stop the heartbeat (its final beat), and with a `report_path`
    assemble the run report from the run's `clock` (a
    ``timing.StageClock``, or None when the run stopped before making
    one), validate it against the schema and write it; then close the
    trace. Returns the report, or None. Telemetry failures log and
    return None; they never fail the run.

    ``galah_tpu`` assembles and validates a report on every run, for
    its perf ledger; the port has no ledger, and builds a report only
    when one is asked for (the schema check alone imports jsonschema,
    which ``chip_smoke.py`` phase 4o times)."""
    out = None
    try:
        # stop the heartbeat first (it writes its final beat), so the
        # report's series covers the whole run; the stop in the finally
        # below is then an idempotent no-op
        heartbeat.stop()
        if report_path:
            from galah_tpu_torch.obs import report as report_mod

            out = report_mod.assemble(subcommand, clock, argv=argv,
                                      started_at=started_at)
            problems = report_mod.validate(out)
            if problems:  # a bug in assembly, not in the user's run
                logger.warning("run report failed schema validation: %s",
                               "; ".join(problems[:5]))
            report_mod.write(report_path, out)
        if os.environ.get(LEDGER_ENV):
            logger.warning("%s is set, but galah_tpu_torch has no perf "
                           "ledger yet: no ledger entry is written",
                           LEDGER_ENV)
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
