"""The device-dispatch supervisor: retry and validate a guarded call, then
raise; the port's counterpart of ``galah_tpu/resilience/dispatch.py``.

Every guarded call goes through ``run(site, primary, validate)``:

  1. the fault injector (``resilience/faults.py``, ``GALAH_FI``) is
     consulted before the dispatch and may corrupt its result;
  2. the primary runs under the ``GALAH_RETRY`` policy
     (``resilience/policy.py``: backoff, per-attempt deadline, total
     budget), read from the environment at each call unless the
     supervisor was given one;
  3. the result is validated (``expect_len``, ``expect_ani_values``):
     a result that fails is retried like any transient failure;
  4. when the attempts run out, the last error raises, noted with the
     site and the attempt count. Nothing demotes: no site falls back to
     the CPU or to a plain version, so ``demotions()`` is always empty.
     A run that stops here is continued by ``--resume`` in a fresh
     process.

The guarded sites are ``galah_tpu``'s names, each wrapped around a whole
call that is safe to repeat: ``dispatch.ani`` (the engine's ANI batch,
``cluster/engine._backend_ani_batch``), ``dispatch.fragment-ani``
(``backends/fragment_backend._exact_ani``), ``dispatch.sketch-minhash``
and ``dispatch.sketch-hll`` (a launch group's sketches,
``ops/sketch_stream._iter_computed``) and ``collective.<tag>``
(``parallel/distributed.exchange``). No retry goes inside a kernel
wrapper, the device pair queue or a slab fold.

Each retry adds one to ``retry_counts()[site]``, the run's retries:
``obs.reset_run`` clears them when a run starts, and the run report
reads them as its ``retries[<site>]`` counters and
``resilience.retries``. Each also counts into the ``dispatch.retries``
metric and records a ``retry`` event.

Deadlines differ from ``galah_tpu``'s: an attempt abandoned before its
primary began is retried and never dispatches afterwards; one abandoned
after raises ``DeadlineExceeded`` with no retry (``policy.py``'s
docstring says why). A site nested inside another's attempt
(``dispatch.fragment-ani`` inside ``dispatch.ani``) decides for it
while it runs: an enclosing attempt abandoned while the nested site
waits before its dispatch is retried, and nothing on its thread
dispatches or retries afterwards.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Callable, Dict, List, Optional, TypeVar

from galah_tpu_torch.obs import events as obs_events
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.resilience import faults
from galah_tpu_torch.resilience.policy import (AttemptAbandoned,
                                               GarbageResultError,
                                               RetryPolicy,
                                               attempt_abandoned,
                                               begin_dispatch,
                                               call_with_retry,
                                               frees_device_memory,
                                               is_retryable, nested_call)

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): guarded
# calls retry on whatever thread makes them; the per-site retry counts
# stay under _LOCK, which is released before any telemetry is emitted
# (obs takes its own locks and must not nest inside this one).
GUARDED_BY = {"_RETRIES": "_LOCK"}
LOCK_ORDER = ["_LOCK"]

_LOCK = threading.Lock()
#: the run's retries by site
_RETRIES: Dict[str, int] = {}


def retry_counts() -> Dict[str, int]:
    """Retries by site since the run started (``reset_counts``)."""
    with _LOCK:
        return dict(_RETRIES)


def reset_counts() -> None:
    """Clear the retry counts for a new run (``obs.reset_run``)."""
    with _LOCK:
        _RETRIES.clear()


def _count_retry(site: str) -> None:
    with _LOCK:
        _RETRIES[site] = _RETRIES.get(site, 0) + 1


def _empty_cache() -> None:
    """Hand the caching allocator's free blocks back to the card, so
    that a retry after an allocation failure finds them."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _retryable_here(exc: BaseException) -> bool:
    """``is_retryable``, less the errors a guarded site nested inside
    this one already gave up on, and nothing on the thread of an
    abandoned attempt."""
    return (is_retryable(exc)
            and getattr(exc, "dispatch_exhausted", None) is None
            and not attempt_abandoned())


class DispatchSupervisor:
    """The retry policy of a process's guarded sites."""

    def __init__(self, policy: Optional[RetryPolicy] = None) -> None:
        self._policy = policy

    @property
    def policy(self) -> RetryPolicy:
        """The given policy, else ``GALAH_RETRY``'s as the environment
        now says."""
        return self._policy or RetryPolicy.from_env()

    def demotions(self) -> List[object]:
        """Always empty: the port raises where ``galah_tpu`` demotes."""
        return []

    def run(self, site: str, primary: Callable[[], T],
            validate: Optional[Callable[[T], None]] = None,
            policy: Optional[RetryPolicy] = None) -> T:
        """One guarded call at `site`. See the module docstring."""
        pol = policy or self.policy
        injector = faults.get_injector()
        attempts = [0]

        def attempt() -> T:
            attempts[0] += 1
            if injector is not None:
                injector.before_dispatch(site)
            if not begin_dispatch():
                # abandoned at its deadline (it or the attempt it runs
                # inside) before it began: the retry owns the buffers
                # now, and nobody waits for this result
                raise AttemptAbandoned(
                    f"{site}: attempt abandoned before its dispatch")
            out = primary()
            if injector is not None:
                out = injector.corrupt(site, out)
            if validate is not None:
                validate(out)
            return out

        def on_retry(attempt_n: int, exc: BaseException) -> None:
            _count_retry(site)
            obs_metrics.counter(
                "dispatch.retries",
                help="Dispatch attempts retried after a transient "
                     "failure").inc()
            obs_events.record("retry", site=site, attempt=attempt_n,
                              error=f"{type(exc).__name__}: {exc}")
            if frees_device_memory(exc):
                _empty_cache()

        try:
            with nested_call():
                return call_with_retry(attempt, pol, site=site,
                                       classify=_retryable_here,
                                       on_retry=on_retry)
        except Exception as e:
            if not _retryable_here(e):
                raise  # deterministic, or fatal to the CUDA context
            # the attempts or the budget ran out; an enclosing site does
            # not retry what this one gave up on
            e.dispatch_exhausted = site  # type: ignore[attr-defined]
            logger.error(
                "%s: dispatch failed after %d attempt(s) (%s: %s); the "
                "port does not fall back, so the run stops here (a "
                "checkpointed run continues with --resume)", site,
                attempts[0], type(e).__name__, e)
            e.add_note(f"{site}: gave up after {attempts[0]} attempt(s)")
            raise


def expect_len(n: int) -> Callable[[object], None]:
    """Validator: the dispatch must return exactly n results."""

    def check(out) -> None:
        try:
            got = len(out)  # type: ignore[arg-type]
        except TypeError:
            raise GarbageResultError(
                f"dispatch returned non-sequence {type(out).__name__}")
        if got != n:
            raise GarbageResultError(
                f"dispatch returned {got} results for {n} inputs")

    return check


def expect_ani_values(n: int) -> Callable[[object], None]:
    """Validator for ANI batches: n results, each None or a finite
    fraction in [0, 1]; a value out of range is the signature of a
    corrupted device result."""
    check_len = expect_len(n)

    def check(out) -> None:
        check_len(out)
        for v in out:  # type: ignore[union-attr]
            if v is None:
                continue
            f = float(v)
            if not 0.0 <= f <= 1.0:  # NaN fails both comparisons
                raise GarbageResultError(
                    f"dispatch returned out-of-range ANI {v!r}")

    return check


# The process's supervisor: call sites use the module-level helpers.
GLOBAL = DispatchSupervisor()


def run(site: str, primary: Callable[[], T],
        validate: Optional[Callable[[T], None]] = None,
        policy: Optional[RetryPolicy] = None) -> T:
    return GLOBAL.run(site, primary, validate=validate, policy=policy)


def demotions() -> List[object]:
    return GLOBAL.demotions()


def reset(policy: Optional[RetryPolicy] = None) -> None:
    """A fresh supervisor with `policy` (None: the environment's at each
    call)."""
    global GLOBAL
    GLOBAL = DispatchSupervisor(policy)
