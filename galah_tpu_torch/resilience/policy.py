"""Retry policy: exponential backoff with jitter, a per-attempt deadline
and an overall budget; the port's copy of
``galah_tpu/resilience/policy.py``.

Two callers use it. Host reads of genome files (``io/fasta.py``, the
``GALAH_IO_RETRY`` policy) retry a flaky network filesystem. The
device-dispatch supervisor (``resilience/dispatch.py``, the
``GALAH_RETRY`` policy) retries a transient failure of a whole guarded
call and then raises: nothing here sends work to the CPU or to a plain
version.

The retry classification (``is_retryable``) is ``galah_tpu``'s with
CUDA in place of XLA. A CUDA allocation failure (``cudaError_t`` 2 from
a kernel's launch function, ``KernelLaunchError``, or torch's
``OutOfMemoryError``) is transient: another process on the card may
free its memory. Every other CUDA error is not. The sticky ones (700,
702, 710, 714-719) leave the process's CUDA context unusable, so a
retry in the same process cannot succeed; the recovery is ``--resume``
in a fresh process. torch's CUDA errors are matched by type name, so
the module imports on a machine without CUDA.

``run_with_deadline`` differs from ``galah_tpu``'s in one rule. There an
attempt past its deadline is abandoned and retried, and its thread may
still dispatch later, which is harmless for immutable JAX arrays. The
port's guarded calls write held and pinned buffers (the group buffer of
``io/group.py``, the device pair queue), so a late dispatch from an
abandoned attempt would race its retry. An attempt therefore calls
``begin_dispatch()`` before its work starts: once the attempt, or any
attempt it runs inside, was abandoned, it returns False and the attempt
dispatches nothing. An attempt abandoned before it began is retried;
one abandoned after it began raises ``DeadlineExceeded`` with
``dispatched=True``, which is not retried, because its work may still
be running on the card.

Guarded calls nest: ``dispatch.ani``'s batch reaches
``dispatch.fragment-ani``. While a nested guarded call runs
(``nested_call``), whether the enclosing attempt has begun is read from
the nested call's current attempt, the innermost one that dispatches:
an enclosing attempt abandoned while its nested call waits before its
dispatch (an injected ``hang``) is retried, as ``galah_tpu`` retries
it, and its thread dispatches nothing more. Work it dispatched before
the nested call is on the stream ahead of the retry's.

Jitter is deterministic per (seed, site, attempt) when the policy
carries a seed, bit-equal to ``galah_tpu``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import sys
import threading
import time
from typing import Callable, Iterator, Optional, Tuple, Type, TypeVar

from galah_tpu_torch.obs import flow as obs_flow

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): a
# RetryPolicy is immutable and call_with_retry keeps its state per
# call (the read threads of io/prefetch.py call it at once). An
# attempt run under a deadline hands its result back through a per-call
# box and a threading.Event. The _Attempt tokens' state, written by the
# attempt threads and the threads that wait on them, stays under one
# lock: begin() reads up a chain of tokens and abandon() down it.
GUARDED_BY = {
    "_Attempt._abandoned": "_TOKENS",
    "_Attempt._began": "_TOKENS",
    "_Attempt._nested": "_TOKENS",
    "_Attempt._inner": "_TOKENS",
}
LOCK_ORDER = ["_TOKENS"]

logger = logging.getLogger(__name__)

T = TypeVar("T")


class TransientDispatchError(RuntimeError):
    """A dispatch fault worth retrying (injected or classified)."""


class DeviceLostError(RuntimeError):
    """The device went away mid-run (an injected fault's signature)."""


class GarbageResultError(RuntimeError):
    """A dispatch returned a result that fails shape/range validation."""


class AttemptAbandoned(RuntimeError):
    """Raised on an attempt's thread, in place of its dispatch, once the
    attempt or one it runs inside was abandoned at a deadline: nobody
    waits for its result, and nothing may be dispatched. Not retried."""


class DeadlineExceeded(TimeoutError):
    """An attempt outlived its per-attempt deadline and was abandoned.
    `dispatched` says whether its work had begun: then it may still be
    running on the card, and the attempt is not retried."""

    def __init__(self, *args, dispatched: bool = False) -> None:
        super().__init__(*args)
        self.dispatched = dispatched


#: Exception types retried by default. ValueError, KeyError and other
#: CUDA errors are deterministic, or fatal to the process's context:
#: retrying them only delays the real traceback.
RETRYABLE_TYPES: Tuple[Type[BaseException], ...] = (
    OSError,
    TimeoutError,          # includes DeadlineExceeded
    TransientDispatchError,
    DeviceLostError,
    GarbageResultError,
)

#: Exception type NAMES retried by default: torch's caching-allocator
#: failure (``torch.cuda.OutOfMemoryError``), matched by name so that
#: this module never needs CUDA; the counterpart of ``galah_tpu``'s
#: ``XlaRuntimeError``
RETRYABLE_NAMES = frozenset({"OutOfMemoryError"})

#: torch's other CUDA errors, by name; their ``error_code``, when they
#: carry one, decides as a kernel's ``cudaError_t`` does
CUDA_ERROR_NAMES = frozenset({"AcceleratorError"})

#: cudaErrorMemoryAllocation: the one CUDA error worth a retry. The
#: sticky ones (700 illegal address, 702 launch timeout, 710 device
#: assert, 714-719 hardware stop to launch failure) lose the CUDA
#: context until the process ends, and the rest are deterministic.
RETRYABLE_CUDA_CODES = frozenset({2})


def cuda_error_code(exc: BaseException) -> Optional[int]:
    """The ``cudaError_t`` an exception carries: a kernel launch's
    (``KernelLaunchError.cuda_error``) or torch's (``error_code`` of a CUDA
    error class matched by name; -1 when it carries none), else None
    for an exception that is no CUDA error."""
    code = getattr(exc, "cuda_error", None)
    if isinstance(code, int):
        return code
    if type(exc).__name__ in CUDA_ERROR_NAMES:
        code = getattr(exc, "error_code", None)
        return code if isinstance(code, int) else -1
    return None


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, FileNotFoundError):
        return False  # a missing path will not appear on retry
    if isinstance(exc, DeadlineExceeded) and exc.dispatched:
        return False  # its work may still be running on the card
    code = cuda_error_code(exc)
    if code is not None:
        return code in RETRYABLE_CUDA_CODES
    return (isinstance(exc, RETRYABLE_TYPES)
            or type(exc).__name__ in RETRYABLE_NAMES)


def frees_device_memory(exc: BaseException) -> bool:
    """Whether `exc` is an allocation failure, after which the caching
    allocator's free blocks are handed back before the backoff."""
    return (type(exc).__name__ in RETRYABLE_NAMES
            or cuda_error_code(exc) in RETRYABLE_CUDA_CODES)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule and deadlines for one class of call.

    delay(attempt) = min(max_delay, base_delay * 2^attempt), scaled by
    a jitter factor in [1 - jitter, 1 + jitter] (deterministic per site
    and attempt when `seed` is set). `attempt_deadline` bounds one
    attempt; `total_budget` bounds the whole loop, sleeps included.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    attempt_deadline: Optional[float] = None
    total_budget: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    @classmethod
    def from_env(cls, prefix: str = "GALAH_RETRY",
                 defaults: Optional[dict] = None,
                 **overrides) -> "RetryPolicy":
        """The policy with `defaults`, overridden by
        ``<prefix>_MAX_ATTEMPTS``, ``_BASE_DELAY``, ``_MAX_DELAY``,
        ``_JITTER``, ``_ATTEMPT_DEADLINE``, ``_TOTAL_BUDGET`` and
        ``_SEED`` from the environment; keyword `overrides` win over
        both."""
        spec = {"max_attempts": int, "base_delay": float,
                "max_delay": float, "jitter": float,
                "attempt_deadline": float, "total_budget": float,
                "seed": int}
        kwargs = dict(defaults or {})
        for name, conv in spec.items():
            raw = os.environ.get(f"{prefix}_{name.upper()}")
            if raw:
                kwargs[name] = conv(raw)
        kwargs.update(overrides)
        return cls(**kwargs)

    def delay(self, attempt: int, site: str = "") -> float:
        """The sleep after failed attempt `attempt` (0-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        if self.jitter:
            u = (random.Random(f"{self.seed}:{site}:{attempt}").random()
                 # galah-lint: ignore[GL904] unseeded jitter only de-synchronizes retries; seed= makes it reproducible
                 if self.seed is not None else random.random())
            d *= 1.0 - self.jitter + 2.0 * self.jitter * u
        return d


_TOKENS = threading.Lock()


class _Attempt:
    """One attempt run under a deadline: the hand-off between the thread
    that runs it and the thread that waits for it. `parent` is the
    attempt it runs inside, if any."""

    def __init__(self, parent: Optional["_Attempt"] = None) -> None:
        self.parent = parent
        self._abandoned = False
        self._began = False
        self._nested = 0      # nested guarded calls running inside it
        self._inner: Optional[_Attempt] = None  # their current attempt

    def _cut(self) -> bool:
        """This attempt or one it runs inside was abandoned (under
        _TOKENS)."""
        tok: Optional[_Attempt] = self
        while tok is not None:
            if tok._abandoned:
                return True
            tok = tok.parent
        return False

    def _dispatched(self) -> bool:
        """Whether the work may be on the card (under _TOKENS): while a
        nested guarded call runs, its current attempt decides."""
        if self._nested:
            return self._inner is not None and self._inner._dispatched()
        return self._began

    def begin(self) -> bool:
        """Mark the attempt's work begun; False once it, or an attempt
        it runs inside, was abandoned, and then the work must not
        start."""
        with _TOKENS:
            if self._cut():
                return False
            self._began = True
            return True

    def abandon(self) -> bool:
        """Mark the attempt abandoned; whether its work had begun."""
        with _TOKENS:
            self._abandoned = True
            return self._dispatched()

    def cut(self) -> bool:
        with _TOKENS:
            return self._cut()

    def enter_nested(self) -> None:
        with _TOKENS:
            self._nested += 1

    def leave_nested(self) -> None:
        with _TOKENS:
            self._nested -= 1
            if not self._nested:
                self._inner = None

    def set_inner(self, tok: Optional["_Attempt"],
                  was: Optional["_Attempt"] = None) -> None:
        """The nested call's current attempt is `tok` (None: between
        its attempts); with `was`, only if it still is `was`."""
        with _TOKENS:
            if self._nested and (was is None or self._inner is was):
                self._inner = tok


_CURRENT = threading.local()


def _current() -> Optional[_Attempt]:
    return getattr(_CURRENT, "attempt", None)


def begin_dispatch() -> bool:
    """Called by an attempt just before its work (a dispatch) starts:
    False when the attempt running on this thread, or one it runs
    inside, was abandoned at its deadline, and then nothing may be
    dispatched. Outside an attempt, always True."""
    tok = _current()
    return True if tok is None else tok.begin()


def attempt_abandoned() -> bool:
    """Whether the attempt running on this thread, or one it runs
    inside, was abandoned: its thread then retries nothing."""
    tok = _current()
    return tok is not None and tok.cut()


@contextlib.contextmanager
def nested_call() -> Iterator[None]:
    """Marks a guarded call running inside the attempt on this thread
    (if any): until it returns, whether that attempt has begun is read
    from the call's current attempt (see the module docstring)."""
    tok = _current()
    if tok is None:
        yield
        return
    tok.enter_nested()
    try:
        yield
    finally:
        tok.leave_nested()


def _device_binder() -> Callable[[], None]:
    """A callable that makes the calling thread's current CUDA device
    current on another thread (a thread starts on device 0), or a no-op
    when CUDA was never initialized in this process."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return lambda: None
    dev = torch.cuda.current_device()
    return lambda: torch.cuda.set_device(dev)


def run_with_deadline(fn: Callable[[], T],
                      deadline: Optional[float]) -> T:
    """fn(), abandoned with ``DeadlineExceeded`` after `deadline`
    seconds (None: run inline, no thread; inside another attempt, under
    that attempt's deadline).

    The attempt runs on a daemon thread under the flow context and CUDA
    device of the calling thread. On expiry it is abandoned, not
    cancelled (a call wedged in native code cannot be interrupted from
    Python): its token is marked, so that ``begin_dispatch`` stops it,
    and every attempt it runs inside, before their work if they had
    not begun, and the exception's `dispatched` says which case this
    was (see the module docstring).
    """
    parent = _current()
    if deadline is None and parent is None:
        return fn()
    tok = _Attempt(parent)
    if parent is not None:
        parent.set_inner(tok)
    if deadline is None:
        # inline, under the enclosing attempt's deadline
        _CURRENT.attempt = tok
        try:
            return fn()
        finally:
            _CURRENT.attempt = parent
            parent.set_inner(None, was=tok)  # type: ignore[union-attr]
    box: dict = {}
    done = threading.Event()
    flow_token = obs_flow.token()
    bind_device = _device_binder()

    def target() -> None:
        _CURRENT.attempt = tok
        try:
            with obs_flow.adopt(flow_token):
                bind_device()
                box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=target, daemon=True,
                         name="galah-attempt")
    t.start()
    if not done.wait(deadline):
        dispatched = tok.abandon()
        if parent is not None and not dispatched:
            # an attempt whose work began stays the enclosing one's
            # current attempt: that work may still be on the card
            parent.set_inner(None, was=tok)
        raise DeadlineExceeded(
            f"attempt exceeded its {deadline:.1f} s deadline "
            f"({'after' if dispatched else 'before'} its dispatch began)",
            dispatched=dispatched)
    if parent is not None:
        parent.set_inner(None, was=tok)
    if "error" in box:
        raise box["error"]
    return box["value"]


def call_with_retry(
    fn: Callable[[], T],
    policy: RetryPolicy,
    site: str = "",
    classify: Callable[[BaseException], bool] = is_retryable,
    sleep: Optional[Callable[[float], None]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """fn() under ``run_with_deadline``, retried on the errors
    `classify` accepts until the policy's attempts or budget run out;
    then the last error raises. `on_retry(attempt, exc)` runs before
    each backoff sleep. `sleep` defaults to ``time.sleep``, looked up
    at each call."""
    t0 = time.monotonic()
    for attempt in range(policy.max_attempts):
        try:
            return run_with_deadline(fn, policy.attempt_deadline)
        except Exception as e:
            if not classify(e) or attempt == policy.max_attempts - 1:
                raise
            d = policy.delay(attempt, site)
            if (policy.total_budget is not None
                    and time.monotonic() - t0 + d > policy.total_budget):
                logger.warning(
                    # the budget is config, not a measurement
                    # galah-lint: ignore[GL702]
                    "%s: retry budget %.1f s exhausted after attempt %d",
                    site or "dispatch", policy.total_budget, attempt + 1)
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            logger.warning(
                # the delay is the policy's schedule, not a measured
                # duration
                # galah-lint: ignore[GL702]
                "%s: attempt %d/%d failed (%s: %s); retrying in %.2f s",
                site or "dispatch", attempt + 1, policy.max_attempts,
                type(e).__name__, e, d)
            (sleep or time.sleep)(d)
    raise AssertionError("unreachable: the last attempt returns or raises")
