"""Retry with exponential backoff for host IO: the port's copy of
``galah_tpu/resilience/policy.py``'s ``RetryPolicy`` and
``call_with_retry``.

The port retries only host reads of genome files (``io/fasta.py``): a
flaky network filesystem costs a backoff sleep instead of the run.
Device work is never retried or sent elsewhere here; a failed launch
raises. ``galah_tpu``'s per-attempt deadline thread serves its device
dispatches and is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import time
from typing import Callable, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """delay(attempt) = min(max_delay, base_delay * 2^attempt), scaled
    by a jitter factor in [1 - jitter, 1 + jitter] (deterministic per
    site and attempt when `seed` is set); `total_budget` bounds the
    whole loop, sleeps included."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    total_budget: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    @classmethod
    def from_env(cls, prefix: str,
                 defaults: Optional[dict] = None) -> "RetryPolicy":
        """The policy with `defaults`, overridden by
        ``<prefix>_MAX_ATTEMPTS``, ``_BASE_DELAY``, ``_MAX_DELAY``,
        ``_JITTER``, ``_TOTAL_BUDGET`` and ``_SEED`` from the
        environment."""
        spec = {"max_attempts": int, "base_delay": float,
                "max_delay": float, "jitter": float,
                "total_budget": float, "seed": int}
        kwargs = dict(defaults or {})
        for name, conv in spec.items():
            raw = os.environ.get(f"{prefix}_{name.upper()}")
            if raw:
                kwargs[name] = conv(raw)
        return cls(**kwargs)

    def delay(self, attempt: int, site: str = "") -> float:
        """The sleep after failed attempt `attempt` (0-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        if self.jitter:
            u = (random.Random(f"{self.seed}:{site}:{attempt}").random()
                 if self.seed is not None else random.random())
            d *= 1.0 - self.jitter + 2.0 * self.jitter * u
        return d


def call_with_retry(
    fn: Callable[[], T],
    policy: RetryPolicy,
    site: str,
    classify: Callable[[BaseException], bool],
    sleep: Optional[Callable[[float], None]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """fn(), retried on the errors `classify` accepts until the
    policy's attempts or budget run out; then the last error raises.
    `on_retry(attempt, exc)` runs before each backoff sleep. `sleep`
    defaults to ``time.sleep``, looked up at each call."""
    t0 = time.monotonic()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except Exception as e:
            if not classify(e) or attempt == policy.max_attempts - 1:
                raise
            d = policy.delay(attempt, site)
            if (policy.total_budget is not None
                    and time.monotonic() - t0 + d > policy.total_budget):
                logger.warning("%s: retry budget %.1f s exhausted after "
                               "attempt %d", site, policy.total_budget,
                               attempt + 1)
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            logger.warning("%s: attempt %d/%d failed (%s: %s); retrying "
                           "in %.2f s", site, attempt + 1,
                           policy.max_attempts, type(e).__name__, e, d)
            (sleep or time.sleep)(d)
    raise AssertionError("unreachable: the last attempt returns or raises")
