"""Seeded fault injection at the device-dispatch and durable-write
sites: the port's copy of ``galah_tpu/resilience/faults.py``.

Dispatch kinds, consulted by the dispatch supervisor
(``resilience/dispatch.py``) at its ``dispatch.*`` and
``collective.<tag>`` sites:

* ``raise``: ``TransientDispatchError`` before the dispatch runs;
* ``device-lost``: ``DeviceLostError``, likewise;
* ``hang``: sleep ``hang`` seconds before the dispatch (the attempt
  deadline, ``GALAH_RETRY_ATTEMPT_DEADLINE``, is what must catch it);
* ``garbage``: let the dispatch run, then drop its result's last
  element, so that the site's validation rejects it.

Filesystem kinds, consulted by ``io/atomic.py`` at its ``io.atomic.*``
sites (``io.atomic.write[ckpt.distances]``,
``io.atomic.append[ckpt.greedy]``, ...) and by the finch sketch stream
before each FASTA read (``io.ingest[<path>]``):

* ``enospc``, ``eio``: ``OSError`` before the write starts;
* ``torn-write``: half the payload reaches the disk, then the write
  fails (readers must treat the debris as absent);
* ``slow-io``: sleep ``hang`` seconds before the write or read.

And ``kill``, at any site of either family: ``os._exit(KILL_EXIT_CODE)``,
the process dies on the spot with no cleanup, as a preemption or
``kill -9`` would (the chaos harness, ``resilience/chaos.py``).

Configured programmatically (``install``) or from the environment::

    GALAH_FI="site=dispatch.ani;kind=raise;prob=0.3;seed=7;max=2"

Specs are separated by ``|``; ``site`` prefix-matches the site name
(empty matches all); ``max`` caps the faults a spec fires; ``seed``
makes its coin flips reproducible. A spec draws only at the sites where
its kind can fire, so whether its n-th eligible call faults depends
only on its seed and site and on n, as in ``galah_tpu``.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import random
import threading
import time
from typing import List, Optional, Sequence

from galah_tpu_torch.config import env_value
from galah_tpu_torch.resilience.policy import (DeviceLostError,
                                               TransientDispatchError)

logger = logging.getLogger(__name__)

FS_FAULT_KINDS = ("enospc", "eio", "torn-write", "slow-io")
FAULT_KINDS = (("raise", "device-lost", "hang", "garbage", "kill")
               + FS_FAULT_KINDS)

#: the exit status of ``kill``: SIGKILL's, so a harness treats an
#: injected kill as a real one
KILL_EXIT_CODE = 137

#: kinds eligible at dispatch sites (``before_dispatch``; ``garbage``
#: draws in ``corrupt``)
_DISPATCH_KINDS = frozenset({"raise", "device-lost", "hang", "kill"})
#: kinds eligible at filesystem sites (``filesystem``)
_FS_KINDS = frozenset(FS_FAULT_KINDS) | {"kill"}


@dataclasses.dataclass
class FaultSpec:
    """One fault source: where, how often, what, for how long."""

    site: str = ""
    kind: str = "raise"
    prob: float = 1.0
    seed: int = 0
    max_faults: Optional[int] = None
    hang_seconds: float = 30.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choices: {FAULT_KINDS}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], got "
                             f"{self.prob}")


_KEYS = {"site": ("site", str), "kind": ("kind", str),
         "prob": ("prob", float), "seed": ("seed", int),
         "max": ("max_faults", int), "hang": ("hang_seconds", float)}


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse the ``GALAH_FI`` grammar: ``;``-separated ``key=value``
    fields, ``|``-separated specs."""
    specs: List[FaultSpec] = []
    for chunk in text.split("|"):
        chunk = chunk.strip()
        if not chunk:
            continue
        kwargs: dict = {}
        for field in chunk.split(";"):
            field = field.strip()
            if not field:
                continue
            if "=" not in field:
                raise ValueError(
                    f"bad GALAH_FI field {field!r} (want key=value)")
            key, value = (s.strip() for s in field.split("=", 1))
            if key not in _KEYS:
                raise ValueError(f"unknown GALAH_FI key {key!r}")
            name, conv = _KEYS[key]
            kwargs[name] = conv(value)
        specs.append(FaultSpec(**kwargs))
    return specs


class FaultInjector:
    """Seeded fault source consulted by the dispatch supervisor and
    ``io/atomic.py``; thread-safe (the read-ahead threads read and may
    write too). Each spec draws from its own RNG, seeded as
    ``galah_tpu``'s is."""

    def __init__(self, specs: Sequence[FaultSpec], sleep=time.sleep) -> None:
        self._specs = list(specs)
        self._rngs = [random.Random(f"galah-fi:{s.seed}:{s.site}")
                      for s in self._specs]
        self._fired = [0] * len(self._specs)
        self._sleep = sleep
        self._lock = threading.Lock()

    def fired(self) -> int:
        """Faults injected so far, over all specs."""
        with self._lock:
            return sum(self._fired)

    def _draw(self, site: str, kinds) -> Optional[FaultSpec]:
        """One seeded coin flip per matching spec of a kind in `kinds`.
        Specs of other kinds are skipped without advancing their RNG, so
        a spec's schedule depends only on the sites where it was
        eligible."""
        with self._lock:
            for n, spec in enumerate(self._specs):
                if spec.kind not in kinds:
                    continue
                if not site.startswith(spec.site):
                    continue
                if (spec.max_faults is not None
                        and self._fired[n] >= spec.max_faults):
                    continue
                if self._rngs[n].random() < spec.prob:
                    self._fired[n] += 1
                    return spec
        return None

    @staticmethod
    def _kill(site: str) -> None:
        logger.error("fault injector: KILL at %s (exit %d)", site,
                     KILL_EXIT_CODE)
        # no atexit, no finally, no flush: die as a preemption does
        os._exit(KILL_EXIT_CODE)

    def before_dispatch(self, site: str) -> None:
        """Called before a guarded dispatch at `site`: may raise, sleep
        or end the process."""
        spec = self._draw(site, _DISPATCH_KINDS)
        if spec is None:
            return
        logger.warning("fault injector: %s at %s", spec.kind, site)
        if spec.kind == "kill":
            self._kill(site)
        if spec.kind == "raise":
            raise TransientDispatchError(
                f"injected transient fault at {site}")
        if spec.kind == "device-lost":
            raise DeviceLostError(f"injected device loss at {site}")
        if spec.kind == "hang":
            self._sleep(spec.hang_seconds)

    def filesystem(self, site: str) -> Optional[str]:
        """Called before a durable write (or an ingest read) at `site`:
        may raise ``OSError``, sleep, end the process, or return
        ``"torn-write"`` for the writer to half-write and fail."""
        spec = self._draw(site, _FS_KINDS)
        if spec is None:
            return None
        logger.warning("fault injector: %s at %s", spec.kind, site)
        if spec.kind == "kill":
            self._kill(site)
        if spec.kind == "enospc":
            raise OSError(errno.ENOSPC, f"injected ENOSPC at {site}")
        if spec.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO at {site}")
        if spec.kind == "slow-io":
            self._sleep(spec.hang_seconds)
            return None
        return "torn-write"

    def corrupt(self, site: str, result):
        """Called on a guarded dispatch's result: a ``garbage`` spec
        that fires drops its last element (None for a result that cannot
        be sliced). Only ``garbage`` specs draw here, so a spec that
        raised before the dispatch never also corrupts."""
        spec = self._draw(site, ("garbage",))
        if spec is None:
            return result
        logger.warning("fault injector: garbage at %s", site)
        try:
            return result[:-1]  # wrong length
        except TypeError:
            return None


_INSTALLED: Optional[FaultInjector] = None
_ENV_CHECKED = False
_LOCK = threading.Lock()

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): fault
# draws arrive from the read threads; the fired counts and the
# install/env-discovery globals each stay under their lock, and the
# two locks never nest.
GUARDED_BY = {
    "FaultInjector._fired": "FaultInjector._lock",
    "_INSTALLED": "_LOCK",
    "_ENV_CHECKED": "_LOCK",
}
LOCK_ORDER = ["_LOCK", "FaultInjector._lock"]


def install(injector: Optional[FaultInjector]) -> None:
    """Set (or with None, clear) the process-wide injector; an explicit
    install wins over ``GALAH_FI``."""
    global _INSTALLED, _ENV_CHECKED
    with _LOCK:
        _INSTALLED = injector
        _ENV_CHECKED = True


def reset() -> None:
    """Drop any installed injector and read ``GALAH_FI`` again at the
    next use."""
    global _INSTALLED, _ENV_CHECKED
    with _LOCK:
        _INSTALLED = None
        _ENV_CHECKED = False


def get_injector() -> Optional[FaultInjector]:
    """The installed injector, else one built from ``GALAH_FI``, else
    None."""
    global _INSTALLED, _ENV_CHECKED
    with _LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            text = env_value("GALAH_FI")
            if text:
                _INSTALLED = FaultInjector(parse_spec(text))
                logger.warning("fault injection ACTIVE from GALAH_FI=%r",
                               text)
        return _INSTALLED
