"""Seeded fault injection at the durable-write sites: the port's copy of
``galah_tpu/resilience/faults.py``'s filesystem and kill kinds.

``io/atomic.py`` consults the injector at its named ``io.atomic.*``
sites (``io.atomic.write[ckpt.distances]``,
``io.atomic.append[ckpt.greedy]``, ...):

* ``enospc``, ``eio``: ``OSError`` before the write starts;
* ``torn-write``: half the payload reaches the disk, then the write
  fails (readers must treat the debris as absent);
* ``slow-io``: sleep ``hang`` seconds before the write;
* ``kill``: ``os._exit(KILL_EXIT_CODE)``, the process dies on the spot
  with no cleanup, as a preemption or ``kill -9`` would.

Configured programmatically (``install``) or from the environment::

    GALAH_FI="site=io.atomic.append[ckpt.greedy];kind=kill;prob=0.5;seed=3;max=1"

Specs are separated by ``|``; ``site`` prefix-matches the site name
(empty matches all); ``max`` caps the faults a spec fires; ``seed``
makes its coin flips reproducible: whether the n-th matching call
faults depends only on the spec's seed and site and on n, as in
``galah_tpu``. The dispatch kinds of ``galah_tpu`` (``raise``,
``device-lost``, ``hang``, ``garbage``) belong to its dispatch
wrapper, which the port does not have: a spec naming one is refused.
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

logger = logging.getLogger(__name__)

FS_FAULT_KINDS = ("enospc", "eio", "torn-write", "slow-io")
FAULT_KINDS = FS_FAULT_KINDS + ("kill",)

#: ``galah_tpu``'s kinds that fire at device dispatch sites
DISPATCH_KINDS = ("raise", "device-lost", "hang", "garbage")

#: the exit status of ``kill``: SIGKILL's, so a harness treats an
#: injected kill as a real one
KILL_EXIT_CODE = 137


@dataclasses.dataclass
class FaultSpec:
    """One fault source: where, how often, what, for how long."""

    site: str = ""
    kind: str = "raise"  # galah_tpu's default, refused here
    prob: float = 1.0
    seed: int = 0
    max_faults: Optional[int] = None
    hang_seconds: float = 30.0

    def __post_init__(self) -> None:
        if self.kind in DISPATCH_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} fires at device dispatch "
                f"sites, which galah_tpu_torch does not have; choices: "
                f"{FAULT_KINDS}")
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
    """Seeded fault source consulted by ``io/atomic.py``; thread-safe
    (the read-ahead threads may write too). Each spec draws from its
    own RNG, seeded as ``galah_tpu``'s is."""

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

    def _draw(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            for n, spec in enumerate(self._specs):
                if not site.startswith(spec.site):
                    continue
                if (spec.max_faults is not None
                        and self._fired[n] >= spec.max_faults):
                    continue
                if self._rngs[n].random() < spec.prob:
                    self._fired[n] += 1
                    return spec
        return None

    def filesystem(self, site: str) -> Optional[str]:
        """Called before a durable write at `site`: may raise
        ``OSError``, sleep, end the process, or return ``"torn-write"``
        for the writer to half-write and fail."""
        spec = self._draw(site)
        if spec is None:
            return None
        logger.warning("fault injector: %s at %s", spec.kind, site)
        if spec.kind == "kill":
            logger.error("fault injector: KILL at %s (exit %d)", site,
                         KILL_EXIT_CODE)
            # no atexit, no finally, no flush: die as a preemption does
            os._exit(KILL_EXIT_CODE)
        if spec.kind == "enospc":
            raise OSError(errno.ENOSPC, f"injected ENOSPC at {site}")
        if spec.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO at {site}")
        if spec.kind == "slow-io":
            self._sleep(spec.hang_seconds)
            return None
        return "torn-write"


_INSTALLED: Optional[FaultInjector] = None
_ENV_CHECKED = False
_LOCK = threading.Lock()


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
