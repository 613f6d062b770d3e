"""Defaults, percentage parsing and the registry of the ``GALAH_*``
environment variables the port reads, copied from
``galah_tpu/config.py`` so both packages read the same numbers from the
same flags.

Every environment variable the port reads is declared in ``FLAGS``,
once, with its default and one line of documentation. The run report's
``flags`` section (``obs/report.flag_snapshot``) and the ENVIRONMENT
section of every ``--full-help`` page (``manpage.py``) are built from
it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


class Defaults:
    """Compile-time defaults (reference: src/lib.rs:39-47)."""

    ALIGNED_FRACTION = 0.15          # --min-aligned-fraction 15%
    FRAGMENT_LENGTH = 3000           # --fragment-length
    ANI = 95.0                       # --ani (percent)
    PRETHRESHOLD_ANI = 90.0          # --precluster-ani (percent)
    MINHASH_KMER = 21                # finch k (reference: src/finch.rs:33)
    MINHASH_SKETCH_SIZE = 1000       # finch bottom-k sketch size
    MINHASH_SEED = 0                 # murmur3 seed of the finch contract
    HASH_ALGO = "murmur3"            # --hash-algorithm
    PRECLUSTER_METHOD = "skani"
    CLUSTER_METHOD = "skani"         # choices: skani, fastani
    QUALITY_FORMULA = "Parks2020_reduced"
    ANI_SUBSAMPLE = 1                # --ani-subsample: FracMinHash c
    # genomes per durable `index insert` batch, the preemption boundary
    # (galah_tpu's GALAH_TPU_INDEX_BATCH default)
    INDEX_BATCH = 32


PRECLUSTER_METHODS = ("skani", "finch", "dashing")
HASH_ALGORITHMS = ("murmur3", "tpufast")
CLUSTER_METHODS = ("skani", "fastani")
QUALITY_FORMULAS = (
    "Parks2020_reduced",
    "completeness-4contamination",
    "completeness-5contamination",
    "dRep",
)


def parse_percentage(value: float, name: str = "value") -> float:
    """Normalize a percentage argument to a fraction in [0, 1].

    Values in [1, 100] are percent (so exactly 1 means 1%, not 100%);
    values in [0, 1) are already fractions; anything else is an error
    (reference: src/cluster_argument_parsing.rs:1160-1182).
    """
    v = float(value)
    if 1.0 <= v <= 100.0:
        return v / 100.0
    if 0.0 <= v < 1.0:
        return v
    raise ValueError(f"{name} must be within [0, 100], got {value}")


@dataclasses.dataclass(frozen=True)
class Flag:
    """One registered environment variable."""

    name: str                       # full env var name, GALAH_*
    help: str                       # one-line doc (manpage ENVIRONMENT)
    default: Optional[str] = None   # None == unset; always the string form
    kind: str = "str"               # str | int | float | bool | grammar
    section: str = "runtime"        # runtime | resilience | observability
    choices: Tuple[str, ...] = ()


def _retry_family(prefix: str, section_help: str) -> Tuple[Flag, ...]:
    """The knobs ``RetryPolicy.from_env`` reads under `prefix`_*."""
    spec = (
        ("MAX_ATTEMPTS", "int", "attempts per read before giving up"),
        ("BASE_DELAY", "float", "first backoff delay, seconds"),
        ("MAX_DELAY", "float", "backoff cap, seconds"),
        ("JITTER", "float", "+- fraction of each delay, in [0, 1]"),
        ("TOTAL_BUDGET", "float",
         "overall retry wall-clock budget per read, seconds"),
        ("SEED", "int", "makes the backoff jitter bit-reproducible"),
    )
    return tuple(
        Flag(name=f"{prefix}_{suffix}", kind=kind, section="resilience",
             help=f"{section_help}: {doc}")
        for suffix, kind, doc in spec)


_FLAG_DEFS: Tuple[Flag, ...] = (
    Flag("GALAH_TPU_CACHE", section="runtime",
         help="Directory for the persistent sketch/profile cache; the "
              "--sketch-cache flag's env twin and loses to it. Unset "
              "disables caching"),
    Flag("GALAH_TPU_INDEX_DIR", section="runtime",
         help="Index directory of `index`; the --index-dir flag's env "
              "twin and loses to it"),
    Flag("GALAH_FI", kind="grammar", section="resilience",
         help="Deterministic fault injection at the durable-write "
              "sites, e.g. 'site=io.atomic.append[ckpt.greedy];kind=kill;"
              "prob=0.5;seed=3;max=1'. Kinds: enospc, eio, torn-write, "
              "slow-io, and kill, which os._exit()s the process with 137 "
              "mid-operation"),
    Flag("GALAH_TPU_FLEET_WORKER", section="resilience",
         help="Set by galah_tpu's fleet supervisor in every worker "
              "subprocess's environment (value: the fleet dir's "
              "absolute path); the heartbeat brands its beats with "
              "role `worker` when it is set. Never set this by hand"),
    Flag("GALAH_OBS_REPORT", section="observability",
         help="Write the end-of-run run_report.json (stage tree, "
              "dispatch counts, precluster funnel, flag snapshot, "
              "resilience events) to this path; the --run-report "
              "flag's env twin and loses to it. Render or diff with "
              "`galah_tpu_torch report`"),
    Flag("GALAH_OBS_TRACE_EVENTS", section="observability",
         help="Write Chrome-trace-format span/events (stage spans, "
              "nvcc build spans, resilience events; Perfetto-loadable) "
              "to this path; the --trace-events flag's env twin and "
              "loses to it"),
    Flag("GALAH_OBS_HEARTBEAT_S", kind="float", default="0",
         section="observability",
         help="Period in seconds for the liveness heartbeat thread "
              "(galah_tpu_torch/obs/heartbeat.py): each beat durably "
              "appends counters, gauges and occupancy to "
              "heartbeat.jsonl beside the run report. 0 (the default) "
              "disables it"),
) + _retry_family(
    "GALAH_IO_RETRY", "FASTA/IO retry policy (defaults: 3 attempts, "
    "0.1 s base delay)")

FLAGS: Dict[str, Flag] = {f.name: f for f in _FLAG_DEFS}


def env_value(name: str) -> Optional[str]:
    """The registered flag's current value: the environment when set,
    else the registry default (None for unset). Reading an unregistered
    name raises: a new flag must be declared in FLAGS first."""
    flag = FLAGS.get(name)
    if flag is None:
        raise KeyError(f"environment flag {name} is not registered in "
                       "galah_tpu_torch.config.FLAGS")
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else flag.default
