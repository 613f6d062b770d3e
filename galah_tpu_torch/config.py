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


PRECLUSTER_METHODS = ("skani", "finch", "dashing")
HASH_ALGORITHMS = ("murmur3", "tpufast")
CLUSTER_METHODS = ("skani", "fastani")
QUALITY_FORMULAS = (
    "Parks2020_reduced",
    "completeness-4contamination",
    "completeness-5contamination",
    "dRep",
)


#: ``--platform`` names and the device type each selects: ``cuda``, and
#: ``gpu`` (JAX's name for an NVIDIA card), select the card
#: (``device.resolve_platform``)
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


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
    section: str = "runtime"        # runtime | kernel | resilience |
                                    # observability
    choices: Tuple[str, ...] = ()
    # who reads a flag that no literal read site names (an f-string
    # family, C code): the lint's GL403 then does not call it stale
    external_reader: Optional[str] = None


def _retry_family(prefix: str, section_help: str) -> Tuple[Flag, ...]:
    """The seven knobs ``RetryPolicy.from_env`` reads under
    `prefix`_*."""
    spec = (
        ("MAX_ATTEMPTS", "int", "attempts before giving up"),
        ("BASE_DELAY", "float", "first backoff delay, seconds"),
        ("MAX_DELAY", "float", "backoff cap, seconds"),
        ("JITTER", "float", "+- fraction of each delay, in [0, 1]"),
        ("ATTEMPT_DEADLINE", "float",
         "seconds per attempt; an attempt past it is abandoned"),
        ("TOTAL_BUDGET", "float",
         "overall retry wall-clock budget, seconds"),
        ("SEED", "int", "makes the backoff jitter bit-reproducible"),
    )
    return tuple(
        Flag(name=f"{prefix}_{suffix}", kind=kind, section="resilience",
             help=f"{section_help}: {doc}",
             external_reader="resilience/policy.py RetryPolicy.from_env "
                             "(dynamic f-string read)")
        for suffix, kind, doc in spec)


_FLAG_DEFS: Tuple[Flag, ...] = (
    Flag("GALAH_TPU_PLATFORM", section="runtime",
         help="Force the platform (cpu, or cuda / gpu for the card); the "
              "--platform flag's env twin and loses to it. A platform "
              "that cannot start here exits 1 before any work"),
    Flag("GALAH_TPU_CACHE", section="runtime",
         help="Directory for the persistent sketch/profile cache; the "
              "--sketch-cache flag's env twin and loses to it. Unset "
              "disables caching"),
    Flag("GALAH_TPU_IR_CACHE", section="runtime",
         help="Directory for the lint IR cache (per-file GalahIR "
              "entries, content-hash keyed); the `lint --ir-cache-dir` "
              "flag's env twin and loses to it. Unset disables caching"),
    Flag("GALAH_TPU_INDEX_DIR", section="runtime",
         help="Index directory of `index`; the --index-dir flag's env "
              "twin and loses to it"),
    Flag("GALAH_TPU_INDEX_BATCH", kind="int", default="32",
         section="resilience",
         help="Genomes per durable append batch of `index insert` when "
              "--batch is not given (the preemption safe-boundary "
              "granularity: a kill loses at most one batch of "
              "uncommitted appends)"),
    Flag("GALAH_TPU_DENSE_PAIRS", kind="bool", section="kernel",
         help="Any value forces the dense pair passes at every size: "
              "the marker screen's row blocks and finch's stripes "
              "through tile_stats.cu instead of the collision screen "
              "and pairlist.cu. Bucketing and the streamed pass's "
              "decline still follow the crossover"),
    Flag("GALAH_TPU_SPARSE_MIN_N", kind="int", default="1024",
         section="kernel",
         help="Genome count at which the collision screen and the "
              "pairlist pass replace the dense all-pairs passes (and "
              "the bucketed finch pass engages under auto); read at "
              "each call, a malformed value is logged and ignored"),
    Flag("GALAH_TPU_MESH_SHAPE", section="kernel", default="auto",
         help="Layout of the mesh the all-pairs passes shard over "
              "(every card of one process, or one slot a rank of a "
              "job): 'auto' takes the squarest RxC grid of the slot "
              "count (each sketch row held along one mesh row and one "
              "mesh column instead of on every card), '1d' the single "
              "row, 'RxC' (e.g. '2x4') that grid. A count with no "
              "non-trivial factorization, or a shape that does not "
              "cover it, takes the row with a mesh-demoted event"),
    Flag("GALAH_TPU_PAIR_BATCH", kind="int", section="kernel",
         help="Candidate pairs per pairlist.cu launch of the blocked "
              "survivor route; unset takes the whole list in one "
              "launch on the card (and 65,536 pairs a call of the "
              "plain version on the CPU)"),
    Flag("GALAH_TPU_PAIRLIST_STRATEGY", section="kernel",
         choices=("blocked", "gather", "xla", "cpu"),
         help="Pin the survivor-evaluation route of the screened pair "
              "pass: blocked (pairlist.cu) or gather (the survivors' "
              "rows in 64 x 128 tiles through tile_stats.cu's gathered "
              "entry). Unset: blocked on the card (at its measured "
              "rates galah_tpu's duplication and fill test never picks "
              "gather), the plain version on the CPU. xla and cpu run the plain version on the "
              "CPU and are refused on cuda"),
    Flag("GALAH_TPU_FRAGMENT_STRATEGY", section="kernel",
         choices=("pallas", "xla", "c"),
         help="Pin the exact fragment-ANI membership route: pallas is "
              "window_hits.cu on the card (the default there); on the "
              "CPU all three run the plain version. xla and c are "
              "refused on cuda"),
    Flag("GALAH_TPU_FRAGMENT_PAIRS", kind="int", section="kernel",
         help="Cap on the directed genome pairs in one window_hits.cu "
              "launch; unset lets the element cap alone decide "
              "(results are the same at any value)"),
    Flag("GALAH_TPU_SKETCH_STRATEGY", section="kernel",
         choices=("fused", "xla", "c"),
         help="Pin the finch sketch route: fused (fused_sketch.cu, the "
              "default) or xla (every genome on the exact route, "
              "murmur3_k21.cu or positional_hashes.cu then a sort). c "
              "runs the plain version on the CPU and declines the "
              "streamed pair pass and the overlapped engine; it is "
              "refused on cuda (sketches are bit-identical on every "
              "route)"),
    Flag("GALAH_TPU_GREEDY_STRATEGY", section="kernel",
         choices=("device", "host"),
         help="Pin the greedy representative scan to the round-based "
              "device path (the default) or the per-precluster host "
              "scan, whose speculative width is cluster "
              "--rep-scan-window (decisions are bit-identical; a "
              "failure raises under either)"),
    Flag("GALAH_TPU_INGEST_DEPTH", kind="int", section="kernel",
         help="FASTA reads in flight ahead of the consumer (the sketch "
              "stream's and the profile store's read-ahead); unset uses "
              "max(2, threads). A pin bounds the parsed genomes held at "
              "once"),
    Flag("GALAH_TPU_OVERLAP", section="kernel", default="auto",
         choices=("auto", "0", "1"),
         help="Overlapped end-to-end dataflow: the finch sketch stream, "
              "the pair stripes, speculative fragment-ANI batches and "
              "eager greedy rounds run as one pipeline instead of "
              "sequential drains. auto engages it where it is "
              "bit-identical to the stage-serial engine (a fresh run, "
              "finch below the sparse crossover, unique paths, one "
              "process, the device greedy strategy) and a failure "
              "raises; 1 forces it (ineligibility raises too); 0 "
              "disables it"),
    Flag("GALAH_TPU_OVERLAP_DEPTH", kind="int", default="512",
         section="kernel",
         help="Survivor pairs buffered before a speculative "
              "fragment-ANI batch launches in the overlapped "
              "dataflow; bounds the in-flight window (memory stays "
              "O(depth))"),
    Flag("GALAH_TPU_MEGAKERNEL", section="kernel", default="auto",
         choices=("auto", "0", "1"),
         help="Fused greedy rounds: consecutive round windows fuse "
              "into one slab whose hit edges enqueue into the pair "
              "queue on the device and resolve in one slab_fold.cu "
              "launch (2 dispatches a slab instead of one window fold "
              "each, bit-identical decisions). auto engages it inside "
              "the overlapped engine's rounds and a failure raises; 1 "
              "engages it in every device round (the host greedy "
              "strategy raises); 0 disables it"),
    Flag("GALAH_TPU_QUEUE_CAP", kind="int", default="4096",
         section="kernel",
         help="Capacity (pairs) of the device pair queue of the slab "
              "fold, rounded up to a power of two. A slab whose hit "
              "edges exceed it takes the exact per-window dense path "
              "(megakernel-overflow-spills counter): results are "
              "exact at any value; the knob only moves the spill "
              "boundary"),
    Flag("GALAH_TPU_HLL_BUCKETS", section="kernel", default="auto",
         choices=("auto", "0", "1"),
         help="HLL cardinality-bucketed finch precluster "
              "(ops/bucketing.py): bucket genomes into overlapping "
              "log-cardinality bands sized so no pair that could "
              "reach the precluster threshold lands in disjoint "
              "bands, and schedule only same- and adjacent-band "
              "pairs (the same pair dict). auto engages from the "
              "sparse-screen crossover; 1 forces it at any N (and so "
              "declines the streamed pair pass); 0 disables it"),
    Flag("GALAH_TPU_PAGESTORE", section="kernel", default="auto",
         choices=("auto", "0", "1"),
         help="Out-of-core sketch memory (io/pagestore.py): sketch "
              "rows live in an mmap-backed page store under the cache "
              "dir and only the active band window is resident, "
              "bounding peak RSS while clusterings stay bit-identical "
              "to the all-resident path. auto engages when the "
              "bucketed precluster is engaged and the projected "
              "sketch matrix exceeds half the RAM budget (and loads a "
              "large index's sketches into pages); 1 forces paging "
              "whenever bucketing is engaged; 0 disables it"),
    Flag("GALAH_TPU_SKETCH_RAM_MB", kind="int", default="512",
         section="kernel",
         help="Hard byte budget, in MiB, for the resident (mmapped "
              "and LRU-pinned) page set of the out-of-core sketch "
              "store. Band-pinned pages are never evicted, so the "
              "effective floor is two bands' pages; malformed values "
              "are logged and ignored"),
    Flag("GALAH_TPU_PREFILTER", section="kernel", default="auto",
         choices=("auto", "0", "1"),
         help="Ingest prefilter of the finch sketch stream "
              "(ops/prefilter.py): screens byte-identical duplicate "
              "and degenerate (no valid k-mer window) genomes before "
              "the fused sketch under a provably conservative skip "
              "rule, and with a disk cache pre-warms the HLL register "
              "entries the bucketed pass reads (one murmur3_k21 "
              "launch a read group) — pair sets and clusterings are "
              "bit-identical with the prefilter off. auto engages in "
              "a single-process run; 1 forces it; 0 disables it"),
    Flag("GALAH_TPU_NO_CCOLLISION", kind="bool", section="kernel",
         help="Count collisions with the numpy version instead of the "
              "C collision counter (csrc/collision.c, built with $CC "
              "at first use; a failed build raises)"),
    Flag("GALAH_FI", kind="grammar", section="resilience",
         help="Deterministic fault injection, e.g. "
              "'site=dispatch.ani;kind=raise;prob=0.3;seed=7;max=2'. "
              "Dispatch kinds (at the dispatch.* and collective.<tag> "
              "sites of resilience/dispatch.py): raise, device-lost, "
              "hang (sleeps hang= seconds; GALAH_RETRY_ATTEMPT_DEADLINE "
              "catches it), garbage (a truncated result the site's "
              "validation rejects). Filesystem kinds (at the io.atomic.* "
              "durable-write sites and the io.ingest[<path>] reads): "
              "enospc, eio, torn-write, slow-io. kill fires at any site "
              "and os._exit()s the process with 137 mid-operation (the "
              "chaos harness, python -m "
              "galah_tpu_torch.resilience.chaos)"),
    Flag("GALAH_TPU_FLEET_WORKERS", kind="int", default="2",
         section="resilience",
         help="Fleet supervisor (galah_tpu_torch fleet run): maximum "
              "worker subprocesses live at once. Shards queue behind "
              "the worker cap and are reassigned on preemption"),
    Flag("GALAH_TPU_FLEET_SHARDS", kind="int", section="resilience",
         help="Fleet shard count: contiguous quality-order slices of "
              "the genome set, one worker run each. Unset defaults to "
              "the worker cap"),
    Flag("GALAH_TPU_FLEET_STALE_S", kind="float", default="30",
         section="resilience",
         help="Heartbeat staleness deadline, seconds: a worker whose "
              "newest heartbeat record is older than this is killed "
              "and its shard reassigned (same treatment as exit 75 "
              "and SIGKILL). Requires a nonzero fleet heartbeat "
              "period"),
    Flag("GALAH_TPU_FLEET_POLL_S", kind="float", default="0.2",
         section="resilience",
         help="Fleet supervisor poll period, seconds"),
    Flag("GALAH_TPU_FLEET_HEARTBEAT_S", kind="float", default="1",
         section="resilience",
         help="GALAH_OBS_HEARTBEAT_S value injected into fleet "
              "workers (their liveness signal); 0 disables worker "
              "heartbeats AND staleness detection"),
    Flag("GALAH_TPU_FLEET_WORKER", section="resilience",
         help="Set by the fleet supervisor (galah_tpu_torch fleet run) "
              "in every worker subprocess's environment (value: the "
              "fleet dir's absolute path): the orphan-adoption stamp it "
              "matches against /proc/<pid>/environ, and the marker the "
              "heartbeat uses to brand its beats with role `worker`. "
              "Never set this by hand: a process carrying the stamp is "
              "killable by any supervisor of that fleet dir"),
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
    Flag("GALAH_OBS_PROFILE", kind="bool", default="1",
         section="observability",
         help="Per-kernel device costs (galah_tpu_torch/obs/profile.py): "
              "launches, shapes, host dispatch and nvcc seconds, CUDA-"
              "event device seconds, bytes and operations from the "
              "launch shapes and their share of the card's peaks, and "
              "the allocator's high-water, in the run report's "
              "device_costs section. 0 skips the accounting; the "
              "kernels launch either way"),
    Flag("GALAH_OBS_FLOW", kind="bool", default="1",
         section="observability",
         help="Flow-level pipeline tracing (galah_tpu_torch/obs/flow.py): "
              "flow ids on pipeline items, per-stage wait/service "
              "histograms with blocked-on attribution, Chrome-trace "
              "flow arrows, and the run report's flow section behind "
              "`galah_tpu_torch flow analyze`; 0 turns every record "
              "call into a no-op"),
    Flag("GALAH_OBS_HEARTBEAT_S", kind="float", default="0",
         section="observability",
         help="Period in seconds for the liveness heartbeat thread "
              "(galah_tpu_torch/obs/heartbeat.py): each beat durably "
              "appends counters, gauges, queue depths and occupancy to "
              "heartbeat.jsonl beside the run report, rendered by "
              "`galah_tpu_torch top <dir>`. 0 (the default) disables "
              "it"),
    Flag("GALAH_OBS_OPENMETRICS", section="observability",
         help="Render the metrics registry (and, in a fleet run, the "
              "cross-shard blame rollup) to this path in Prometheus "
              "text exposition format on every heartbeat tick "
              "(galah_tpu_torch/obs/openmetrics.py; atomically "
              "swapped, so a node-exporter textfile collector never "
              "reads a torn page). Needs GALAH_OBS_HEARTBEAT_S > 0 to "
              "tick; unset disables the exporter"),
    Flag("GALAH_OBS_LEDGER", section="observability",
         help="Append one entry per finalized run to this cross-run "
              "perf ledger (JSONL, keyed by backend/topology/"
              "workload/strategy; either package's ledger file); "
              "inspect and gate with `galah_tpu_torch perf`. Unset "
              "disables the ledger feed"),
    Flag("GALAH_OBS_LEDGER_WINDOW", kind="int", default="8",
         section="observability",
         help="How many most-recent same-key ledger entries form the "
              "`perf check` noise band"),
    Flag("GALAH_OBS_LEDGER_MAD_K", kind="float", default="4",
         section="observability",
         help="Width of the `perf check` noise band, in MADs around "
              "the window median (the MAD is floored at 1 percent of "
              "the median so an all-identical history cannot gate on "
              "epsilon)"),
    Flag("GALAH_SAN", kind="bool", section="observability",
         help="1 arms GalahSan, the runtime concurrency sanitizer "
              "(galah_tpu_torch/analysis/sanitizer.py), for the run: "
              "wraps the threaded modules' declared locks, diffs the "
              "observed acquisition graph against LOCK_ORDER, and "
              "checks GUARDED_BY mutations for races. The tier-1 tests "
              "set it; the summary lands in run_report.json's "
              "sanitizer section"),
    Flag("GALAH_SAN_REPORT", section="observability",
         help="Path for the standalone sanitizer_report.json (full "
              "lock graph + findings), written when a run armed by "
              "GALAH_SAN ends; `python -m "
              "galah_tpu_torch.analysis.sanitizer` writes "
              "sanitizer_report.json in the working directory when it "
              "is unset"),
) + _retry_family(
    "GALAH_RETRY", "Device-dispatch retry policy (a guarded site retries "
    "a transient failure, then raises; nothing falls back)"
) + _retry_family(
    "GALAH_IO_RETRY", "FASTA/IO retry policy (defaults: 3 attempts, "
    "0.1 s base delay)"
) + _retry_family(
    "GALAH_TPU_FLEET_RETRY", "Per-shard fleet reassignment budget "
    "(max_attempts bounds worker-fault preemptions per shard before "
    "quarantine; delays pace the relaunch backoff)")

FLAGS: Dict[str, Flag] = {f.name: f for f in _FLAG_DEFS}

#: The prefixes of the ``RetryPolicy.from_env`` families above.
FLAG_FAMILIES: Tuple[str, ...] = ("GALAH_RETRY", "GALAH_IO_RETRY",
                                  "GALAH_TPU_FLEET_RETRY")


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
