"""``python -m galah_tpu_torch``: the port's command line.

The subcommands of ``galah-tpu`` that the port has, with its defaults,
help strings and output formats:

* ``cluster``: genome inputs (-f, --genome-fasta-list, -d, -x), and
  the library API's flags (``api.add_cluster_arguments``) and clusterer
  (``api.generate_galah_clusterer``): the thresholds, the skani, finch
  or dashing precluster with the skani or fastani clusterer, the hash
  algorithm, ``--ani-subsample``, quality ordering (a CheckM1 table, a
  CheckM2 report or a genomeInfo CSV, the formula and the completeness
  and contamination filters); then the cluster definition TSV,
  the representative directories (symlinks or copies) and list, the
  persistent sketch/profile cache (``--sketch-cache``), the host
  threads that read genomes ahead (``--threads``), the greedy round
  width (``--rep-rounds``), checkpoint and resume (``--checkpoint-dir``,
  ``--resume``) and the quarantine of unreadable genomes
  (``--on-bad-genome skip``);
* ``cluster-validate``: re-check a cluster definition with exact ANI;
* ``dist``: all-pairs MinHash ANI as a TSV, at any k-mer length of 1
  to 32;
* ``index``: the persistent sketch index (``--index-dir`` or
  ``GALAH_TPU_INDEX_DIR``) and its actions ``build``, ``insert``,
  ``query``, ``remove`` and ``fsck``, over directories interchangeable
  with ``galah-tpu index``'s;
* ``report``: render run reports, or ``--diff`` two, of either package;
* ``perf``: ``record``, ``history`` and ``check`` over the cross-run
  perf ledger (``GALAH_OBS_LEDGER`` or ``--ledger``), a file either
  package reads and appends to;
* ``flow analyze``: the critical path of a run report's flow telemetry;
* ``top``: the newest heartbeat of a run directory, or a fleet
  directory's per-shard grid;
* ``fleet``: ``run`` shards the quality-ordered genomes, supervises one
  preemptible ``cluster`` worker subprocess a shard (exit 75, death by
  signal and a stale heartbeat mean preemption; the shard is reassigned
  and resumes from its checkpoint) and merges the shard checkpoints
  into clusters byte-identical to one process's; ``status`` and
  ``analyze`` read a fleet directory without a device;
* ``lint``: the port's static analysis (``analysis/``), with
  ``galah-tpu lint``'s options and exit rule; it reads files only.

``cluster`` and ``index`` write a run report (``--run-report`` or
``GALAH_OBS_REPORT``), a Chrome trace (``--trace-events`` or
``GALAH_OBS_TRACE_EVENTS``), a ledger entry (``GALAH_OBS_LEDGER``) and,
with ``GALAH_OBS_HEARTBEAT_S`` set, a ``heartbeat.jsonl`` beside the
report (``obs/``); a preempted or failed run still writes its report
and closes its trace. ``cluster --profile-trace-dir DIR`` writes a
``torch.profiler`` trace of the clustering (host ops and, on the card,
every kernel) as ``DIR/*.pt.trace.json``, for TensorBoard or Perfetto.
``report``, ``perf``, ``flow`` and ``top`` read files only and import
no torch.

Each but ``lint`` takes ``-v``/``-q``, ``--platform``, ``--full-help``
and ``--full-help-roff``, as in ``galah-tpu``, and each but ``report``,
``perf``, ``flow``, ``top`` and ``lint`` the device (``--device``, cuda
unless the CPU is asked for; ``fleet`` takes it on ``run``, and passes
the device it resolved to every worker). ``--platform`` (or
``GALAH_TPU_PLATFORM``, which loses to it) names the device as
``galah-tpu``'s JAX platform does: ``cpu``, or ``cuda`` / ``gpu`` for
the card; it must agree with an explicit ``--device`` (else exit 2),
and a platform that cannot start here exits 1 before any work, after
``report``, ``perf``, ``flow``, ``top`` and ``fleet status|analyze``
have returned, as in ``galah-tpu``.
Percentages parse as in ``galah-tpu``. Every flag of ``galah-tpu``'s
command line is taken (``cluster --rep-scan-window`` sets the host
greedy strategy's speculative width); no flag is silently ignored. A
user error (a bad value, a missing file)
exits 1 with a one-line message. A ``cluster`` run stopped by SIGTERM
or SIGINT at a safe boundary exits 75 (``EXIT_PREEMPTED``) and writes
no outputs, and an ``index insert`` stopped so exits 75 with the index
loadable at its last generation; the handlers are installed only for
the length of ``run_cluster`` and ``run_index``, so a library caller
keeps its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from galah_tpu_torch import __version__, obs
from galah_tpu_torch.api import (add_cluster_arguments,
                                 generate_galah_clusterer)
from galah_tpu_torch.config import (HASH_ALGORITHMS, PLATFORMS,
                                    QUALITY_FORMULAS, Defaults, env_value,
                                    parse_percentage)
from galah_tpu_torch.index import INDEX_DIR_ENV
from galah_tpu_torch.io.fasta import CORRUPT_GZIP_ERRORS
from galah_tpu_torch.obs import events
from galah_tpu_torch.resilience import interrupt

logger = logging.getLogger("galah_tpu_torch")


def set_log_level(verbose: bool = False, quiet: bool = False) -> None:
    """-v logs DEBUG, -q only errors, else INFO; replaces the root
    handlers (``galah_tpu/utils/logging.py``; reference:
    bird_tool_utils::clap_utils::set_log_level)."""
    level = logging.INFO
    if verbose:
        level = logging.DEBUG
    if quiet:
        level = logging.ERROR
    logging.basicConfig(
        level=level,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        force=True,
    )


def _add_verbosity(p: argparse.ArgumentParser) -> None:
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print extra debugging information")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Unless there is an error, do not print log messages")
    p.add_argument("--platform", default=None,
                   help="Force the platform: cpu, or cuda (gpu, JAX's "
                        "name for it) for the card. Must agree with an "
                        "explicit --device; a platform that cannot start "
                        "here exits 1 before any work. Env equivalent: "
                        "GALAH_TPU_PLATFORM. Default: --device's choice")
    p.add_argument("--full-help", action="store_true",
                   help="Display an extended man-style help page and exit")
    p.add_argument("--full-help-roff", action="store_true",
                   help="Print the extended help as raw roff man source "
                        "and exit (pipe through `man -l -`)")


def _add_common(p: argparse.ArgumentParser) -> None:
    _add_verbosity(p)
    # None stands for cuda: an explicit --device is told from the
    # default, so that it can be held against --platform
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Device to run on (default: cuda; asking for "
                        "cuda without a GPU is an error)")


def _add_genome_inputs(p: argparse.ArgumentParser) -> None:
    p.add_argument("-f", "--genome-fasta-files", nargs="+",
                   help="Path(s) to FASTA files of each genome")
    p.add_argument("--genome-fasta-list",
                   help="File containing FASTA file paths, one per line")
    p.add_argument("-d", "--genome-fasta-directory",
                   help="Directory containing FASTA files of each genome")
    p.add_argument("-x", "--genome-fasta-extension", default="fna",
                   help="File extension of genomes in the directory "
                        "(default: fna)")


def _add_index_quality(p: argparse.ArgumentParser) -> None:
    """The quality inputs of `index build` and `index insert`: insert
    order is the greedy quality order the persisted decisions rest on."""
    p.add_argument("--checkm-tab-table",
                   help="Output of `checkm qa .. --tab_table`")
    p.add_argument("--checkm2-quality-report",
                   help="CheckM2 quality_report.tsv output")
    p.add_argument("--genome-info",
                   help="dRep-style genome info CSV "
                        "(genome,completeness,contamination)")
    p.add_argument("--quality-formula",
                   default=Defaults.QUALITY_FORMULA,
                   choices=QUALITY_FORMULAS,
                   help="Quality formula for ranking genomes "
                        "(default: Parks2020_reduced)")
    p.add_argument("--min-completeness", type=float,
                   help="Ignore genomes with less completeness than "
                        "this percentage")
    p.add_argument("--max-contamination", type=float,
                   help="Ignore genomes with more contamination than "
                        "this percentage")


def _add_index_parser(sub) -> argparse.ArgumentParser:
    """`index` and its actions, with galah-tpu's flags and defaults."""
    ix = sub.add_parser(
        "index",
        help="Build and incrementally maintain a persistent versioned "
             "sketch index (insert/query/remove without re-clustering)",
        description="Persistent versioned sketch index over a "
                    "dereplicated corpus: `build` clusters once and "
                    "persists the sketches, thresholded pairs, and "
                    "greedy decisions; `insert` adds new genomes "
                    "sketching only them and commits a new generation; "
                    "`query` answers which cluster a genome would join "
                    "without mutating anything; `remove` tombstones a "
                    "genome and locally re-elects; `fsck` audits the "
                    "on-disk state (docs/index.md)")
    _add_common(ix)
    ix.add_argument("--index-dir",
                    help="Index directory (also via "
                         f"{INDEX_DIR_ENV}); created by `build`, "
                         "required by every action")
    ix.add_argument("--trace-events",
                    help="Write a Chrome-trace-format event timeline "
                         "to this file. Env equivalent: "
                         "GALAH_OBS_TRACE_EVENTS")
    ix.add_argument("--run-report",
                    help="Write run_report.json (with its `index` "
                         "section) to this file at run end. Env "
                         "equivalent: GALAH_OBS_REPORT")
    ixsub = ix.add_subparsers(dest="index_action")
    ixb = ixsub.add_parser(
        "build",
        help="Dereplicate a corpus once and persist it as generation 1")
    _add_genome_inputs(ixb)
    _add_index_quality(ixb)
    ixb.add_argument("--ani", type=float, default=Defaults.ANI,
                     help="ANI clustering threshold the index is bound "
                          "to (default: 95)")
    ixb.add_argument("--precluster-ani", type=float,
                     default=Defaults.PRETHRESHOLD_ANI,
                     help="Sketch-ANI floor for persisted pairs "
                          "(default: 90)")
    ixb.add_argument("--hash-algorithm", default=Defaults.HASH_ALGO,
                     choices=HASH_ALGORITHMS,
                     help="Sketch hash the index is bound to "
                          "(default: murmur3)")
    ixb.add_argument("--sketch-cache",
                     help="Directory for the persistent sketch cache "
                          "(also via GALAH_TPU_CACHE); index records "
                          "share its content-hash keys")
    ixb.add_argument("--threads", "-t", type=int, default=1)
    ixi = ixsub.add_parser(
        "insert",
        help="Insert new genomes, sketching only them, and commit the "
             "next generation")
    _add_genome_inputs(ixi)
    _add_index_quality(ixi)
    ixi.add_argument("--sketch-cache",
                     help="Directory for the persistent sketch cache "
                          "(also via GALAH_TPU_CACHE)")
    ixi.add_argument("--threads", "-t", type=int, default=1)
    ixi.add_argument("--batch", type=int, default=None,
                     help="Genomes per durable append batch — the "
                          "preemption safe-boundary granularity "
                          "(default: GALAH_TPU_INDEX_BATCH)")
    ixi.add_argument("--resume", action="store_true",
                     help="Continue an interrupted insert: uncommitted "
                          "appends past the last committed generation "
                          "are truncated and the insert redone, "
                          "converging to the same bytes as an "
                          "uninterrupted run. (A matching index "
                          "auto-resumes anyway; --resume records the "
                          "chain)")
    ixq = ixsub.add_parser(
        "query",
        help="Answer which cluster each genome would join, without "
             "mutating the index")
    _add_genome_inputs(ixq)
    ixq.add_argument("--sketch-cache",
                     help="Directory for the persistent sketch cache "
                          "(also via GALAH_TPU_CACHE)")
    ixq.add_argument("--threads", "-t", type=int, default=1)
    ixq.add_argument("--output",
                     help="Output TSV of query, decision, "
                          "representative, ANI (default: stdout)")
    ixr = ixsub.add_parser(
        "remove",
        help="Tombstone genomes and locally re-elect their clusters")
    _add_genome_inputs(ixr)
    ixsub.add_parser(
        "fsck",
        help="Audit the on-disk index: commit-pointer integrity, log "
             "checksums, cluster invariants (never mutates; uses no "
             "device)")
    return ix


def _add_fleet_parser(sub) -> argparse.ArgumentParser:
    """`fleet` and its actions, with galah-tpu's flags, defaults and help,
    and the port's --device on `run`."""
    ft = sub.add_parser(
        "fleet",
        help="Run one dereplication job across preemptible worker "
             "subprocesses (shard, supervise, reassign, merge)",
        description="Elastic preemptible-fleet execution: `run` shards "
                    "the quality-ordered genome set, supervises one "
                    "`galah_tpu_torch cluster` worker per shard (exit "
                    "75, SIGKILL and stale heartbeats all mean "
                    "preemption -> reassign; retry budget per shard), "
                    "then merges shard checkpoints into clusters "
                    "byte-identical to a single-process run; `status` "
                    "renders a fleet directory's plan/event/heartbeat "
                    "state (no device)")
    _add_verbosity(ft)
    ftsub = ft.add_subparsers(dest="fleet_action")
    ftr = ftsub.add_parser(
        "run",
        help="Shard, supervise and merge one dereplication job")
    _add_genome_inputs(ftr)
    add_cluster_arguments(ftr)
    ftr.add_argument("--device", default=None, choices=("cuda", "cpu"),
                     help="Device of the workers and the merge (default: "
                          "cuda; asking for cuda without a GPU is an "
                          "error)")
    ftr.add_argument("--fleet-dir", required=True,
                     help="Fleet working directory: shard plan, event "
                          "log, per-shard checkpoints/reports live "
                          "here (the resume root)")
    ftr.add_argument("--workers", type=int,
                     help="Max live worker subprocesses (default: "
                          "GALAH_TPU_FLEET_WORKERS)")
    ftr.add_argument("--shards", type=int,
                     help="Shard count (default: GALAH_TPU_FLEET_SHARDS "
                          "or the worker cap)")
    ftr.add_argument("--stale-s", type=float,
                     help="Heartbeat staleness deadline in seconds "
                          "(default: GALAH_TPU_FLEET_STALE_S)")
    ftr.add_argument("--resume", action="store_true",
                     help="Require resuming the fleet at --fleet-dir: "
                          "fail if the plan is missing or belongs to "
                          "a different configuration. Without this "
                          "flag a matching plan still auto-resumes")
    ftr.add_argument("--sketch-cache",
                     help="Shared sketch/profile cache for workers and "
                          "the merge (default: <fleet-dir>/cache; also "
                          "via GALAH_TPU_CACHE)")
    ftr.add_argument("--run-report",
                     help="Write the supervisor's run_report.json "
                          "(with its `fleet` section) to this file. "
                          "Env equivalent: GALAH_OBS_REPORT")
    ftr.add_argument("--output-cluster-definition",
                     help="Output file of rep<TAB>member lines")
    ftr.add_argument("--output-representative-fasta-directory",
                     help="Symlink representative genomes into this "
                          "directory")
    ftr.add_argument("--output-representative-fasta-directory-copy",
                     help="Copy representative genomes into this "
                          "directory")
    ftr.add_argument("--output-representative-list",
                     help="Output file with one representative path "
                          "per line")
    fts = ftsub.add_parser(
        "status",
        help="Render a fleet directory's shard/event/heartbeat state "
             "(no device; usable while a fleet is live)")
    fts.add_argument("fleet_dir", help="Fleet working directory")
    fta = ftsub.add_parser(
        "analyze",
        help="Cross-shard critical path of a fleet dir: blame table "
             "(scheduler/compute/straggler/merge) summing to the "
             "fleet wall, and the named bottleneck (no device)",
        description="Aggregate fleet_events.jsonl + per-shard run "
                    "reports/heartbeats into the fleet_rollup blame "
                    "table, write fleet_report.json beside the plan, "
                    "and name the bottleneck. Tolerates torn tails, "
                    "shards missing mid-write, and shard reports of "
                    "either package. Exit codes: 0 rollup printed, 1 "
                    "rollup-impossible dir (no event log), 2 usage "
                    "error")
    fta.add_argument("fleet_dir", help="Fleet working directory")
    fta.add_argument("--json", action="store_true",
                     help="Emit the rollup as JSON instead of the "
                          "blame table")
    fta.add_argument("--no-report", action="store_true",
                     help="Skip writing fleet_report.json (print "
                          "only)")
    return ft


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="galah_tpu_torch",
        description="Genome dereplication by ANI on an NVIDIA GPU "
                    "(the PyTorch/CUDA port of galah-tpu)")
    parser.add_argument("--version", action="version",
                        version=__version__)
    sub = parser.add_subparsers(dest="subcommand")
    c = sub.add_parser(
        "cluster",
        help="Cluster genomes by ANI, choosing representatives",
        description="Cluster genomes by average nucleotide identity, "
                    "choosing one representative per cluster")
    _add_common(c)
    _add_genome_inputs(c)
    # the shared clustering and quality flags come from the library
    # API, so the command and an embedding tool stay in step
    add_cluster_arguments(c)
    c.add_argument("--sketch-cache",
                   help="Directory for the persistent sketch/profile "
                        "cache (also via GALAH_TPU_CACHE); sketches are "
                        "reused across runs when genome files are "
                        "unchanged")
    c.add_argument("--profile-trace-dir",
                   help="Capture a torch.profiler trace of the "
                        "clustering (host ops and, on the card, every "
                        "kernel and copy) into this directory as "
                        "*.pt.trace.json (TensorBoard- and "
                        "Perfetto-loadable)")
    c.add_argument("--trace-events",
                   help="Write a Chrome-trace-format event timeline "
                        "(stage spans, nvcc build spans, resilience "
                        "events; Perfetto-loadable) to this file. Env "
                        "equivalent: GALAH_OBS_TRACE_EVENTS")
    c.add_argument("--run-report",
                   help="Write the machine-readable run_report.json "
                        "(stage tree, dispatch counts, precluster "
                        "funnel, flag snapshot, resilience events) to "
                        "this file at run end; render or diff it with "
                        "`galah_tpu_torch report`. Env equivalent: "
                        "GALAH_OBS_REPORT")
    c.add_argument("--checkpoint-dir",
                   help="Persist the distance pass and finished "
                        "preclusters here; an interrupted run resumes "
                        "from the last completed precluster")
    c.add_argument("--resume", action="store_true",
                   help="Require resuming from --checkpoint-dir: fail "
                        "if the checkpoint is missing or belongs to a "
                        "different configuration instead of silently "
                        "starting fresh. Without this flag a matching "
                        "checkpoint still auto-resumes; --resume makes "
                        "\"no checkpoint\" an error")
    c.add_argument("--output-cluster-definition",
                   help="Output file of rep<TAB>member lines")
    c.add_argument("--output-representative-fasta-directory",
                   help="Symlink representative genomes into this directory")
    c.add_argument("--output-representative-fasta-directory-copy",
                   help="Copy representative genomes into this directory")
    c.add_argument("--output-representative-list",
                   help="Output file with one representative path per line")

    v = sub.add_parser(
        "cluster-validate", help="Verify clustering results",
        description="Re-check a cluster output file: every member must "
                    "reach the ANI threshold to its representative, and "
                    "no two representatives may reach it to each other")
    _add_common(v)
    v.add_argument("--cluster-file",
                   help="Output of 'cluster' subcommand (required)")
    v.add_argument("--ani", type=float, default=99.0,
                   help="ANI to validate against (default: 99)")
    v.add_argument("--min-aligned-fraction", type=float, default=50.0,
                   help="Min aligned fraction of two genomes "
                        "(default: 50)")
    v.add_argument("--fragment-length", type=int,
                   default=Defaults.FRAGMENT_LENGTH,
                   help="Length of fragment used in fastANI-style "
                        "calculation (default: 3000)")
    v.add_argument("--ani-subsample", type=int, default=1,
                   help="FracMinHash compression of the exact ANI "
                        "re-check (see `cluster --full-help`; "
                        "default: 1)")
    v.add_argument("--hash-algorithm", default=Defaults.HASH_ALGO,
                   choices=sorted(HASH_ALGORITHMS),
                   help="k-mer hash for the validation profiles — use "
                        "the same value the clustering ran with so "
                        "near-threshold pairs score identically "
                        "(default: murmur3)")
    v.add_argument("--threads", "-t", type=int, default=1)

    dd = sub.add_parser(
        "dist",
        help="Calculate pairwise MinHash ANI between a set of genomes",
        description="All-pairs sketch-based ANI as a TSV — the "
                    "reference carries this subcommand disabled "
                    "(reference: src/main.rs:88-114); here the pair "
                    "matrix is one tiled device computation")
    _add_common(dd)
    _add_genome_inputs(dd)
    dd.add_argument("--num-hashes", type=int,
                    default=Defaults.MINHASH_SKETCH_SIZE,
                    help="MinHash sketch size (default: 1000)")
    dd.add_argument("--kmer-length", type=int,
                    default=Defaults.MINHASH_KMER,
                    help="k-mer length (default: 21)")
    dd.add_argument("--hash-algorithm", default=Defaults.HASH_ALGO,
                    choices=HASH_ALGORITHMS,
                    help="Sketch hash (default: murmur3)")
    dd.add_argument("--min-ani", type=float, default=0.0,
                    help="Only report pairs at or above this ANI "
                         "(percent or fraction; default: report every "
                         "pair with any sketch overlap)")
    dd.add_argument("--output", help="Output TSV (default: stdout)")
    dd.add_argument("--sketch-cache",
                    help="Directory for the persistent sketch cache "
                         "(also via GALAH_TPU_CACHE)")
    dd.add_argument("--threads", "-t", type=int, default=1)
    ix = _add_index_parser(sub)
    rp = sub.add_parser(
        "report",
        help="Render or diff run_report.json files from past runs",
        description="Human-readable rendering of the machine-readable "
                    "run report a `cluster --run-report` run wrote "
                    "(stage wall-clock tree, dispatch/sync counts, "
                    "precluster funnel, flag snapshot, resilience "
                    "events); with --diff, per-stage and per-metric "
                    "deltas between two reports")
    _add_verbosity(rp)
    rp.add_argument("paths", nargs="+", metavar="REPORT",
                    help="run_report.json file(s) to render")
    rp.add_argument("--diff", action="store_true",
                    help="Compare exactly two reports: per-stage "
                         "wall-clock, dispatch/funnel, and per-metric "
                         "deltas")
    pf, fl, tp = _add_tool_parsers(sub)
    ft = _add_fleet_parser(sub)
    li = sub.add_parser(
        "lint",
        help="Static analysis of the port: CUDA kernel contracts, flag "
             "registry, hardware-test markers, ad-hoc timing, durable "
             "writes, suppression expiry",
        description="Run the galah_tpu_torch static-analysis suite "
                    "(equivalent to `python -m galah_tpu_torch.analysis`);"
                    " exits 1 on any unsuppressed finding at WARNING or "
                    "above")
    from galah_tpu_torch.analysis import add_lint_arguments

    add_lint_arguments(li)
    parser.subcommand_parsers = {"cluster": c, "cluster-validate": v,
                                 "dist": dd, "index": ix, "report": rp,
                                 "perf": pf, "flow": fl, "top": tp,
                                 "fleet": ft, "lint": li}
    return parser


def _add_tool_parsers(sub) -> Tuple[argparse.ArgumentParser, ...]:
    """`perf`, `flow` and `top`: ``galah-tpu``'s file-reading tools, with
    its flags, exit codes and help."""
    pf = sub.add_parser(
        "perf",
        help="Record, inspect, and gate on the cross-run performance "
             "ledger",
        description="The append-only perf ledger (JSONL, fed "
                    "automatically by runs with GALAH_OBS_LEDGER set) "
                    "keys every entry by backend, device topology, "
                    "workload fingerprint (N/K/P), and strategy. "
                    "`record` appends a run report's metrics, "
                    "`history` prints one metric's trajectory, and "
                    "`check` compares the newest entry against a "
                    "median±MAD noise band over the last entries of "
                    "the same key, exiting 1 on regression")
    _add_verbosity(pf)
    pf.add_argument("--ledger", default=None,
                    help="Ledger file (default: GALAH_OBS_LEDGER)")
    pfsub = pf.add_subparsers(dest="perf_action")
    pfr = pfsub.add_parser(
        "record", help="Append a run report's metrics to the ledger")
    pfr.add_argument("report", metavar="REPORT",
                     help="run_report.json to ingest")
    pfr.add_argument("--source", default="manual",
                     help="Key component naming what produced the "
                          "report (default: manual)")
    pfh = pfsub.add_parser(
        "history", help="Print one metric's cross-run trajectory")
    pfh.add_argument("metric", metavar="METRIC",
                     help="Metric name (e.g. run.duration_s, "
                          "stage.profile_s)")
    pfh.add_argument("--key", default=None,
                     help="Only entries whose canonical key contains "
                          "this substring")
    pfc = pfsub.add_parser(
        "check",
        help="Gate: newest entry vs the same-key noise band "
             "(exit 1 on regression)")
    pfc.add_argument("--report", default=None,
                     help="Check this run_report.json against the "
                          "ledger instead of the ledger's own newest "
                          "entry (nothing is appended)")
    pfc.add_argument("--source", default="manual",
                     help="Key source component for --report entries")
    pfc.add_argument("--window", type=int, default=None,
                     help="Same-key history window (default: "
                          "GALAH_OBS_LEDGER_WINDOW)")
    pfc.add_argument("--mad-k", type=float, default=None,
                     help="Noise-band width in MADs (default: "
                          "GALAH_OBS_LEDGER_MAD_K)")
    pfc.add_argument("--min-history", type=int, default=None,
                     help="Entries required before a verdict "
                          "(default: 3)")
    pfc.add_argument("--soft", action="store_true",
                     help="Report regressions but exit 0: the CI mode "
                          "while a key is still accumulating "
                          "trustworthy history")
    fl = sub.add_parser(
        "flow",
        help="Critical-path analysis of a run's flow telemetry",
        description="Item-level flow tracing (GALAH_OBS_FLOW, on by "
                    "default) records per-stage service/wait time and "
                    "inter-stage queue latencies into the run report's "
                    "`flow` section; `analyze` recomputes the critical "
                    "path from a report and prints per-stage blame "
                    "shares that sum to the end-to-end wall. Exit "
                    "codes: 0 analysis printed, 1 unreadable report or "
                    "no flow telemetry, 2 usage error")
    _add_verbosity(fl)
    flsub = fl.add_subparsers(dest="flow_action")
    fla = flsub.add_parser(
        "analyze",
        help="Print the critical path of one run report's flow "
             "telemetry")
    fla.add_argument("report", metavar="REPORT",
                     help="run_report.json carrying a `flow` section")
    fla.add_argument("--json", action="store_true",
                     help="Emit the critical-path attribution as JSON "
                          "instead of the rendered table")
    tp = sub.add_parser(
        "top",
        help="Live pipeline view from a run's heartbeat.jsonl (or a "
             "whole fleet dir)",
        description="Render the newest record of the heartbeat file a "
                    "run with GALAH_OBS_HEARTBEAT_S set writes beside "
                    "its run report: per-stage occupancy bars, queue "
                    "depths, and item throughput. Pointed at a fleet "
                    "dir (auto-detected from fleet_plan.json / "
                    "fleet_events.jsonl) it renders the per-shard "
                    "grid: state, attempt chain, beat age, occupancy, "
                    "rss, plus the scheduler event tail. A torn tail "
                    "line from a run killed mid-write is skipped, never "
                    "an error. Exit codes: 0 rendered, 1 no "
                    "heartbeat/fleet data, 2 usage error")
    _add_verbosity(tp)
    tp.add_argument("directory", metavar="DIR",
                    help="Run artifact directory, a heartbeat.jsonl "
                         "path directly, or a fleet dir")
    tp.add_argument("--follow", action="store_true",
                    help="Keep refreshing until interrupted")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="Refresh period in seconds with --follow "
                         "(default: 2.0)")
    tp.add_argument("--json", action="store_true",
                    help="Emit the latest beat (or, for a fleet dir, "
                         "the fleet grid) as JSON instead of the "
                         "rendered page")
    return pf, fl, tp


def parse_args(argv: Optional[Sequence[str]],
               parser: Optional[argparse.ArgumentParser] = None
               ) -> argparse.Namespace:
    parser = parser or build_parser()
    args = parser.parse_args(argv)
    platform = _platform(args)
    device = getattr(args, "device", None)
    if platform and device is not None and \
            PLATFORMS.get(platform, device) != device:
        given = (f"--platform {platform}" if args.platform
                 else f"GALAH_TPU_PLATFORM={platform}")
        parser.error(f"--device {device} disagrees with {given}")
    return args


def _platform(args: argparse.Namespace) -> Optional[str]:
    """``--platform``, else ``GALAH_TPU_PLATFORM``, else None."""
    return getattr(args, "platform", None) or env_value("GALAH_TPU_PLATFORM")


def device_type(args: argparse.Namespace) -> str:
    """``cpu`` or ``cuda``, touching no device: the platform's when one
    is given (one the port does not run on is ``main``'s exit 1), else
    ``--device``'s, else the card's. ``fleet run`` gives it to its
    workers as ``--device``."""
    platform = _platform(args)
    return (PLATFORMS.get(platform) if platform else None) or \
        getattr(args, "device", None) or "cuda"


def device_of(args: argparse.Namespace):
    """The torch device of a parsed command line: the platform's when
    one is given (``device.resolve_platform``, which raises for one
    that cannot start here), else ``--device``'s, else the card's."""
    from galah_tpu_torch.device import resolve_device, resolve_platform

    platform = _platform(args)
    return (resolve_platform(platform) if platform
            else resolve_device(getattr(args, "device", None)))


def _genome_inputs(args: argparse.Namespace, manifest=None) -> List[str]:
    from galah_tpu_torch.genome_inputs import parse_genome_inputs

    return parse_genome_inputs(
        genome_fasta_files=args.genome_fasta_files,
        genome_fasta_list=args.genome_fasta_list,
        genome_fasta_directory=args.genome_fasta_directory,
        genome_fasta_extension=args.genome_fasta_extension,
        on_bad_genome=getattr(args, "on_bad_genome", "error"),
        manifest=manifest)


@dataclasses.dataclass
class RunResult:
    genomes: List[str]
    clusters: List[List[int]]
    clock: object  # timing.StageClock
    store: object  # backends.ProfileStore holding the run's profiles
    # its store holds a finch run's sketches or a dashing run's registers
    preclusterer: object


def _start_telemetry(args: argparse.Namespace) -> Optional[str]:
    """Open the trace (``--trace-events``, else
    ``GALAH_OBS_TRACE_EVENTS``), arm the crash hooks and start the
    heartbeat beside the report; returns the report's path
    (``--run-report``, else ``GALAH_OBS_REPORT``), or None."""
    trace_path = args.trace_events or env_value("GALAH_OBS_TRACE_EVENTS")
    if trace_path:
        obs.trace.start(trace_path)
    report_path = args.run_report or env_value("GALAH_OBS_REPORT")
    obs.install_crash_hooks()
    obs.heartbeat.maybe_start(report_path)
    return report_path


def run_cluster(args: argparse.Namespace) -> RunResult:
    """Build the backends from parsed `cluster` arguments, cluster, and
    write the requested outputs. SIGTERM and SIGINT request a stop for
    the length of the run: at the next safe boundary the interruption
    is recorded in the checkpoint and ``PreemptionRequested`` raises,
    with no output written (``main`` exits 75). The run report and the
    trace are written however the run ends."""
    from galah_tpu_torch.timing import StageClock

    # galah-lint: ignore[GL701] a stamp for the report, not a duration
    started_at = time.time()
    obs.reset_run()
    interrupt.reset()
    interrupt.install()
    report_path = _start_telemetry(args)
    clock = None
    try:
        if args.resume and not args.checkpoint_dir:
            raise ValueError("--resume requires --checkpoint-dir")
        clock = StageClock(device_of(args))
        return _run_cluster(args, clock)
    finally:
        interrupt.uninstall()
        obs.finalize("cluster", clock, report_path=report_path,
                     started_at=started_at)


def _run_cluster(args: argparse.Namespace, clock) -> RunResult:
    """The library API's clusterer (``api.generate_galah_clusterer``)
    over the genome inputs, with the command's outputs, checkpoint and
    preemption around it, on the device of `clock` (a
    ``timing.StageClock``)."""
    from galah_tpu_torch.cluster.checkpoint import (ClusterCheckpoint,
                                                    fields_digest,
                                                    fingerprint_fields)
    from galah_tpu_torch.io import diskcache
    from galah_tpu_torch.outputs import (setup_outputs,
                                         validate_output_paths,
                                         write_outputs)
    from galah_tpu_torch.parallel import distributed
    from galah_tpu_torch.resilience.quarantine import (QuarantineManifest,
                                                       manifest_output_dir)
    from galah_tpu_torch.timing import trace_context

    device = clock.device
    # join the process group when torchrun's variables say so (a no-op
    # in one process); every rank computes the same clusters, and only
    # rank 0 writes them
    distributed.initialize(device=device)
    quarantine = QuarantineManifest()
    paths = _genome_inputs(args, quarantine)
    cache = diskcache.get_cache(args.sketch_cache, clock)
    if cache.enabled:
        logger.info("Using persistent sketch cache at %s", cache.path)
    clusterer = generate_galah_clusterer(
        paths, vars(args), cache=cache, quarantine_manifest=quarantine,
        device=device, clock=clock)
    genomes = clusterer.genome_paths
    # opened before any compute, so a bad output path fails fast; the
    # ranks that do not write check the same paths before the first
    # exchange
    is_writer = distributed.process_index() == 0
    output_args = dict(
        cluster_definition=args.output_cluster_definition,
        representative_fasta_directory=(
            args.output_representative_fasta_directory),
        representative_fasta_directory_copy=(
            args.output_representative_fasta_directory_copy),
        representative_list=args.output_representative_list)
    if is_writer:
        handles = setup_outputs(**output_args)
    else:
        validate_output_paths(**output_args)
        handles = None
    try:
        ckpt = None
        if args.checkpoint_dir:
            # each rank keeps its own checkpoint: ranks appending to one
            # would interleave it
            ckpt_dir = args.checkpoint_dir
            if distributed.process_count() > 1:
                ckpt_dir = os.path.join(
                    ckpt_dir, f"proc_{distributed.process_index()}")
            fields = fingerprint_fields(
                genomes, args.precluster_method, args.cluster_method,
                parse_percentage(args.ani, "--ani"),
                parse_percentage(args.precluster_ani, "--precluster-ani"),
                min_aligned_fraction=parse_percentage(
                    args.min_aligned_fraction, "--min-aligned-fraction"),
                fragment_length=args.fragment_length,
                backend_params=clusterer.backend_params)
            ckpt = ClusterCheckpoint(ckpt_dir, fields_digest(fields),
                                     fields=fields,
                                     require_match=args.resume)
            # the resume chain: a matching checkpoint with recorded
            # interruptions continues a stopped run
            prior = ckpt.load_interruptions()
            if ckpt.matched_existing and (prior or args.resume):
                interrupt.note_resume(ckpt_dir, len(prior))
                events.record("resumed", checkpoint_dir=ckpt_dir,
                              prior_interruptions=len(prior))
            # a resume is all-or-nothing across ranks: a stop can fall
            # between two ranks' saves, and uneven state would put one
            # rank in an exchange that another skips
            if distributed.process_count() > 1 and not \
                    distributed.tokens_agree(ckpt.state_token()):
                logger.warning(
                    "Checkpoint state differs across ranks; dropping it "
                    "and recomputing so that every rank stays in step")
                ckpt.reset_state()
            clusterer.checkpoint = ckpt
        logger.info("Clustering %d genomes on %s ..", len(genomes), device)
        try:
            with trace_context(args.profile_trace_dir, device):
                clusters = clusterer.cluster()
        except interrupt.PreemptionRequested as e:
            # everything before the boundary is durable: record the stop
            # and leave without outputs
            events.record("preempted", signal=e.signame,
                          boundary=e.boundary)
            if ckpt is not None:
                ckpt.record_interruption({
                    "signal": e.signame, "boundary": e.boundary,
                    # galah-lint: ignore[GL701] a stamp, not a duration
                    "ts": time.time()})
            logger.warning(
                "Preempted (%s): stopped at safe boundary %r. The "
                "checkpoint%s is consistent; rerun with --resume to "
                "continue. Exiting %d.", e.signame, e.boundary,
                f" at {ckpt.path}" if ckpt is not None else "",
                interrupt.EXIT_PREEMPTED)
            raise
        logger.info("Found %d genome clusters", len(clusters))
        if is_writer:
            with clock.stage("write-outputs"):
                write_outputs(handles, clusters, genomes)
        else:
            logger.info("Rank %d: outputs written by rank 0",
                        distributed.process_index())
    finally:
        if handles is not None:
            handles.close()
    if len(quarantine) and is_writer:
        quarantine.write(manifest_output_dir(
            cluster_definition=args.output_cluster_definition,
            representative_list=args.output_representative_list,
            checkpoint_dir=args.checkpoint_dir))
    if cache.enabled:
        logger.info("Sketch cache: %s", cache.stats())
    return RunResult(genomes=genomes, clusters=clusters, clock=clock,
                     store=clusterer.clusterer.store,
                     preclusterer=clusterer.preclusterer)


def run_cluster_validate(args: argparse.Namespace):
    """Re-check ``--cluster-file`` with the fastani clusterer; returns
    the ``validate.Validation``. Violations are logged, not raised."""
    from galah_tpu_torch.backends import (FastANIEquivalentClusterer,
                                          ProfileStore)
    from galah_tpu_torch.validate import validate_clusters

    if not args.cluster_file:
        raise ValueError("--cluster-file is required")
    ani = parse_percentage(args.ani, "--ani")
    min_af = parse_percentage(args.min_aligned_fraction,
                              "--min-aligned-fraction")
    if not 1 <= args.ani_subsample <= 1000:
        raise ValueError(f"--ani-subsample must be in [1, 1000], got "
                         f"{args.ani_subsample}")
    store = ProfileStore(device_of(args),
                         fraglen=args.fragment_length,
                         hash_algorithm=args.hash_algorithm,
                         threads=args.threads,
                         subsample_c=args.ani_subsample)
    clusterer = FastANIEquivalentClusterer(
        threshold=ani, min_aligned_fraction=min_af, store=store)
    return validate_clusters(args.cluster_file, clusterer)


@dataclasses.dataclass
class DistResult:
    genomes: List[str]
    pairs: Dict[Tuple[int, int], float]
    clock: object  # timing.StageClock
    store: object  # backends.SketchStore holding the run's sketches


def run_dist(args: argparse.Namespace) -> DistResult:
    """All-pairs MinHash ANI over the genome inputs, written as
    ``a<TAB>b<TAB>ani`` lines in sorted pair order to ``--output`` or
    stdout."""
    from galah_tpu_torch.backends import SketchStore
    from galah_tpu_torch.io import diskcache
    from galah_tpu_torch.ops.hashing import MAX_KMER
    from galah_tpu_torch.ops.minhash import sketch_matrix
    from galah_tpu_torch.ops.pairwise import threshold_pairs
    from galah_tpu_torch.ops.sketch_stream import iter_path_sketches
    from galah_tpu_torch.timing import StageClock

    if not 1 <= args.kmer_length <= MAX_KMER:
        # galah_tpu refuses k < 1; above 32 its 64-bit k-mer packs wrap,
        # and the orientation it hashes is then not the canonical one
        raise ValueError(
            f"--kmer-length {args.kmer_length}: galah_tpu_torch sketches "
            f"k-mers of 1 to {MAX_KMER} bases")
    device = device_of(args)
    clock = StageClock(device)
    genomes = _genome_inputs(args)
    cache = diskcache.get_cache(args.sketch_cache, clock)
    store = SketchStore(device, sketch_size=args.num_hashes,
                        k=args.kmer_length, algo=args.hash_algorithm,
                        clock=clock, cache=cache)
    logger.info("Sketching %d genomes ..", len(genomes))
    by_path = dict(iter_path_sketches(genomes, store, args.threads))
    mat = sketch_matrix([by_path[p] for p in genomes], args.num_hashes,
                        device)
    min_ani = (parse_percentage(args.min_ani, "--min-ani")
               if args.min_ani else 0.0)
    logger.info("Computing tiled all-pairs ANI ..")
    pairs = threshold_pairs(mat, args.kmer_length, min_ani,
                            args.num_hashes, clock)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for (i, j) in sorted(pairs):
            out.write(f"{genomes[i]}\t{genomes[j]}\t{pairs[(i, j)]:.6f}\n")
    finally:
        if args.output:
            out.close()
    logger.info("Wrote %d pairs", len(pairs))
    return DistResult(genomes=genomes, pairs=pairs, clock=clock,
                      store=store)


@dataclasses.dataclass
class IndexResult:
    action: str
    # build, insert, remove: the operation's summary; query: one dict a
    # genome; fsck: the audit
    info: object
    clock: object  # timing.StageClock, or None for remove and fsck


def _index_order_genomes(genomes: List[str], args: argparse.Namespace,
                         clock) -> List[str]:
    """Quality order for `index build`/`insert`; with no quality input,
    input order, with a warning of its own (once a process, key
    `index-quality-fallback`) and count `index-quality-fallback`
    (representative choice is then unranked)."""
    from galah_tpu_torch.api import quality_order_genomes

    with clock.stage("quality"):
        ordered, used_quality = quality_order_genomes(
            genomes, vars(args), threads=args.threads,
            missing_key="index-quality-fallback",
            missing_msg="Since CheckM input is missing, genomes enter the "
                        "index in input order, not quality order — "
                        "representative selection is unranked. Pass "
                        "--checkm-tab-table / --checkm2-quality-report / "
                        "--genome-info to rank them")
    if not used_quality:
        clock.count("index-quality-fallback", 1)
        events.record("index-quality-fallback", n_genomes=len(ordered))
        obs.metrics.counter(
            "index.quality_fallback",
            help="Index build/insert batches ordered by input order "
                 "because no quality input was given",
            unit="batches").inc()
    return ordered


def _run_index_fsck(index_dir: str) -> IndexResult:
    from galah_tpu_torch.index.store import fsck

    rep = fsck(index_dir)
    print(f"index {rep['path']}: generation {rep['generation']}, "
          f"{rep['genomes']} genome(s), {rep['clusters']} cluster(s), "
          f"{rep['pairs']} pair(s), {rep['tombstones']} tombstone(s)")
    for w in rep["warnings"]:
        print(f"  warning: {w}")
    for p in rep["problems"]:
        print(f"  PROBLEM: {p}")
    print("fsck: OK" if rep["ok"] else "fsck: FAILED")
    return IndexResult(action="fsck", info=rep, clock=None)


def run_index(args: argparse.Namespace) -> IndexResult:
    """One `index` action. fsck and remove use no device; build, insert
    and query run on ``--device``. SIGTERM and SIGINT request a stop for
    the length of the action: an insert records the interruption in the
    index and raises ``PreemptionRequested`` at its next batch boundary
    (``main`` exits 75). Every action but fsck writes the run report and
    the trace, however it ends."""
    action = args.index_action
    if action is None:
        raise ValueError("index needs an action: build, insert, query, "
                         "remove, or fsck")
    index_dir = args.index_dir or env_value(INDEX_DIR_ENV)
    if not index_dir:
        raise ValueError("no index directory: pass --index-dir or set "
                         f"{INDEX_DIR_ENV}")
    if action == "fsck":
        return _run_index_fsck(index_dir)
    from galah_tpu_torch.timing import StageClock

    # galah-lint: ignore[GL701] a stamp for the report, not a duration
    started_at = time.time()
    obs.reset_run()
    interrupt.reset()
    interrupt.install()
    report_path = _start_telemetry(args)
    clock = None
    try:
        genomes = _genome_inputs(args)
        if action != "remove":
            clock = StageClock(device_of(args))
        return _run_index(args, action, index_dir, genomes, clock)
    finally:
        interrupt.uninstall()
        obs.finalize("index", clock, report_path=report_path,
                     started_at=started_at)


def _run_index(args: argparse.Namespace, action: str, index_dir: str,
               genomes: List[str], clock) -> IndexResult:
    """`action` over `genomes`; `clock` (a ``timing.StageClock``) gives
    the device of build, insert and query, and is None for remove."""
    from galah_tpu_torch.index import incremental
    from galah_tpu_torch.index.store import IndexStore

    if action == "remove":
        idx = IndexStore(index_dir)
        info = None
        for p in genomes:
            info = incremental.remove(idx, p)
            logger.info("Removed %s: generation %d, %d genomes in %d "
                        "clusters remain", p, info["generation"],
                        info["genomes"], info["clusters"])
        return IndexResult(action=action, info=info, clock=None)
    device = clock.device
    if action == "build":
        ordered = _index_order_genomes(genomes, args, clock)
        info = incremental.build(
            index_dir, ordered, ani=parse_percentage(args.ani, "--ani"),
            precluster_ani=parse_percentage(args.precluster_ani,
                                            "--precluster-ani"),
            device=device, algo=args.hash_algorithm,
            cache_dir=args.sketch_cache, threads=args.threads,
            clock=clock)
        logger.info("Built index at %s: generation %d, %d genomes in "
                    "%d clusters", index_dir, info["generation"],
                    info["genomes"], info["clusters"])
        return IndexResult(action=action, info=info, clock=clock)

    idx = IndexStore(index_dir)
    if action == "insert":
        ordered = _index_order_genomes(genomes, args, clock)
        prior = idx.load_interruptions()
        if prior or args.resume:
            interrupt.note_resume(index_dir, len(prior))
            events.record("resumed", index_dir=index_dir,
                          prior_interruptions=len(prior))
        try:
            info = incremental.insert(
                idx, ordered, device=device, cache_dir=args.sketch_cache,
                threads=args.threads, batch=args.batch, clock=clock)
        except interrupt.PreemptionRequested as e:
            events.record("preempted", signal=e.signame,
                          boundary=e.boundary)
            idx.record_interruption({
                "signal": e.signame, "boundary": e.boundary,
                # galah-lint: ignore[GL701] a stamp, not a duration
                "ts": time.time()})
            logger.warning(
                "Preempted (%s): stopped at safe boundary %r. The index "
                "at %s is loadable at its last committed generation; "
                "rerun the same insert (--resume) to converge to the "
                "uninterrupted result. Exiting %d.", e.signame,
                e.boundary, index_dir, interrupt.EXIT_PREEMPTED)
            raise
        logger.info("Inserted %d genome(s) (%d skipped as already "
                    "present): generation %d, %d genomes in %d "
                    "clusters, %d new representative(s)",
                    info["inserted"], info["skipped"],
                    info["generation"], info["genomes"],
                    info["clusters"], info.get("new_reps", 0))
        return IndexResult(action=action, info=info, clock=clock)

    # query
    results = incremental.query(idx, genomes, device=device,
                                cache_dir=args.sketch_cache,
                                threads=args.threads, clock=clock)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        out.write("query\tdecision\trepresentative\tani\n")
        for r in results:
            ani = (f"{r['ani'] * 100:.4f}"
                   if r["ani"] is not None else "NA")
            out.write(f"{r['path']}\t{r['decision']}\t"
                      f"{r['rep'] or 'NA'}\t{ani}\n")
    finally:
        if args.output:
            out.close()
    return IndexResult(action=action, info=results, clock=clock)


def run_report_cmd(args: argparse.Namespace) -> int:
    """Render run_report.json files, or diff two of them; 1 on an
    unreadable or invalid report (``galah_tpu``'s ``run_report_cmd``).
    Pure file I/O: no device."""
    from galah_tpu_torch.obs import report as report_mod

    loaded = []
    for path in args.paths:
        try:
            rep = report_mod.load(path)
        except (OSError, ValueError) as e:  # missing file, bad JSON
            logger.error("%s: cannot read run report (%s)", path, e)
            return 1
        problems = report_mod.validate(rep)
        if problems:
            logger.error("%s: not a valid run report: %s", path,
                         problems[0])
            return 1
        loaded.append((path, rep))
    if args.diff:
        if len(loaded) != 2:
            logger.error("report --diff takes exactly two reports, "
                         "got %d", len(loaded))
            return 1
        (pa, ra), (pb, rb) = loaded
        sys.stdout.write(report_mod.diff(ra, rb, label_a=pa, label_b=pb))
        return 0
    for i, (path, rep) in enumerate(loaded):
        if i:
            sys.stdout.write("\n")
        sys.stdout.write(report_mod.render(rep))
    return 0


def run_perf_cmd(args: argparse.Namespace) -> int:
    """`perf record|history|check` over the ledger (``--ledger``, else
    ``GALAH_OBS_LEDGER``), with ``galah-tpu perf``'s output and exit
    codes: 1 with no ledger, no action, an unreadable report or a
    regression (``--soft``: reported, exit 0). File I/O only."""
    from galah_tpu_torch.obs import ledger as ledger_mod
    from galah_tpu_torch.obs import report as report_mod

    ledger_path = args.ledger or env_value("GALAH_OBS_LEDGER")
    if not ledger_path:
        logger.error("no ledger: pass --ledger or set GALAH_OBS_LEDGER")
        return 1
    action = args.perf_action
    if action is None:
        logger.error("perf needs an action: record, history, or check")
        return 1

    if action == "record":
        try:
            rep = report_mod.load(args.report)
        except (OSError, ValueError) as e:  # missing file, bad JSON
            logger.error("%s: cannot read run report (%s)", args.report, e)
            return 1
        entry = ledger_mod.entry_from_report(rep, args.source)
        ledger_mod.append(ledger_path, entry)
        print(f"recorded {len(entry['metrics'])} metric(s) to "
              f"{ledger_path}")
        return 0

    entries, skipped = ledger_mod.read(ledger_path)
    if skipped:
        logger.warning("%s: skipped %d torn/corrupt line(s)", ledger_path,
                       skipped)

    if action == "history":
        rows = ledger_mod.history(entries, args.metric)
        if args.key:
            rows = [r for r in rows if args.key in r["key"]]
        if not rows:
            print(f"no entries carry metric {args.metric!r}")
            return 0
        for r in rows:
            ts = time.strftime("%Y-%m-%d %H:%M",
                               time.localtime(r["ts"] or 0))
            print(f"{ts}  {r['sha'] or '-':>9}  {r['value']:<14.6g} "
                  f"{r['key']}")
        return 0

    if args.report:
        try:
            rep = report_mod.load(args.report)
        except (OSError, ValueError) as e:
            logger.error("%s: cannot read run report (%s)", args.report, e)
            return 1
        current = ledger_mod.entry_from_report(rep, args.source)
        history = entries
    else:
        if not entries:
            print("ledger is empty; nothing to check")
            return 0
        current, history = entries[-1], entries[:-1]
    window = (args.window if args.window is not None
              else int(env_value("GALAH_OBS_LEDGER_WINDOW")))
    mad_k = (args.mad_k if args.mad_k is not None
             else float(env_value("GALAH_OBS_LEDGER_MAD_K")))
    min_history = (args.min_history if args.min_history is not None
                   else ledger_mod.MIN_HISTORY)
    verdicts = ledger_mod.check(history, current, window=window,
                                mad_k=mad_k, min_history=min_history)
    bad = ledger_mod.regressions(verdicts)
    counts: Dict[str, int] = {}
    for v in verdicts:
        counts[v["verdict"]] = counts.get(v["verdict"], 0) + 1
    for v in verdicts:
        if v["verdict"] in ("ok", "insufficient-history"):
            continue
        band = v.get("band")
        band_s = (f" band=[{band[0]:.6g}, {band[1]:.6g}] "
                  f"(median {v['median']:.6g}, n={v['n_history']})"
                  if band else "")
        print(f"{v['verdict'].upper()}: {v['metric']} = "
              f"{v['value']:.6g}{band_s}")
    summary = ", ".join(f"{k}={counts[k]}" for k in sorted(counts)) \
        or "no comparable metrics"
    print(f"perf check [{ledger_mod.key_of(current)}]: {summary}")
    if bad and args.soft:
        print(f"--soft: {len(bad)} regression(s) reported, not gated")
        return 0
    return 1 if bad else 0


def run_flow_cmd(args: argparse.Namespace) -> int:
    """`flow analyze REPORT [--json]`: the critical path of a report's
    flow section, as ``galah-tpu flow analyze`` prints it; 1 on an
    unreadable report or one with no flow telemetry. File I/O only."""
    import json

    from galah_tpu_torch.obs import flow as flow_mod
    from galah_tpu_torch.obs import report as report_mod

    if args.flow_action is None:
        logger.error("flow needs an action: analyze")
        return 1
    try:
        rep = report_mod.load(args.report)
    except (OSError, ValueError) as e:  # missing file, bad JSON
        logger.error("%s: cannot read run report (%s)", args.report, e)
        return 1
    snap = rep.get("flow") or {}
    if not snap.get("stages"):
        logger.error("%s: no flow telemetry (run a pipelined "
                     "subcommand with GALAH_OBS_FLOW=1)", args.report)
        return 1
    wall = rep.get("run", {}).get("duration_s") or 0.0
    cp = flow_mod.critical_path(snap, float(wall))
    if args.json:
        print(json.dumps(cp, indent=1, sort_keys=True))
        return 0
    for line in flow_mod.render_critical_path(cp):
        print(line)
    return 0


def run_top_cmd(args: argparse.Namespace) -> int:
    """`top DIR [--follow] [--interval S] [--json]`: the newest beat of
    a run directory (or heartbeat file), or a fleet directory's
    per-shard grid; 0 rendered, 1 no data. File I/O only; a torn tail
    line is skipped."""
    import json

    from galah_tpu_torch.obs import fleet_view
    from galah_tpu_torch.obs import heartbeat as heartbeat_mod

    interval = max(float(args.interval or 2.0), 0.1)
    fleet_mode = (os.path.isdir(args.directory)
                  and fleet_view.is_fleet_dir(args.directory))
    while True:
        if fleet_mode:
            grid = fleet_view.fleet_grid(args.directory)
            ok = bool(grid and (grid["shards"] or grid["events"]))
            if args.json:
                sys.stdout.write(json.dumps(
                    grid or {}, indent=1, sort_keys=True) + "\n")
            else:
                sys.stdout.write(fleet_view.render_fleet_grid(
                    grid or {"fleet_dir": args.directory}))
        else:
            records, _torn = heartbeat_mod.load(args.directory)
            ok = bool(records)
            if args.json:
                latest = records[-1] if records else None
                sys.stdout.write(json.dumps(
                    latest, indent=1, sort_keys=True) + "\n")
            else:
                sys.stdout.write(heartbeat_mod.render_latest(args.directory))
        sys.stdout.flush()
        if not args.follow:
            return 0 if ok else 1
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


def run_fleet(args: argparse.Namespace) -> int:
    """`fleet run`: shard, supervise and merge, with `run_cluster`'s
    telemetry lifecycle (the supervisor's own run report, with its
    ``fleet`` and ``fleet_rollup`` sections, its heartbeat with role
    ``scheduler``). Returns the exit code: 0, 1 on a user error or a
    shard that spent its retry budget, 75 when the supervisor was
    stopped (rerun to resume)."""
    from galah_tpu_torch.timing import StageClock

    # galah-lint: ignore[GL701] a stamp for the report, not a duration
    started_at = time.time()
    obs.reset_run()
    interrupt.reset()
    interrupt.install()
    trace_path = env_value("GALAH_OBS_TRACE_EVENTS")
    if trace_path:
        obs.trace.start(trace_path)
    report_path = args.run_report or env_value("GALAH_OBS_REPORT")
    obs.install_crash_hooks()
    obs.heartbeat.maybe_start(report_path, role="scheduler")
    # every beat's OpenMetrics page carries the live cross-shard rollup
    # (a dir not yet rollable omits the fleet series)
    from galah_tpu_torch.obs import fleet_view

    fleet_dir = args.fleet_dir
    obs.openmetrics.set_rollup_provider(
        lambda: fleet_view.rollup(fleet_dir))
    clock = None
    try:
        clock = StageClock(device_of(args))
        return _run_fleet_inner(args, clock)
    finally:
        interrupt.uninstall()
        obs.finalize("fleet", clock, report_path=report_path,
                     started_at=started_at)


def _fleet_worker_argv(args: argparse.Namespace, fleet_dir: str,
                       cache_path: str):
    """The worker command line: one `python -m galah_tpu_torch cluster`
    run a shard on the supervisor's device, its genomes passed in shard
    order (already quality-ordered), so the worker never reorders
    them."""
    from galah_tpu_torch.fleet import scheduler as fleet_scheduler

    def worker_argv(spec, resume: bool) -> List[str]:
        sid = spec.shard_id
        argv = [sys.executable, "-m", "galah_tpu_torch", "cluster",
                "--genome-fasta-files", *spec.genomes,
                "--ani", str(args.ani),
                "--precluster-ani", str(args.precluster_ani),
                "--min-aligned-fraction", str(args.min_aligned_fraction),
                "--fragment-length", str(args.fragment_length),
                "--precluster-method", args.precluster_method,
                "--cluster-method", args.cluster_method,
                "--ani-subsample", str(args.ani_subsample),
                "--hash-algorithm", args.hash_algorithm,
                "--threads", str(args.threads or 1),
                "--checkpoint-dir",
                fleet_scheduler.shard_ckpt_dir(fleet_dir, sid),
                "--run-report",
                fleet_scheduler.shard_report_path(fleet_dir, sid),
                "--output-cluster-definition",
                fleet_scheduler.shard_tsv_path(fleet_dir, sid),
                "--device", device_type(args)]
        if cache_path:
            argv += ["--sketch-cache", cache_path]
        if resume:
            argv.append("--resume")
        return argv

    return worker_argv


def _run_fleet_inner(args: argparse.Namespace, clock) -> int:
    from galah_tpu_torch import fleet as fleet_pkg
    from galah_tpu_torch.cluster.checkpoint import fingerprint_fields
    from galah_tpu_torch.fleet import merge as fleet_merge
    from galah_tpu_torch.fleet import plan as fleet_plan
    from galah_tpu_torch.fleet.scheduler import FleetScheduler, append_stamp
    from galah_tpu_torch.io import atomic, diskcache
    from galah_tpu_torch.outputs import setup_outputs, write_outputs
    from galah_tpu_torch.resilience.quarantine import (QuarantineManifest,
                                                       manifest_output_dir)

    # the merge is byte-identical only when every shard's checkpoint is
    # thresholded at the final ANI, which is the skani/skani
    # configuration (the API precluster at the final ANI there); other
    # methods would shard correctly but merge approximately
    if (args.precluster_method != "skani"
            or args.cluster_method != "skani"):
        logger.error(
            "fleet run requires --precluster-method skani and "
            "--cluster-method skani (got %s/%s): the cross-shard "
            "merge is only byte-identical when shard checkpoints are "
            "thresholded at the final ANI", args.precluster_method,
            args.cluster_method)
        return 1

    fleet_dir = args.fleet_dir
    quarantine = QuarantineManifest()
    genomes = _genome_inputs(args, quarantine)

    # one shared cache for the workers and the merge
    cache_path = (args.sketch_cache or diskcache.default_cache_dir()
                  or os.path.join(fleet_dir, "cache"))
    cache = diskcache.get_cache(cache_path, clock)
    logger.info("Using shared fleet sketch cache at %s", cache.path)

    clusterer = generate_galah_clusterer(
        genomes, vars(args), cache=cache, quarantine_manifest=quarantine,
        device=clock.device, clock=clock)
    genomes = clusterer.genome_paths
    ani = parse_percentage(args.ani, "--ani")

    # only None is unset: --workers 0 / --shards 0 are refused below,
    # never replaced by the environment's or the default value
    workers = (args.workers if args.workers is not None
               else int(env_value("GALAH_TPU_FLEET_WORKERS") or 2))
    n_shards = (args.shards if args.shards is not None
                else int(env_value("GALAH_TPU_FLEET_SHARDS") or 0)
                or workers)
    if workers < 1:
        logger.error("--workers must be >= 1, got %d", workers)
        return 1
    stale_s = (args.stale_s if args.stale_s is not None
               else float(env_value("GALAH_TPU_FLEET_STALE_S") or 30))
    poll_s = float(env_value("GALAH_TPU_FLEET_POLL_S") or 0.2)
    heartbeat_s = float(env_value("GALAH_TPU_FLEET_HEARTBEAT_S") or 1)

    fields = fingerprint_fields(
        genomes, args.precluster_method, args.cluster_method, ani,
        parse_percentage(args.precluster_ani, "--precluster-ani"),
        min_aligned_fraction=parse_percentage(
            args.min_aligned_fraction, "--min-aligned-fraction"),
        fragment_length=args.fragment_length,
        backend_params=clusterer.backend_params)
    # a --resume under another configuration raises, naming the fields
    shards = fleet_plan.ensure_plan(fleet_dir, genomes, fields, n_shards,
                                    require_match=args.resume)
    logger.info("Fleet plan: %d genomes in %d shard(s), %d worker(s)",
                len(genomes), len(shards), workers)

    # opened before any compute, so a bad output path fails fast
    handles = setup_outputs(
        cluster_definition=args.output_cluster_definition,
        representative_fasta_directory=(
            args.output_representative_fasta_directory),
        representative_fasta_directory_copy=(
            args.output_representative_fasta_directory_copy),
        representative_list=args.output_representative_list)
    try:
        # the resume chain: earlier fleet-interrupted events mean this
        # run continues a stopped supervisor
        prior_records, _ = atomic.read_jsonl(
            fleet_plan.events_path(fleet_dir))
        prior = [r for r in prior_records if isinstance(r, dict)
                 and r.get("ev") == "fleet-interrupted"]
        if (prior or args.resume) and prior_records:
            interrupt.note_resume(fleet_dir, len(prior))
            events.record("resumed", fleet_dir=fleet_dir,
                          prior_interruptions=len(prior))

        sched = FleetScheduler(
            fleet_dir, shards,
            _fleet_worker_argv(args, fleet_dir, cache.path or cache_path),
            workers=workers, stale_s=stale_s, poll_s=poll_s,
            heartbeat_s=heartbeat_s)
        try:
            with clock.stage("fleet-supervise"):
                snap = sched.run()
        except interrupt.PreemptionRequested as e:
            events.record("preempted", signal=e.signame,
                          boundary=e.boundary)
            fleet_pkg.set_snapshot(sched.snapshot())
            logger.warning(
                "Fleet preempted (%s) at %r: worker checkpoints are "
                "consistent; rerun with --resume to continue. Exiting %d.",
                e.signame, e.boundary, interrupt.EXIT_PREEMPTED)
            return interrupt.EXIT_PREEMPTED
        if snap["shards_failed"]:
            fleet_pkg.set_snapshot(snap)
            logger.error(
                "%d shard(s) exhausted their retry budget (see "
                "fleet-shard-failed events at %s); not merging a partial "
                "fleet", snap["shards_failed"],
                fleet_plan.events_path(fleet_dir))
            return 1

        merge_t0 = time.monotonic()
        with clock.stage("fleet-merge"):
            clusters = fleet_merge.merge(fleet_dir, genomes, shards,
                                         clusterer.preclusterer, ani,
                                         clock=clock)
        snap["merge_wall_s"] = round(time.monotonic() - merge_t0, 6)
        snap["n_genomes"] = len(genomes)
        # the merge's window, in the event log too, so `fleet analyze`
        # works on a dir whose report never landed
        append_stamp(fleet_dir, "fleet-merge-done",
                     wall_s=snap["merge_wall_s"])
        fleet_pkg.set_snapshot(snap)
        logger.info("Found %d genome clusters", len(clusters))
        with clock.stage("write-outputs"):
            write_outputs(handles, clusters, genomes)
        logger.info("Finished printing genome clusters")
    finally:
        handles.close()
    if clusterer.quarantine is not None and len(clusterer.quarantine):
        clusterer.quarantine.write(manifest_output_dir(
            cluster_definition=args.output_cluster_definition,
            representative_list=args.output_representative_list,
            checkpoint_dir=fleet_dir))
    return 0


def run_fleet_status(args: argparse.Namespace) -> int:
    """`fleet status`: a fleet dir rendered without a device (and
    without torch)."""
    from galah_tpu_torch.fleet.scheduler import render_status

    sys.stdout.write(render_status(args.fleet_dir))
    return 0


def run_fleet_analyze(args: argparse.Namespace) -> int:
    """`fleet analyze`: the cross-shard critical path of a fleet dir,
    its blame table summing to the fleet wall, ``fleet_report.json``
    beside the plan and the named bottleneck. File reads only (no
    device, no torch); live and half-written dirs alike."""
    import json

    from galah_tpu_torch.obs import fleet_view

    # galah-lint: ignore[GL701] a stamp for the report, not a duration
    started_at = time.time()
    ru = fleet_view.rollup(args.fleet_dir)
    if ru is None:
        logger.error("%s: rollup-impossible — no fleet event log (run "
                     "`galah_tpu_torch fleet run --fleet-dir %s` first)",
                     args.fleet_dir, args.fleet_dir)
        return 1
    if not args.no_report:
        try:
            path = fleet_view.write_fleet_report(
                args.fleet_dir, ru, argv=sys.argv, started_at=started_at)
            logger.info("Wrote %s", path)
        except Exception:  # the table still prints without the file
            logger.warning("fleet_report.json write failed", exc_info=True)
    if args.json:
        print(json.dumps(ru, indent=1, sort_keys=True))
        return 0
    for line in fleet_view.render_rollup(ru):
        print(line)
    return 0


def run_fleet_cmd(args: argparse.Namespace) -> int:
    if args.fleet_action == "run":
        return run_fleet(args)
    if args.fleet_action == "status":
        return run_fleet_status(args)
    if args.fleet_action == "analyze":
        return run_fleet_analyze(args)
    raise ValueError("fleet needs an action: run, status or analyze")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parse_args(argv, parser)
    if args.subcommand is None:
        parser.print_help()
        return 1
    if args.subcommand == "lint":
        # reads files only: no logging setup, no device, no torch
        from galah_tpu_torch.analysis import main as lint_main

        return lint_main(args=args)
    # the help pages come before anything touches the device
    if args.full_help_roff:
        from galah_tpu_torch.manpage import render_full_help_roff

        sys.stdout.write(render_full_help_roff(
            parser.subcommand_parsers[args.subcommand], args.subcommand))
        return 0
    if args.full_help:
        from galah_tpu_torch.manpage import print_full_help

        print_full_help(parser.subcommand_parsers[args.subcommand],
                        args.subcommand)
        return 0
    set_log_level(verbose=args.verbose, quiet=args.quiet)
    # the file-reading tools: no device, no torch
    tools = {"report": run_report_cmd, "perf": run_perf_cmd,
             "flow": run_flow_cmd, "top": run_top_cmd}
    if args.subcommand in tools:
        return tools[args.subcommand](args)
    if args.subcommand == "fleet" and args.fleet_action in ("status",
                                                            "analyze"):
        return run_fleet_cmd(args)
    # the platform is tried before any work, as galah-tpu tries its JAX
    # backend: one line and exit 1 when it cannot start
    platform = _platform(args)
    if platform:
        from galah_tpu_torch.device import resolve_platform

        try:
            resolve_platform(platform)
        except Exception as e:  # noqa: BLE001 - any failure is the same
            msg = str(e).splitlines()[0] if str(e) else type(e).__name__
            logger.error("--platform %s: backend failed to initialize "
                         "(%s)", platform, msg)
            return 1
    logger.info("galah_tpu_torch version %s", __version__)
    # GALAH_SAN=1 arms the runtime concurrency sanitizer for this run
    # (the tier-1 tests set it); its summary lands in the run report
    # (obs/report.assemble), the full report at GALAH_SAN_REPORT
    from galah_tpu_torch.analysis import sanitizer as galah_san

    armed = galah_san.maybe_install()
    try:
        return _run_subcommand(args)
    finally:
        if armed:
            galah_san.write_report_if_asked()


def _run_subcommand(args: argparse.Namespace) -> int:
    """`main`'s device subcommands: the exit status, 75 for a stop and
    1 for a user error."""
    try:
        if args.subcommand == "cluster":
            run_cluster(args)
        elif args.subcommand == "dist":
            run_dist(args)
        elif args.subcommand == "fleet":
            return run_fleet_cmd(args)
        elif args.subcommand == "index":
            res = run_index(args)
            if res.action == "fsck" and not res.info["ok"]:
                return 1
        else:
            run_cluster_validate(args)
    except interrupt.PreemptionRequested:
        return interrupt.EXIT_PREEMPTED
    except (ValueError, OSError, KeyError, *CORRUPT_GZIP_ERRORS) as e:
        # a user error: one line, exit 1, no traceback; str(e) for an
        # OSError (args[0] is its errno) or a damaged gzip stream,
        # args[0] for the others (str(KeyError) is the key's repr)
        if isinstance(e, (OSError, *CORRUPT_GZIP_ERRORS)):
            logger.error("%s", e)
        else:
            logger.error("%s", e.args[0] if e.args else e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
