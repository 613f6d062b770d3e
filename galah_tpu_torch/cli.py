"""``python -m galah_tpu_torch``: the port's command line.

Three subcommands of ``galah-tpu``, with its defaults, help strings and
output formats:

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
* ``report``: render run reports, or ``--diff`` two, of either package.

``cluster`` and ``index`` write a run report (``--run-report`` or
``GALAH_OBS_REPORT``), a Chrome trace (``--trace-events`` or
``GALAH_OBS_TRACE_EVENTS``) and, with ``GALAH_OBS_HEARTBEAT_S`` set, a
``heartbeat.jsonl`` beside the report (``obs/``); a preempted or failed
run still writes its report and closes its trace.

Each takes ``-v``/``-q``, ``--full-help`` and ``--full-help-roff``, and
each but ``report`` the device (``--device``, cuda unless the CPU is
asked for).
Percentages parse as in ``galah-tpu``. A flag of ``galah-tpu``'s command
line that the port does not support yet is an error that names it; no
flag is silently ignored. A user error (a bad value, a missing file)
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
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from galah_tpu_torch import __version__, obs
from galah_tpu_torch.api import (add_cluster_arguments,
                                 generate_galah_clusterer)
from galah_tpu_torch.config import (HASH_ALGORITHMS, QUALITY_FORMULAS,
                                    Defaults, env_value, parse_percentage)
from galah_tpu_torch.index import INDEX_DIR_ENV
from galah_tpu_torch.io.fasta import CORRUPT_GZIP_ERRORS
from galah_tpu_torch.obs import events
from galah_tpu_torch.resilience import interrupt

logger = logging.getLogger("galah_tpu_torch")

# flags of `galah-tpu`'s subcommands that this port does not support
# yet: the XLA profiler trace and the JAX platform (`cluster`'s
# --rep-scan-window parses, from the library API, and is refused after
# parsing)
UNSUPPORTED_FLAGS = ("--profile-trace-dir", "--platform")


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
    p.add_argument("--full-help", action="store_true",
                   help="Display an extended man-style help page and exit")
    p.add_argument("--full-help-roff", action="store_true",
                   help="Print the extended help as raw roff man source "
                        "and exit (pipe through `man -l -`)")


def _add_common(p: argparse.ArgumentParser) -> None:
    _add_verbosity(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
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
    ixi.add_argument("--batch", type=int, default=Defaults.INDEX_BATCH,
                     help="Genomes per durable append batch — the "
                          "preemption safe-boundary granularity "
                          f"(default: {Defaults.INDEX_BATCH})")
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
    parser.subcommand_parsers = {"cluster": c, "cluster-validate": v,
                                 "dist": dd, "index": ix, "report": rp}
    return parser


def parse_args(argv: Optional[Sequence[str]],
               parser: Optional[argparse.ArgumentParser] = None
               ) -> argparse.Namespace:
    parser = parser or build_parser()
    args, unknown = parser.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in UNSUPPORTED_FLAGS:
            parser.error(f"{flag}: this flag of `galah-tpu "
                         f"{args.subcommand}` is not supported by "
                         "galah_tpu_torch yet")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if getattr(args, "rep_scan_window", None) is not None:
        parser.error("--rep-scan-window: this flag of `galah-tpu cluster` "
                     "is not supported by galah_tpu_torch yet")
    return args


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
    from galah_tpu_torch.device import resolve_device
    from galah_tpu_torch.timing import StageClock

    started_at = time.time()  # a stamp for the report, not a duration
    obs.reset_run()
    interrupt.reset()
    interrupt.install()
    report_path = _start_telemetry(args)
    clock = None
    try:
        if args.resume and not args.checkpoint_dir:
            raise ValueError("--resume requires --checkpoint-dir")
        clock = StageClock(resolve_device(args.device))
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
    from galah_tpu_torch.outputs import setup_outputs, write_outputs
    from galah_tpu_torch.resilience.quarantine import (QuarantineManifest,
                                                       manifest_output_dir)

    device = clock.device
    quarantine = QuarantineManifest()
    paths = _genome_inputs(args, quarantine)
    cache = diskcache.get_cache(args.sketch_cache, clock)
    if cache.enabled:
        logger.info("Using persistent sketch cache at %s", cache.path)
    clusterer = generate_galah_clusterer(
        paths, vars(args), cache=cache, quarantine_manifest=quarantine,
        device=device, clock=clock)
    genomes = clusterer.genome_paths
    # opened before any compute, so a bad output path fails fast
    handles = setup_outputs(
        cluster_definition=args.output_cluster_definition,
        representative_fasta_directory=(
            args.output_representative_fasta_directory),
        representative_fasta_directory_copy=(
            args.output_representative_fasta_directory_copy),
        representative_list=args.output_representative_list)
    try:
        ckpt = None
        if args.checkpoint_dir:
            fields = fingerprint_fields(
                genomes, args.precluster_method, args.cluster_method,
                parse_percentage(args.ani, "--ani"),
                parse_percentage(args.precluster_ani, "--precluster-ani"),
                min_aligned_fraction=parse_percentage(
                    args.min_aligned_fraction, "--min-aligned-fraction"),
                fragment_length=args.fragment_length,
                backend_params=clusterer.backend_params)
            ckpt = ClusterCheckpoint(args.checkpoint_dir,
                                     fields_digest(fields), fields=fields,
                                     require_match=args.resume)
            # the resume chain: a matching checkpoint with recorded
            # interruptions continues a stopped run
            prior = ckpt.load_interruptions()
            if ckpt.matched_existing and (prior or args.resume):
                interrupt.note_resume(args.checkpoint_dir, len(prior))
                events.record("resumed", checkpoint_dir=args.checkpoint_dir,
                              prior_interruptions=len(prior))
            clusterer.checkpoint = ckpt
        logger.info("Clustering %d genomes on %s ..", len(genomes), device)
        try:
            clusters = clusterer.cluster()
        except interrupt.PreemptionRequested as e:
            # everything before the boundary is durable: record the stop
            # and leave without outputs
            events.record("preempted", signal=e.signame,
                          boundary=e.boundary)
            if ckpt is not None:
                ckpt.record_interruption({
                    "signal": e.signame, "boundary": e.boundary,
                    "ts": time.time()})  # a stamp, not a duration
            logger.warning(
                "Preempted (%s): stopped at safe boundary %r. The "
                "checkpoint%s is consistent; rerun with --resume to "
                "continue. Exiting %d.", e.signame, e.boundary,
                f" at {ckpt.path}" if ckpt is not None else "",
                interrupt.EXIT_PREEMPTED)
            raise
        logger.info("Found %d genome clusters", len(clusters))
        with clock.stage("write-outputs"):
            write_outputs(handles, clusters, genomes)
    finally:
        handles.close()
    if len(quarantine):
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
    from galah_tpu_torch.device import resolve_device
    from galah_tpu_torch.validate import validate_clusters

    if not args.cluster_file:
        raise ValueError("--cluster-file is required")
    ani = parse_percentage(args.ani, "--ani")
    min_af = parse_percentage(args.min_aligned_fraction,
                              "--min-aligned-fraction")
    if not 1 <= args.ani_subsample <= 1000:
        raise ValueError(f"--ani-subsample must be in [1, 1000], got "
                         f"{args.ani_subsample}")
    store = ProfileStore(resolve_device(args.device),
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
    from galah_tpu_torch.device import resolve_device
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
    device = resolve_device(args.device)
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
    from galah_tpu_torch.device import resolve_device
    from galah_tpu_torch.timing import StageClock

    started_at = time.time()  # a stamp for the report, not a duration
    obs.reset_run()
    interrupt.reset()
    interrupt.install()
    report_path = _start_telemetry(args)
    clock = None
    try:
        genomes = _genome_inputs(args)
        if action != "remove":
            clock = StageClock(resolve_device(args.device))
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
                "ts": time.time()})  # a stamp, not a duration
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parse_args(argv, parser)
    if args.subcommand is None:
        parser.print_help()
        return 1
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
    if args.subcommand == "report":
        return run_report_cmd(args)
    logger.info("galah_tpu_torch version %s", __version__)
    try:
        if args.subcommand == "cluster":
            run_cluster(args)
        elif args.subcommand == "dist":
            run_dist(args)
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
