"""Extended ``--full-help`` pages: the port's copy of
``galah_tpu/manpage.py``.

The reference generates roff man pages from its flag definitions and
pipes them through ``man`` for --full-help (reference:
src/cluster_argument_parsing.rs:1194-1263 and the bird_tool_utils-man
builder). Here, as in ``galah_tpu``, the page is built from the argparse
parser plus section prose, as plain text (paged when stdout is a TTY)
or as roff source. Every page equals ``galah_tpu``'s for the same
parser but for its ENVIRONMENT section, which lists the variables the
port itself reads, and for the ``dist``, ``fleet``, ``perf``, ``flow``,
``top`` and ``lint`` epilogs, which ``galah_tpu`` lacks; the pages keep its
command name, ``galah-tpu``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import textwrap
from typing import List, Tuple

from galah_tpu_torch import __version__
from galah_tpu_torch.config import FLAGS

WIDTH = 78


def _wrap(text: str, indent: int = 3) -> str:
    return textwrap.fill(
        " ".join(text.split()), width=WIDTH,
        initial_indent=" " * indent, subsequent_indent=" " * indent)


def _format_action(action: argparse.Action) -> str:
    flags = ", ".join(action.option_strings)
    if action.metavar:
        flags += f" {action.metavar}"
    elif action.nargs != 0 and not isinstance(
            action, (argparse._StoreTrueAction, argparse._VersionAction)):
        flags += f" <{action.dest.upper()}>"
    lines = [f"  {flags}"]
    if action.help:
        help_text = action.help
        if action.choices:
            help_text += f" [choices: {', '.join(map(str, action.choices))}]"
        lines.append(_wrap(help_text, indent=6))
    return "\n".join(lines)


# Flags grouped into man-page sections; every flag not named here lands
# in OTHER GENERAL OPTIONS so new flags can never silently vanish from
# the page.
_SECTIONS: List[Tuple[str, str, List[str]]] = [
    ("GENOME INPUT",
     "Genomes may be given as explicit FASTA paths, a directory of "
     "FASTA files, or a text file listing one path per line. All input "
     "modes can be combined.",
     ["--genome-fasta-files", "--genome-fasta-list",
      "--genome-fasta-directory", "--genome-fasta-extension"]),
    ("CLUSTERING PARAMETERS",
     "Dereplication proceeds in two stages: a cheap sketch-based "
     "precluster pass over all genome pairs, then an exact ANI pass "
     "restricted to pairs that survived preclustering. Thresholds "
     "accept percentages (1-100) or fractions (0-1).",
     ["--ani", "--precluster-ani", "--min-aligned-fraction",
      "--fragment-length", "--precluster-method", "--cluster-method",
      "--hash-algorithm", "--ani-subsample"]),
    ("QUALITY FILTERING AND RANKING",
     "When a quality table is provided, genomes are filtered by "
     "completeness/contamination and ranked by the quality formula; "
     "higher-ranked genomes are preferred as cluster representatives. "
     "Without one, input order is used (a warning is printed).",
     ["--checkm-tab-table", "--checkm2-quality-report", "--genome-info",
      "--min-completeness", "--max-contamination", "--quality-formula"]),
    ("OUTPUT",
     "Outputs are opened before compute starts so misconfiguration "
     "fails fast.",
     ["--output-cluster-definition",
      "--output-representative-fasta-directory",
      "--output-representative-fasta-directory-copy",
      "--output-representative-list"]),
    ("PERFORMANCE AND RESUMPTION",
     "Device parallelism (TPU mesh sharding) is automatic; --threads "
     "only affects host-side FASTA ingestion. Sketches/profiles can "
     "persist across runs, and long runs can checkpoint and resume.",
     ["--threads", "--sketch-cache", "--checkpoint-dir",
      "--profile-trace-dir"]),
    ("OBSERVABILITY",
     "Every run can emit a machine-readable run_report.json (stage "
     "wall-clock tree, dispatch/sync round-trip counts, the "
     "precluster funnel, config-flag snapshot, and resilience "
     "events) and a Chrome-trace-format event timeline loadable in "
     "Perfetto alongside the XLA profile. Render or compare reports "
     "with `galah-tpu report [--diff A B]`. See docs/observability.md.",
     ["--run-report", "--trace-events"]),
]

_EPILOGS = {
    "cluster": """\
REPEAT-DRIVEN MERGES
   The exact-ANI gate passes a pair when EITHER direction's
   matched-fragment fraction reaches --min-aligned-fraction, and the
   reported ANI is the max over directions (reference fastANI-wrapper
   semantics). Genomes that merely share repeats or mobile elements
   can clear a low threshold on a sliver of their length: matched
   windows sit near 100% identity, so the pair reports high ANI over
   a low-but-passing aligned fraction. A runtime warning flags the
   signature (marginal AND direction-asymmetric aligned fractions);
   raising --min-aligned-fraction is the documented defense.

EXIT STATUS
   0 on success, 1 on recoverable user error (bad flags, missing
   files); unexpected internal errors raise a traceback.

EXAMPLES
   Dereplicate a directory of MAGs at 95% ANI, writing the cluster
   table and symlinking representatives:

      galah-tpu cluster -d genomes/ -x fna \\
         --output-cluster-definition clusters.tsv \\
         --output-representative-fasta-directory reps/

   Quality-rank with CheckM2 and require 70% completeness:

      galah-tpu cluster -d genomes/ \\
         --checkm2-quality-report quality_report.tsv \\
         --min-completeness 70 --max-contamination 10 \\
         --output-cluster-definition clusters.tsv
""",
    "cluster-validate": """\
EXIT STATUS
   0 on success (violations are logged as errors, matching the
   reference's behavior of reporting rather than aborting).

EXAMPLES
      galah-tpu cluster-validate --cluster-file clusters.tsv --ani 95
""",
    "report": """\
REPORT CONTENTS
   A run report (produced by `cluster --run-report PATH` or the
   GALAH_OBS_REPORT variable, schema committed at
   galah_tpu/obs/run_report.schema.json) records the stage wall-clock
   tree, per-stage device dispatch and host-sync round trips, the
   precluster funnel (possible -> screened -> kept -> ANI-computed
   pairs plus sketch-cache hit rate), the full GALAH_* flag snapshot,
   device topology, typed metrics, and every resilience event
   (retries, CPU-fallback demotions, quarantined genomes).

EXIT STATUS
   0 on success (including a clean diff); 1 on unreadable or
   schema-invalid input.

EXAMPLES
   Render one report:

      galah-tpu report run_report.json

   Diff two runs stage-by-stage and metric-by-metric:

      galah-tpu report --diff before.json after.json
""",
    "dist": """\
OUTPUT
   One line per genome pair whose sketches share any hash, or whose
   ANI reaches --min-ani: genome_a<TAB>genome_b<TAB>ani, the ANI a
   fraction with six decimals, pairs in input order (a before b).

EXIT STATUS
   0 on success, 1 on recoverable user error (bad flags, missing
   files, a --kmer-length outside 1-32).

EXAMPLES
      galah-tpu dist -d genomes/ -x fna --min-ani 95 --output pairs.tsv
""",
    "index": """\
INDEX MODEL
   The index directory (docs/index.md) persists the dereplication
   state of a genome catalogue: sketches, thresholded sketch-ANI
   pairs, and the greedy representative/membership decisions, under
   a monotonically versioned generation pointer. `build` runs the
   device sketch pipeline once; `insert` sketches ONLY the new
   genomes, takes only their pairs in one device pass a batch
   (bit-identical integer pair statistics), and commits the next
   generation — the resulting clusters are byte-identical to
   re-dereplicating the grown catalogue from scratch, as long as
   inserts respect the quality order. `query` mutates nothing and
   answers from the committed state with one device pass over its
   (representative, query) pairs.
   `remove` tombstones a genome and locally re-elects within its own
   cluster (local repair, not a from-scratch equivalence).

   Every append is durable (per-record fsync + checksum framing) and
   a generation commits by an atomic pointer swap, so a writer
   killed at ANY instant leaves the index loadable at its previous
   generation; rerunning the same insert converges to the same
   bytes. SIGTERM/SIGINT stop at the next batch boundary with exit
   status 75.

EXIT STATUS
   0 on success, 1 on user error or a failed fsck, 75 when a
   cooperative-preemption request stopped an insert at a safe
   boundary (rerun to continue).

EXAMPLES
   Build an index over a catalogue, quality-ranked:

      galah-tpu index --index-dir idx/ build -d genomes/ -x fna \\
         --checkm2-quality-report quality_report.tsv --ani 95

   Insert this week's new MAGs (only they are sketched):

      galah-tpu index --index-dir idx/ insert -d new_mags/ -x fna

   Ask where a genome would land, without changing anything:

      galah-tpu index --index-dir idx/ query -f novel.fna

   Audit the on-disk state:

      galah-tpu index --index-dir idx/ fsck
""",
    "fleet": """\
FLEET MODEL
   `run` slices the quality-ordered genomes into --shards contiguous
   shards and runs one `python -m galah_tpu_torch cluster` worker a
   shard, at most --workers at once, on the supervisor's --device and
   with a checkpoint of its own. Exit 75, death by a signal and a
   heartbeat older than --stale-s all mean preemption: the shard is
   reassigned to a fresh worker that resumes from its checkpoint, and
   a shard that spends its retry budget (GALAH_TPU_FLEET_RETRY_*)
   fails the fleet. The merge unions the shards' pairs, adds the
   cross-shard pairs and replays the greedy selection: the clusters
   equal a single-process run's byte for byte (skani/skani only).
   Every decision is logged in <fleet-dir>/fleet_events.jsonl before
   it is acted on, so a rerun of the same command resumes the fleet.
   Concurrent workers build the CUDA kernels safely: each build is
   written to a file of its own and renamed into place.

EXIT STATUS
   0 on success; 1 on a user error, a plan of another configuration
   under --resume, or a shard that spent its retry budget; 75 when the
   supervisor was stopped (rerun to resume).

EXAMPLES
   Four shards over two workers sharing one GPU:

      galah_tpu_torch fleet run -d genomes/ -x fna --fleet-dir fl/ \\
         --workers 2 --shards 4 --output-cluster-definition clusters.tsv

   Watch it, then read where its time went:

      galah_tpu_torch fleet status fl/
      galah_tpu_torch fleet analyze fl/
""",
    "perf": """\
LEDGER
   One crc-framed JSON line a run: `cluster` and `index` runs append
   one when GALAH_OBS_LEDGER names the file, `perf record` one from a
   run report. An entry's key is the backend, the card and device
   count, the workload (genomes N, sketch K) and the strategy; its
   metrics are the run wall, the stage walls, launches, the kernels'
   dispatch and build seconds and the flow blame. galah-tpu's ledger
   files read and write the same lines.

EXIT STATUS
   0 on success; 1 with no ledger, an unreadable report, or (`check`)
   a regression outside the noise band; --soft reports and exits 0.

EXAMPLES
      GALAH_OBS_LEDGER=perf.jsonl galah_tpu_torch cluster -d genomes/ \\
         -x fna --output-cluster-definition clusters.tsv
      galah_tpu_torch perf --ledger perf.jsonl history run.duration_s
      galah_tpu_torch perf --ledger perf.jsonl check
""",
    "lint": """\
CHECKER FAMILIES
   kernels (GL111-GL115): each ctypes signature of kernels/build.py
   against its extern "C" prototype, a .cu without a binding and a
   binding without a .cu, launches that are not profiled, checked and
   counted, asserted launch preconditions, torch.uint64. flags
   (GL401-405): the GALAH_* registry against every env read and the
   ENVIRONMENT section. markers (GL601): hardware-only tests carry a
   slow or hardware marker. obs (GL701-703): durations through
   timing.py and obs/, not raw clocks; GL704, flow spans in
   PIPELINE_STAGE modules. concurrency (GL801-805): GUARDED_BY and
   LOCK_ORDER of the threaded modules, lock order and cycles, flow
   adoption of worker threads. fs (GL806): durable artifacts only
   through io/atomic.py. determinism (GL901-905): the strategy
   modules' DETERMINISM_CONTRACT, masked zero-filled sums, f64->f32
   narrowing, set order, unseeded numpy/torch RNG. pipeline
   (GL1001-1007): PIPELINE_STAGE, materialized streams, host syncs in
   streaming stages, unbounded pools, the occupancy gauge. effects
   (GL1101-1105, and GL1007's interprocedural arm): the same contracts
   across calls, over GalahIR, the package's call graph with each
   function's effects propagated to a fixpoint; a host sync reached
   from a device-round body, durable writes around io/atomic.py,
   stream materialization, lock leaks on raising paths, pool
   callbacks with effects that adopt no flow token; each finding
   carries its chain of calls down to the line at fault.
   suppressions (GL001): expired `expires=` dates. galah-tpu's Pallas,
   JAX-tracing and shape families have no counterpart.

IR CACHE
   --ir-cache-dir DIR (or GALAH_TPU_IR_CACHE=DIR; the flag wins) keeps
   each file's GalahIR as one JSON entry, keyed by the file's path and
   content and by the package, written through io/atomic.py; a warm
   run skips the per-file extraction, a corrupt entry is dropped and
   rebuilt. galah-tpu lint may share the directory: neither package
   reads the other's entries. Unset, nothing is cached.

SANITIZER
   GALAH_SAN=1 arms GalahSan for a run of any subcommand: the
   threaded modules' declared locks are wrapped, and the run report's
   sanitizer section counts undeclared acquisitions, unordered edges,
   inversions and races (each must be 0). GALAH_SAN_REPORT=PATH also
   writes the full lock graph there.

SUPPRESSION
   `# galah-lint: ignore[CODE] reason` on the flagged line or the line
   above (`// galah-lint: ignore[CODE]` in a .cu), optionally with
   `expires=YYYY-MM-DD`; or an entry in
   galah_tpu_torch/analysis/baseline.json (--update-baseline), which
   the repo keeps empty.

EXIT STATUS
   1 on any unsuppressed finding at WARNING or above, else 0.

EXAMPLES
      galah_tpu_torch lint
      galah_tpu_torch lint --check kernels --json
      galah_tpu_torch lint --check effects --ir-cache-dir .ircache
      python -m galah_tpu_torch.analysis --changed-only
""",
    "flow": """\
EXIT STATUS
   0 analysis printed; 1 unreadable report or no flow telemetry.

EXAMPLES
      galah_tpu_torch flow analyze run_report.json
      galah_tpu_torch flow analyze --json run_report.json
""",
    "top": """\
EXIT STATUS
   0 rendered; 1 no heartbeat or fleet data.

EXAMPLES
      GALAH_OBS_HEARTBEAT_S=1 galah_tpu_torch cluster -d genomes/ \\
         -x fna --run-report run/report.json \\
         --output-cluster-definition clusters.tsv &
      galah_tpu_torch top run/ --follow
""",
}


# section titles of the ENVIRONMENT page, in galah_tpu's order
_ENV_SECTION_TITLES = [
    ("runtime", "Runtime and IO"),
    ("resilience", "Resilience"),
    ("observability", "Observability"),
]


def render_environment_section() -> str:
    """The ENVIRONMENT section, rendered from the port's registry
    (``config.FLAGS``): every GALAH_* variable galah_tpu_torch reads."""
    out = ["ENVIRONMENT",
           _wrap("Every GALAH_* variable galah_tpu_torch reads."),
           ""]
    for section, title in _ENV_SECTION_TITLES:
        out.append(f"  {title}:")
        for flag in sorted(FLAGS.values(), key=lambda f: f.name):
            if flag.section != section:
                continue
            head = f"  {flag.name}"
            if flag.default is not None:
                head += f" (default: {flag.default})"
            out.append(head)
            out.append(_wrap(flag.help, indent=6))
        out.append("")
    return "\n".join(out)


def render_full_help(parser: argparse.ArgumentParser,
                     subcommand: str) -> str:
    by_flag = {}
    general = []
    for action in parser._actions:
        if not action.option_strings:
            continue
        key = action.option_strings[-1]
        by_flag[key] = action
        general.append(key)

    out = []
    prog = f"galah-tpu {subcommand}"
    out.append(prog.upper())
    out.append("")
    out.append("NAME")
    out.append(_wrap(f"{prog} — {parser.description}"))
    out.append("")

    used = set()
    for title, prose, flags in _SECTIONS:
        present = [f for f in flags if f in by_flag]
        if not present:
            continue
        out.append(title)
        if prose:
            out.append(_wrap(prose))
            out.append("")
        for f in present:
            out.append(_format_action(by_flag[f]))
            used.add(f)
        out.append("")

    rest = [f for f in general if f not in used and f != "--help"]
    if rest:
        out.append("OTHER GENERAL OPTIONS")
        for f in rest:
            out.append(_format_action(by_flag[f]))
        out.append("")

    out.append(render_environment_section())
    out.append(_EPILOGS.get(subcommand, ""))
    return "\n".join(out)


def render_full_help_roff(parser: argparse.ArgumentParser,
                          subcommand: str) -> str:
    """The same page as groff man source (the reference renders its
    help through roff via bird_tool_utils-man; --full-help-roff exposes
    the source the same way)."""
    def esc(t: str) -> str:
        return t.replace("\\", "\\\\").replace("-", "\\-")

    by_flag = {}
    general = []
    for action in parser._actions:
        if not action.option_strings:
            continue
        key = action.option_strings[-1]
        by_flag[key] = action
        general.append(key)

    prog = f"galah-tpu {subcommand}"
    out = [
        f'.TH "{prog.upper().replace(" ", "-")}" "1" "" '
        f'"galah-tpu {__version__}" "User Commands"',
        ".SH NAME",
        f"{esc(prog)} \\- {esc(parser.description or '')}",
    ]

    def emit_action(action) -> None:
        names = ", ".join(f"\\fB{esc(o)}\\fR"
                          for o in action.option_strings)
        if action.metavar or (action.nargs != 0
                              and action.const is None
                              and not isinstance(action.nargs, int)
                              and action.type is not None
                              or action.choices):
            names += " \\fI<value>\\fR"
        out.append(".TP")
        out.append(names)
        help_text = action.help or ""
        if action.choices:
            help_text += (" [choices: "
                          + ", ".join(map(str, action.choices)) + "]")
        out.append(esc(help_text))

    used = set()
    for title, prose, flags in _SECTIONS:
        present = [f for f in flags if f in by_flag]
        if not present:
            continue
        out.append(f".SH {title}")
        if prose:
            out.append(esc(prose))
        for f in present:
            emit_action(by_flag[f])
            used.add(f)
    rest = [f for f in general if f not in used and f != "--help"]
    if rest:
        out.append(".SH OTHER GENERAL OPTIONS")
        for f in rest:
            emit_action(by_flag[f])
    out.append(".SH ENVIRONMENT")
    for flag in sorted(FLAGS.values(), key=lambda f: f.name):
        out.append(".TP")
        out.append(f"\\fB{esc(flag.name)}\\fR")
        out.append(esc(flag.help))

    epilog = _EPILOGS.get(subcommand, "")
    for block in epilog.split("\n\n"):
        if not block.strip():
            continue
        first, _, restb = block.partition("\n")
        if first.isupper():
            out.append(f".SH {first.strip()}")
            if restb:
                out.append(".nf")
                out.append(esc(restb))
                out.append(".fi")
        else:
            out.append(esc(block))
    return "\n".join(out) + "\n"


def print_full_help(parser: argparse.ArgumentParser,
                    subcommand: str) -> None:
    text = render_full_help(parser, subcommand)
    pager = os.environ.get("PAGER") or "less"
    if sys.stdout.isatty() and shutil.which(pager.split()[0]):
        proc = subprocess.Popen([pager.split()[0], "-"] if pager == "less"
                                else pager.split(),
                                stdin=subprocess.PIPE)
        proc.communicate(text.encode())
    else:
        sys.stdout.write(text)
