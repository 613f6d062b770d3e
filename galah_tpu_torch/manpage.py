"""Extended ``--full-help`` pages: the port's copy of
``galah_tpu/manpage.py``.

The reference generates roff man pages from its flag definitions and
pipes them through ``man`` for --full-help (reference:
src/cluster_argument_parsing.rs:1194-1263 and the bird_tool_utils-man
builder). Here, as in ``galah_tpu``, the page is built from the argparse
parser plus section prose, as plain text (paged when stdout is a TTY)
or as roff source. Every page equals ``galah_tpu``'s for the same
parser but for its ENVIRONMENT section, which lists the variables the
port itself reads, and for the ``dist`` epilog, which ``galah_tpu``
lacks; the pages keep its command name, ``galah-tpu``.
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
