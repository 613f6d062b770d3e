"""``python -m galah_tpu_torch cluster``: the port's command line.

The port's subset of ``galah-tpu cluster``: genome inputs (-f, -d,
-x), the thresholds, the skani, finch or dashing precluster with the
skani or fastani clusterer, the hash algorithm, quality ordering (a
CheckM1 table, a CheckM2 report or a genomeInfo CSV, the formula and
the completeness and contamination filters), the cluster definition
TSV, the host threads that read genomes ahead (``--threads``), and the
device. Defaults and help are those of
``galah-tpu cluster``, and percentages parse as there. A flag of the
``galah-tpu cluster`` command line that this slice does not support is
an error that names it; no flag is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import List, Optional, Sequence

from galah_tpu_torch import __version__
from galah_tpu_torch.config import (CLUSTER_METHODS, HASH_ALGORITHMS,
                                    PRECLUSTER_METHODS, QUALITY_FORMULAS,
                                    Defaults, parse_percentage)

logger = logging.getLogger("galah_tpu_torch")

# flags of `galah-tpu cluster` that this port does not support yet
UNSUPPORTED_FLAGS = (
    "--genome-fasta-list",
    "--ani-subsample", "--rep-scan-window", "--rep-rounds",
    "--on-bad-genome", "--sketch-cache", "--profile-trace-dir",
    "--trace-events", "--run-report", "--checkpoint-dir", "--resume",
    "--output-representative-fasta-directory",
    "--output-representative-fasta-directory-copy",
    "--output-representative-list", "--platform", "--full-help",
    "--full-help-roff", "-v", "--verbose", "-q", "--quiet",
)


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
    c.add_argument("-f", "--genome-fasta-files", nargs="+",
                   help="Path(s) to FASTA files of each genome")
    c.add_argument("-d", "--genome-fasta-directory",
                   help="Directory containing FASTA files of each genome")
    c.add_argument("-x", "--genome-fasta-extension", default="fna",
                   help="File extension of genomes in the directory "
                        "(default: fna)")
    c.add_argument("--ani", type=float, default=Defaults.ANI,
                   help="ANI threshold for clustering (default: 95)")
    c.add_argument("--precluster-ani", type=float,
                   default=Defaults.PRETHRESHOLD_ANI,
                   help="Precluster ANI threshold (default: 90; equal to "
                        "--ani for skani+skani)")
    c.add_argument("--min-aligned-fraction", type=float,
                   default=Defaults.ALIGNED_FRACTION * 100,
                   help="Min aligned fraction of two genomes for "
                        "clustering (default: 15)")
    c.add_argument("--fragment-length", type=int,
                   default=Defaults.FRAGMENT_LENGTH,
                   help="Fragment length of the fastANI-style "
                        "calculation (default: 3000)")
    c.add_argument("--precluster-method", default=Defaults.PRECLUSTER_METHOD,
                   choices=PRECLUSTER_METHODS,
                   help="Precluster method: skani, finch or dashing "
                        "(default: skani)")
    c.add_argument("--cluster-method", default=Defaults.CLUSTER_METHOD,
                   choices=CLUSTER_METHODS,
                   help="Exact ANI method (default: skani)")
    c.add_argument("--hash-algorithm", default=Defaults.HASH_ALGO,
                   choices=HASH_ALGORITHMS,
                   help="k-mer hash of the sketches and profiles: murmur3 "
                        "(the finch contract) or tpufast (default: "
                        "murmur3)")
    c.add_argument("--checkm-tab-table",
                   help="Output of `checkm qa .. --tab_table`")
    c.add_argument("--checkm2-quality-report",
                   help="CheckM2 quality_report.tsv output")
    c.add_argument("--genome-info",
                   help="dRep-style genome info CSV "
                        "(genome,completeness,contamination)")
    c.add_argument("--min-completeness", type=float,
                   help="Ignore genomes with less completeness than "
                        "this percentage")
    c.add_argument("--max-contamination", type=float,
                   help="Ignore genomes with more contamination than "
                        "this percentage")
    c.add_argument("--quality-formula", default=Defaults.QUALITY_FORMULA,
                   choices=QUALITY_FORMULAS,
                   help="Quality formula for ranking genomes "
                        "(default: Parks2020_reduced)")
    c.add_argument("--threads", "-t", type=int, default=1,
                   help="Host threads for FASTA stats/IO fan-out "
                        "and CPU-backend native sketching/profiling; "
                        "device parallelism is managed by the mesh")
    c.add_argument("--output-cluster-definition",
                   help="Output file of rep<TAB>member lines")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Device to run on (default: cuda; asking for "
                        "cuda without a GPU is an error)")
    return parser


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in UNSUPPORTED_FLAGS:
            parser.error(f"{flag}: this flag of `galah-tpu cluster` is "
                         "not supported by galah_tpu_torch yet")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args


def genome_paths(args: argparse.Namespace) -> List[str]:
    """-f files, then the -d directory's entries with the extension,
    sorted (the order ``galah_tpu/genome_inputs.py`` gives)."""
    out: List[str] = list(args.genome_fasta_files or [])
    if args.genome_fasta_directory:
        suffix = "." + args.genome_fasta_extension.lstrip(".")
        out.extend(os.path.join(args.genome_fasta_directory, e)
                   for e in sorted(os.listdir(args.genome_fasta_directory))
                   if e.endswith(suffix))
    if not out:
        raise ValueError("No genome input specified: use "
                         "--genome-fasta-files or --genome-fasta-directory")
    missing = [p for p in out if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(
            f"Genome FASTA file(s) not found: {missing[:5]}")
    return out


@dataclasses.dataclass
class RunResult:
    genomes: List[str]
    clusters: List[List[int]]
    clock: object  # timing.StageClock
    store: object  # backends.ProfileStore holding the run's profiles
    # its store holds a finch run's sketches or a dashing run's registers
    preclusterer: object


def run_cluster(args: argparse.Namespace) -> RunResult:
    """Build the backends from parsed `cluster` arguments, cluster, and
    write the requested outputs."""
    from galah_tpu_torch.backends import (
        FastANIEquivalentClusterer,
        HLLPreclusterer,
        HLLStore,
        MinHashPreclusterer,
        ProfileStore,
        SkaniEquivalentClusterer,
        SkaniPreclusterer,
        SketchStore,
    )
    from galah_tpu_torch.cluster.engine import cluster
    from galah_tpu_torch.device import resolve_device
    from galah_tpu_torch.outputs import write_cluster_definition
    from galah_tpu_torch.quality import quality_order_genomes
    from galah_tpu_torch.timing import StageClock

    device = resolve_device(args.device)
    clock = StageClock(device)
    with clock.stage("quality"):
        genomes, _ = quality_order_genomes(
            genome_paths(args), checkm_tab_table=args.checkm_tab_table,
            checkm2_quality_report=args.checkm2_quality_report,
            genome_info=args.genome_info, formula=args.quality_formula,
            min_completeness=args.min_completeness,
            max_contamination=args.max_contamination, threads=args.threads)
    ani = parse_percentage(args.ani, "--ani")
    precluster_ani = parse_percentage(args.precluster_ani,
                                      "--precluster-ani")
    min_af = parse_percentage(args.min_aligned_fraction,
                              "--min-aligned-fraction")
    # skani+skani: precluster at the final threshold (reference:
    # src/cluster_argument_parsing.rs:983-1030)
    if args.precluster_method == "skani" and args.cluster_method == "skani":
        precluster_ani = ani
    # opened before any compute, so a bad output path fails fast
    out = (open(args.output_cluster_definition, "w")
           if args.output_cluster_definition else None)
    store = ProfileStore(device, fraglen=args.fragment_length, clock=clock,
                         hash_algorithm=args.hash_algorithm,
                         threads=args.threads)
    if args.precluster_method == "finch":
        pre = MinHashPreclusterer(
            min_ani=precluster_ani,
            store=SketchStore(device, algo=args.hash_algorithm,
                              clock=clock), threads=args.threads)
    elif args.precluster_method == "dashing":
        pre = HLLPreclusterer(
            min_ani=precluster_ani,
            store=HLLStore(device, algo=args.hash_algorithm, clock=clock),
            threads=args.threads)
    else:
        pre = SkaniPreclusterer(threshold=precluster_ani,
                                min_aligned_fraction=min_af, store=store)
    if args.cluster_method == "fastani":
        cl = FastANIEquivalentClusterer(threshold=ani,
                                        min_aligned_fraction=min_af,
                                        store=store)
    else:
        cl = SkaniEquivalentClusterer(threshold=ani,
                                      min_aligned_fraction=min_af,
                                      store=store)
    try:
        logger.info("Clustering %d genomes on %s ..", len(genomes), device)
        clusters = cluster(genomes, pre, cl, device, clock=clock)
        logger.info("Found %d genome clusters", len(clusters))
        if out is not None:
            write_cluster_definition(out, clusters, genomes)
    finally:
        if out is not None:
            out.close()
    return RunResult(genomes=genomes, clusters=clusters, clock=clock,
                     store=store, preclusterer=pre)


def main(argv: Optional[Sequence[str]] = None) -> int:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="[%(asctime)s %(levelname)s] %(message)s")
    args = parse_args(argv)
    if args.subcommand != "cluster":
        build_parser().print_help()
        return 1
    try:
        run_cluster(args)
    except (ValueError, OSError) as e:
        logger.error("%s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
