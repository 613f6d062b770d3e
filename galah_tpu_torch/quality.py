"""Genome quality: parsers, formulas, filtering and ordering.

The port's own copy of ``galah_tpu/quality.py`` and of the body of
``galah_tpu.api.quality_order_genomes``, whose port
(``galah_tpu_torch/api.py``) reads the inputs from flag values and
calls ``quality_order_genomes`` here (reference:
src/cluster_argument_parsing.rs:576-894, src/genome_info_file.rs:20-80):

* three inputs, keyed by the FASTA file's name without its last
  extension: a CheckM1 tab table, a CheckM2 quality report, a dRep-style
  genomeInfo CSV; completeness and contamination are read as percentages
  and kept as fractions;
* min-completeness / max-contamination filtering;
* four formulas, genomes ordered by descending score:
  - Parks2020_reduced (default): comp*100 - 5*cont*100
    - 5*num_contigs/100 - 5*num_ambiguous/1e5
  - completeness-4contamination: comp - 4*cont
  - completeness-5contamination: comp - 5*cont
  - dRep: comp*100 - 5*cont*100 + cont*strain_het + 0.5*log10(N50)
    (CheckM1 only, since it needs the strain heterogeneity)

The sort is stable: ties keep input order. The formulas that need
assembly stats read each genome once more, stats only
(``io/fasta.read_genome_stats``), on `threads` worker threads (the C
parser releases the interpreter lock); in a multi-process job each
rank reads its strided shard and the stats are exchanged
(``parallel/distributed.py``).
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from galah_tpu_torch.config import Defaults, parse_percentage
from galah_tpu_torch.io.fasta import GenomeStats, read_genome_stats
from galah_tpu_torch.obs.events import warn_once

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GenomeQuality:
    completeness: float                # fraction 0-1
    contamination: float               # fraction 0-1
    strain_heterogeneity: Optional[float] = None  # raw 0-100, CheckM1 only


QualityTable = Dict[str, GenomeQuality]


def fasta_stem(path: str) -> str:
    """The file name without its last extension: the table key."""
    return os.path.splitext(os.path.basename(path))[0]


def _read_quality_tsv(path: str, kind: str, name_header: str,
                      het_header: Optional[str]) -> QualityTable:
    """A TSV quality table: columns by header name, a genome named twice
    rejected, percentages kept as fractions."""
    out: QualityTable = {}
    with open(path, newline="") as fh:
        reader = csv.reader(fh, delimiter="\t")
        header = next(reader, None)
        if header is None:
            raise ValueError(f"empty {kind} {path}")
        try:
            name_col = header.index(name_header)
            comp_col = header.index("Completeness")
            cont_col = header.index("Contamination")
        except ValueError as e:
            raise ValueError(
                f"malformed {kind} header in {path}: {e}") from e
        het_col = (header.index(het_header)
                   if het_header and het_header in header else None)
        min_cols = max(name_col, comp_col, cont_col,
                       het_col if het_col is not None else 0) + 1
        for row in reader:
            if not row:
                continue
            if len(row) < min_cols:
                raise ValueError(
                    f"malformed {kind} row in {path}: expected at least "
                    f"{min_cols} columns, got {len(row)}: {row!r}")
            name = row[name_col]
            if name in out:
                raise ValueError(
                    f"The genome {name} was found multiple times in the "
                    f"checkm file {path}")
            out[name] = GenomeQuality(
                completeness=float(row[comp_col]) / 100.0,
                contamination=float(row[cont_col]) / 100.0,
                strain_heterogeneity=(
                    float(row[het_col]) if het_col is not None else None),
            )
    return out


def read_checkm1_tab_table(path: str) -> QualityTable:
    """CheckM v1 ``checkm qa`` tab table (Bin Id / Completeness /
    Contamination / Strain heterogeneity)."""
    return _read_quality_tsv(path, "CheckM tab table", "Bin Id",
                             "Strain heterogeneity")


def read_checkm2_quality_report(path: str) -> QualityTable:
    """CheckM2 quality_report.tsv: Name / Completeness / Contamination."""
    return _read_quality_tsv(path, "CheckM2 quality report", "Name", None)


def read_genome_info_file(path: str) -> QualityTable:
    """dRep-style CSV with exactly the headers
    genome,completeness,contamination."""
    out: QualityTable = {}
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader, None)
        if header != ["genome", "completeness", "contamination"]:
            raise ValueError("Incorrect headers found in genomeInfo file")
        for row in reader:
            if not row:
                continue
            if len(row) != 3:
                raise ValueError(
                    "Parsing error in genomeInfo file - didn't find 3 "
                    f"columns in line {row!r}")
            name = row[0]
            if name in out:
                raise ValueError(
                    f"The genome {name} was found multiple times in the "
                    f"checkm file {path}")
            out[name] = GenomeQuality(
                completeness=float(row[1]) / 100.0,
                contamination=float(row[2]) / 100.0,
            )
    return out


def retrieve(table: QualityTable, fasta_path: str) -> GenomeQuality:
    try:
        return table[fasta_stem(fasta_path)]
    except KeyError:
        raise KeyError(
            f"Failed to find CheckM statistics for {fasta_path}") from None


def _assembly_stats(paths: Sequence[str],
                    threads: int) -> Dict[str, GenomeStats]:
    """Each path's assembly stats, read on `threads` threads. In a
    multi-process job each rank reads its strided shard and the three
    integers a genome are exchanged, so every rank ranks from the same
    numbers; a rank whose reads fail makes every rank raise."""
    from galah_tpu_torch.parallel import distributed

    def read_all(ps: Sequence[str]) -> List[GenomeStats]:
        with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
            return list(pool.map(read_genome_stats, ps))

    if distributed.process_count() <= 1:
        return dict(zip(paths, read_all(paths)))
    mine = distributed.host_shard(list(paths))
    err = None
    local_stats: List[GenomeStats] = []
    try:
        local_stats = read_all(mine)
    except Exception as e:  # re-raised on every rank below
        err = e
    distributed.raise_if_any_host_failed(err)
    local = np.array([[s.num_contigs, s.num_ambiguous_bases, s.n50]
                      for s in local_stats],
                     dtype=np.int64).reshape(len(mine), 3)
    full = distributed.allgather_host_rows(len(paths), local,
                                           fill=np.int64(0))
    return {p: GenomeStats(num_contigs=int(full[i, 0]),
                           num_ambiguous_bases=int(full[i, 1]),
                           n50=int(full[i, 2]))
            for i, p in enumerate(paths)}


def filter_and_order_genomes(
    genome_paths: Sequence[str],
    table: QualityTable,
    formula: str = Defaults.QUALITY_FORMULA,
    min_completeness: Optional[float] = None,   # fraction
    max_contamination: Optional[float] = None,  # fraction
    threads: int = 1,
) -> List[str]:
    """Filter by the quality thresholds, then order by descending
    score. The Parks2020_reduced and dRep formulas read each kept
    genome's assembly stats, on `threads` threads."""
    kept: List[str] = []
    for p in genome_paths:
        q = retrieve(table, p)
        if (min_completeness is not None
                and q.completeness < min_completeness):
            continue
        if (max_contamination is not None
                and q.contamination > max_contamination):
            continue
        kept.append(p)

    stats: Dict[str, GenomeStats] = {}
    if formula in ("Parks2020_reduced", "dRep") and kept:
        stats = _assembly_stats(kept, threads)

    def score(p: str) -> float:
        q = retrieve(table, p)
        if formula == "completeness-4contamination":
            return q.completeness - 4.0 * q.contamination
        if formula == "completeness-5contamination":
            return q.completeness - 5.0 * q.contamination
        if formula == "Parks2020_reduced":
            s = stats[p]
            return (q.completeness * 100.0
                    - 5.0 * q.contamination * 100.0
                    - 5.0 * s.num_contigs / 100.0
                    - 5.0 * s.num_ambiguous_bases / 100000.0)
        if formula == "dRep":
            if q.strain_heterogeneity is None:
                raise ValueError(
                    "dRep quality formula only works with CheckM v1 "
                    "quality scoring since it includes strain heterogeneity")
            s = stats[p]
            return (q.completeness * 100.0
                    - 5.0 * q.contamination * 100.0
                    + q.contamination * q.strain_heterogeneity
                    + 0.5 * math.log10(max(s.n50, 1)))
        raise ValueError(f"unknown quality formula {formula!r}")

    scored = [(p, score(p)) for p in kept]
    scored.sort(key=lambda t: -t[1])  # stable: ties keep input order
    logger.info(
        "Read in genome qualities for %d genomes. %d passed quality "
        "thresholds", len(table), len(scored))
    return [p for p, _ in scored]


def quality_order_genomes(
    genome_paths: Sequence[str],
    checkm_tab_table: Optional[str] = None,
    checkm2_quality_report: Optional[str] = None,
    genome_info: Optional[str] = None,
    formula: Optional[str] = None,
    min_completeness: Optional[float] = None,   # percent or fraction
    max_contamination: Optional[float] = None,  # percent or fraction
    threads: int = 1,
    missing_msg: str = ("Since CheckM input is missing, genomes are not "
                        "being ordered by quality. Instead the order of "
                        "their input is being used"),
    missing_key: str = "checkm-input-missing",
    min_completeness_flag: str = "--min-completeness",
    max_contamination_flag: str = "--max-contamination",
) -> Tuple[List[str], bool]:
    """(ordered paths, whether a quality input was used). With no
    quality input the paths keep their input order and `missing_msg` is
    warned once a process under `missing_key` (``obs/events.warn_once``).
    More than one input, or dRep with --genome-info, is a ValueError; a
    filter out of range is one that names its flag as given."""
    given = [(kind, path) for kind, path in (
        ("checkm_tab_table", checkm_tab_table),
        ("checkm2_quality_report", checkm2_quality_report),
        ("genome_info", genome_info)) if path]
    if len(given) > 1:
        raise ValueError(
            "Specify at most one of --checkm-tab-table, "
            "--checkm2-quality-report and --genome-info")
    if not given:
        warn_once(logger, missing_msg, key=missing_key)
        return list(genome_paths), False
    kind, path = given[0]
    formula = formula or Defaults.QUALITY_FORMULA
    if kind == "checkm_tab_table":
        logger.info("Reading CheckM tab table ..")
        table = read_checkm1_tab_table(path)
    elif kind == "checkm2_quality_report":
        logger.info("Reading CheckM2 Quality report ..")
        table = read_checkm2_quality_report(path)
    else:
        if formula == "dRep":
            raise ValueError(
                "The dRep quality formula cannot be used with "
                "--genome-info")
        table = read_genome_info_file(path)
    ordered = filter_and_order_genomes(
        list(genome_paths), table, formula=formula,
        min_completeness=(parse_percentage(
            min_completeness, min_completeness_flag)
            if min_completeness is not None else None),
        max_contamination=(parse_percentage(
            max_contamination, max_contamination_flag)
            if max_contamination is not None else None),
        threads=threads)
    return ordered, True
