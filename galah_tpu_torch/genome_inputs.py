"""Genome input specification: -f / --genome-fasta-list / -d / -x.

The port's copy of ``galah_tpu/genome_inputs.py`` (reference:
docs/galah-cluster.html GENOME INPUT section, consumed via
parse_list_of_genome_fasta_files at src/cluster_argument_parsing.rs:414):
explicit files first, then the paths of a list file (one a line, blank
lines skipped), then a directory's entries with the extension, sorted.
At least one source must be given, and every path must be a regular
file, except under ``on_bad_genome="skip"``: there a path that is not
one is recorded in the quarantine manifest (reason ``missing``) and
dropped, and only a list with nothing left raises.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


def parse_genome_inputs(
    genome_fasta_files: Optional[Sequence[str]] = None,
    genome_fasta_list: Optional[str] = None,
    genome_fasta_directory: Optional[str] = None,
    genome_fasta_extension: str = "fna",
    on_bad_genome: str = "error",
    manifest=None,
) -> List[str]:
    """The genome paths of an input spec, in the order above; `manifest`
    (a ``resilience.quarantine.QuarantineManifest``) takes the missing
    ones under ``on_bad_genome="skip"``."""
    out: List[str] = []
    if genome_fasta_files:
        out.extend(genome_fasta_files)
    if genome_fasta_list:
        with open(genome_fasta_list) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(line)
    if genome_fasta_directory:
        suffix = "." + genome_fasta_extension.lstrip(".")
        entries = sorted(os.listdir(genome_fasta_directory))
        out.extend(
            os.path.join(genome_fasta_directory, e)
            for e in entries if e.endswith(suffix))
    if not out:
        raise ValueError(
            "No genome input specified: use --genome-fasta-files, "
            "--genome-fasta-list or --genome-fasta-directory")
    missing = [p for p in out if not os.path.isfile(p)]
    if missing and on_bad_genome == "skip":
        if manifest is not None:
            for p in missing:
                manifest.add(p, "missing", "not a regular file")
        dropped = set(missing)
        out = [p for p in out if p not in dropped]
        if not out:
            raise FileNotFoundError(
                "every input genome path is missing; nothing to cluster")
    elif missing:
        raise FileNotFoundError(
            f"Genome FASTA file(s) not found: {missing[:5]}")
    return out
