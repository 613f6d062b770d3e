"""The cluster definition TSV (``galah_tpu/outputs.py``'s format): one
``rep<TAB>member`` line per genome, each cluster's representative
first (reference: src/cluster_argument_parsing.rs:432-485)."""

from __future__ import annotations

from typing import Sequence, TextIO


def write_cluster_definition(fh: TextIO,
                             clusters: Sequence[Sequence[int]],
                             genomes: Sequence[str]) -> None:
    for cluster in clusters:
        rep = genomes[cluster[0]]
        for genome_index in cluster:
            fh.write(f"{rep}\t{genomes[genome_index]}\n")
