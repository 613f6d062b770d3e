"""Output writing: the port's copy of ``galah_tpu/outputs.py``.

Output files are opened and directories created before clustering, so
a bad path fails before any compute (reference:
src/cluster_argument_parsing.rs:367-562). The cluster definition holds
one ``rep<TAB>member`` line per genome, each cluster's representative
first; representative FASTAs are symlinked (to their real path) or
copied into output directories, a clashing file name renamed with
``.1.fna``, ``.2.fna`` and so on; the representative list holds one
path a line. ``read_cluster_file`` parses a cluster definition back.
In a multi-process job only rank 0 opens and writes the outputs; the
other ranks check the same paths without touching them
(``validate_output_paths``), so that a bad path fails every rank before
the first exchange.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from typing import List, Optional, Sequence, TextIO

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class OutputHandles:
    cluster_definition: Optional[TextIO] = None
    representative_fasta_directory: Optional[str] = None
    representative_fasta_directory_copy: Optional[str] = None
    representative_list: Optional[TextIO] = None

    def close(self) -> None:
        for fh in (self.cluster_definition, self.representative_list):
            if fh is not None:
                fh.close()


def _setup_directory(path: Optional[str], argument: str) -> Optional[str]:
    """Create the output directory, or accept an empty one that exists;
    fail otherwise (reference: src/cluster_argument_parsing.rs:488-522)."""
    if path is None:
        return None
    if os.path.exists(path):
        if not os.path.isdir(path):
            raise ValueError(
                f"The {argument} path specified ({path}) exists but is "
                "not a directory")
        if os.listdir(path):
            raise ValueError(
                f"The {argument} specified ({path}) exists and is not "
                "empty")
        logger.info("Using pre-existing but empty %s", argument)
    else:
        logger.info("Creating %s ..", argument)
        os.makedirs(path, exist_ok=True)
    return path


def _nearest_existing_dir(path: str) -> str:
    """The closest existing ancestor of `path` (``os.makedirs`` would
    create everything below it)."""
    d = os.path.abspath(path)
    while not os.path.exists(d):
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return d


def validate_output_paths(
    cluster_definition: Optional[str] = None,
    representative_fasta_directory: Optional[str] = None,
    representative_fasta_directory_copy: Optional[str] = None,
    representative_list: Optional[str] = None,
) -> None:
    """``setup_outputs``' checks, case for case, without touching the
    targets: a file output needs an existing, writable parent and must
    not be a directory; a directory output must be empty if it exists,
    else creatable (its nearest existing ancestor writable)."""
    for p in (cluster_definition, representative_list):
        if p:
            if os.path.isdir(p):
                raise ValueError(f"output path {p} is a directory")
            d = os.path.dirname(os.path.abspath(p)) or "."
            if not os.path.isdir(d) or not os.access(d, os.W_OK):
                raise OSError(f"output path not writable: {p}")
            if os.path.exists(p) and not os.access(p, os.W_OK):
                raise OSError(f"output file not writable: {p}")
    for p, argument in (
            (representative_fasta_directory,
             "output-representative-fasta-directory"),
            (representative_fasta_directory_copy,
             "output-representative-fasta-directory-copy")):
        if not p:
            continue
        if os.path.exists(p):
            if not os.path.isdir(p):
                raise ValueError(
                    f"The {argument} path specified ({p}) exists but "
                    "is not a directory")
            if os.listdir(p):
                raise ValueError(
                    f"The {argument} specified ({p}) exists and is "
                    "not empty")
        else:
            anc = _nearest_existing_dir(p)
            if not os.path.isdir(anc) or not os.access(anc, os.W_OK):
                raise OSError(f"output directory not creatable: {p}")


def setup_outputs(
    cluster_definition: Optional[str] = None,
    representative_fasta_directory: Optional[str] = None,
    representative_fasta_directory_copy: Optional[str] = None,
    representative_list: Optional[str] = None,
) -> OutputHandles:
    """Open the files and create the directories before compute."""
    handles = OutputHandles()
    try:
        if cluster_definition:
            handles.cluster_definition = open(cluster_definition, "w")
        handles.representative_fasta_directory = _setup_directory(
            representative_fasta_directory,
            "output-representative-fasta-directory")
        handles.representative_fasta_directory_copy = _setup_directory(
            representative_fasta_directory_copy,
            "output-representative-fasta-directory-copy")
        if representative_list:
            handles.representative_list = open(representative_list, "w")
    except BaseException:
        handles.close()
        raise
    return handles


def _write_reps_to_directory(
    clusters: Sequence[Sequence[int]],
    genomes: Sequence[str],
    directory: Optional[str],
    copy: bool,
) -> None:
    if directory is None:
        return
    some_names_clashed = False
    for cluster in clusters:
        rep = genomes[cluster[0]]
        src = os.path.realpath(rep)
        basename = os.path.basename(rep)
        target = os.path.join(directory, basename)
        counter = 0
        while os.path.lexists(target):
            if not some_names_clashed:
                logger.warning(
                    "One or more sequence files have the same file name. "
                    "Renaming clashes by adding .1.fna, .2.fna etc.")
                some_names_clashed = True
            counter += 1
            target = os.path.join(directory, f"{basename}.{counter}.fna")
        if copy:
            shutil.copy(src, target)
        else:
            os.symlink(src, target)


def write_outputs(
    handles: OutputHandles,
    clusters: Sequence[Sequence[int]],
    genomes: Sequence[str],
) -> None:
    """Write every requested output and close the files (reference:
    src/cluster_argument_parsing.rs:432-485)."""
    if handles.cluster_definition is not None:
        for cluster in clusters:
            rep = genomes[cluster[0]]
            for genome_index in cluster:
                handles.cluster_definition.write(
                    f"{rep}\t{genomes[genome_index]}\n")
        handles.cluster_definition.close()

    _write_reps_to_directory(
        clusters, genomes, handles.representative_fasta_directory, copy=False)
    _write_reps_to_directory(
        clusters, genomes, handles.representative_fasta_directory_copy,
        copy=True)

    if handles.representative_list is not None:
        for cluster in clusters:
            handles.representative_list.write(f"{genomes[cluster[0]]}\n")
        handles.representative_list.close()


def read_cluster_file(path: str) -> List[List[str]]:
    """A cluster definition TSV as clusters of paths; a line whose rep
    equals its member starts a cluster (reference:
    src/cluster_validation.rs:80-113)."""
    clusters: List[List[str]] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            rep, member = line.split("\t")
            if rep == member:
                clusters.append([member])
            else:
                if not clusters:
                    raise ValueError(
                        f"malformed cluster file {path}: member line "
                        "before any representative line")
                clusters[-1].append(member)
    return clusters
