"""Bad-input quarantine: the port's copy of
``galah_tpu/resilience/quarantine.py``.

Under ``--on-bad-genome skip`` every genome is read once before
quality ordering; the unreadable ones (missing, empty, corrupt, or an
IO error that outlived the read's retries) go into a manifest,
``quarantine.json`` next to the outputs, and the rest are clustered
exactly as a run that never saw the bad ones. The records and the
manifest's bytes are ``galah_tpu``'s.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

from galah_tpu_torch.io import atomic
from galah_tpu_torch.io.prefetch import iter_prefetched
from galah_tpu_torch.obs import events as obs_events

logger = logging.getLogger(__name__)

MANIFEST_NAME = "quarantine.json"

ON_BAD_GENOME_CHOICES = ("error", "skip")


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    path: str
    reason: str      # "missing" | "empty" | "corrupt" | "io-error"
    detail: str = ""
    stage: str = "preflight"


class QuarantineManifest:
    """The run's quarantined genomes; written as ``quarantine.json``."""

    def __init__(self) -> None:
        self._records: List[QuarantineRecord] = []

    def __len__(self) -> int:
        return len(self._records)

    def add(self, path: str, reason: str, detail: str = "",
            stage: str = "preflight") -> None:
        self._records.append(QuarantineRecord(
            path=path, reason=reason, detail=detail, stage=stage))
        logger.warning("Quarantined genome %s (%s%s)", path, reason,
                       f": {detail}" if detail else "")

    def records(self) -> List[QuarantineRecord]:
        return list(self._records)

    def write(self, directory: str) -> str:
        """Write the manifest into `directory`; returns its path."""
        out = os.path.join(directory or ".", MANIFEST_NAME)
        atomic.write_json(out, {
            "version": 1,
            "quarantined": [dataclasses.asdict(r) for r in self._records],
        }, indent=2, site="io.atomic.write[quarantine]")
        logger.warning("Wrote quarantine manifest (%d genomes) to %s",
                       len(self._records), out)
        return out

    @classmethod
    def load(cls, path: str) -> "QuarantineManifest":
        with open(path) as f:
            data = json.load(f)
        m = cls()
        for rec in data.get("quarantined", []):
            m._records.append(QuarantineRecord(**rec))
        return m


def validate_genome(path: str) -> Optional[Tuple[str, str]]:
    """None when `path` reads as a FASTA genome, else (reason, detail).
    The read is the pipeline's own (C parser, IO retries), so whatever
    would fail later fails here."""
    from galah_tpu_torch.io.fasta import (CORRUPT_GZIP_ERRORS,
                                         BadGenomeError, read_genome_stats)

    try:
        read_genome_stats(path)
        return None
    except FileNotFoundError as e:
        return "missing", str(e)
    except BadGenomeError as e:
        return e.reason, str(e)
    except CORRUPT_GZIP_ERRORS as e:  # before OSError: BadGzipFile is one
        return "corrupt", str(BadGenomeError(path, "corrupt", str(e)))
    except OSError as e:  # a lasting IO failure, after the retries
        return "io-error", f"{type(e).__name__}: {e}"


def preflight_quarantine(
    genome_paths: Sequence[str],
    manifest: Optional[QuarantineManifest] = None,
    validate: Callable[[str], Optional[Tuple[str, str]]] = validate_genome,
    threads: int = 1,
    clock=None,
) -> Tuple[List[str], QuarantineManifest]:
    """Validate every genome, `threads` reads at a time; returns (the
    kept paths, the manifest), both in input order; each quarantined
    genome is a ``quarantine`` event. With a ``timing.StageClock``,
    the preflight is stage ``preflight-genomes`` and the count
    ``quarantined-genomes``."""
    manifest = manifest if manifest is not None else QuarantineManifest()
    unique = list(dict.fromkeys(genome_paths))
    verdicts = iter_prefetched(unique, validate, depth=threads)
    if clock is not None:
        with clock.stage("preflight-genomes"):
            verdicts = list(verdicts)
    dropped = set()
    for path, verdict in verdicts:
        if verdict is not None:
            manifest.add(path, *verdict)
            dropped.add(path)
            reason, detail = verdict
            obs_events.record("quarantine", genome=path, reason=reason,
                              detail=detail)
    if clock is not None:
        clock.count("quarantined-genomes", len(dropped))
    return [p for p in genome_paths if p not in dropped], manifest


def manifest_output_dir(cluster_definition: Optional[str] = None,
                        representative_list: Optional[str] = None,
                        checkpoint_dir: Optional[str] = None) -> str:
    """"Next to the outputs": the cluster definition's directory, else
    the representative list's, else the checkpoint directory, else the
    working directory."""
    for anchor in (cluster_definition, representative_list):
        if anchor:
            return os.path.dirname(os.path.abspath(anchor))
    if checkpoint_dir:
        return checkpoint_dir
    return "."
