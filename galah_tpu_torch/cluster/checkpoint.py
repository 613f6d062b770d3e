"""Checkpoint and resume of a clustering run: the port's copy of
``galah_tpu/cluster/checkpoint.py``.

Under one directory, the expensive state persists as it is made:

1. ``precluster_distances.npz``: the precluster distance pass, once it
   completes (arrays ``ii, jj, vals, has_val``);
2. ``greedy_rounds.jsonl``: the pairs each greedy round sent to the
   backend, with their ANIs, bound to a digest of the pending
   preclusters; a resume replays them and re-derives every decision
   without computing them again;
3. ``clusters.jsonl``: each precluster's finished clusters;
4. ``interruptions.jsonl``: one record a cooperative stop.

A checkpoint is bound to a fingerprint of everything that shapes the
result: the genome paths (realpath-normalized) in quality order, the
tool version, the methods, the thresholds and the sketch settings
(``backend_params``). A checkpoint of another configuration is
dropped (or, with ``require_match``, refused). File names, fields and
bytes are ``galah_tpu``'s, and the port's version and backend settings
equal its own, so either package resumes the other's checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from galah_tpu_torch import __version__
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.io import atomic

logger = logging.getLogger(__name__)

_FINGERPRINT = "fingerprint.json"
_DISTANCES = "precluster_distances.npz"
_CLUSTERS = "clusters.jsonl"
_GREEDY = "greedy_rounds.jsonl"
_INTERRUPTIONS = "interruptions.jsonl"


def fingerprint_fields(genomes: Sequence[str], precluster_method: str,
                       cluster_method: str, ani: float,
                       precluster_ani: float,
                       min_aligned_fraction: float = 0.0,
                       fragment_length: int = 0,
                       backend_params: Optional[dict] = None
                       ) -> Dict[str, Any]:
    """The fields the fingerprint hashes, also stored in
    ``fingerprint.json`` so a mismatch can name the field that changed.
    Paths are realpath-normalized: ``./a.fna``, ``a.fna`` and an
    absolute path to the same file give the same fingerprint."""
    return {
        "version": __version__,
        "genomes": [os.path.realpath(g) for g in genomes],
        "precluster_method": precluster_method,
        "cluster_method": cluster_method,
        "ani": ani,
        "precluster_ani": precluster_ani,
        "min_aligned_fraction": min_aligned_fraction,
        "fragment_length": fragment_length,
        "backend_params": backend_params or {},
    }


def fields_digest(fields: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(fields, sort_keys=True).encode()).hexdigest()


def run_fingerprint(genomes: Sequence[str], precluster_method: str,
                    cluster_method: str, ani: float, precluster_ani: float,
                    min_aligned_fraction: float = 0.0,
                    fragment_length: int = 0,
                    backend_params: Optional[dict] = None) -> str:
    """The digest of ``fingerprint_fields``."""
    return fields_digest(fingerprint_fields(
        genomes, precluster_method, cluster_method, ani, precluster_ani,
        min_aligned_fraction, fragment_length, backend_params))


class ClusterCheckpoint:
    """One run's resumable state under `path` (None disables it: every
    method is then a no-op)."""

    def __init__(self, path: Optional[str], fingerprint: str,
                 fields: Optional[Dict[str, Any]] = None,
                 require_match: bool = False) -> None:
        self.path = path
        self.fingerprint = fingerprint
        self.fields = fields
        self.matched_existing = False
        if not path:
            return
        os.makedirs(path, exist_ok=True)
        # a killed writer leaves .tmp debris; the directory has one owner
        atomic.sweep_tmp(path)
        fp_file = os.path.join(path, _FINGERPRINT)
        stored: Dict[str, Any] = {}
        if os.path.exists(fp_file):
            try:
                with open(fp_file) as f:
                    stored = json.load(f)
            except (OSError, ValueError):
                stored = {}
            existing = stored.get("fingerprint")
            if existing == fingerprint:
                self.matched_existing = True
            else:
                self._log_mismatch(stored.get("fields"))
                if require_match:
                    raise ValueError(
                        f"--resume: checkpoint at {path} belongs to a "
                        f"different run configuration (fingerprint "
                        f"{existing!r} != {fingerprint!r})")
                for name in (_FINGERPRINT, _DISTANCES, _CLUSTERS, _GREEDY,
                             _INTERRUPTIONS):
                    try:
                        os.unlink(os.path.join(path, name))
                    except FileNotFoundError:
                        pass
        elif require_match:
            raise ValueError(
                f"--resume: no checkpoint fingerprint at {path}")
        if (not self.matched_existing
                or (fields is not None and stored.get("fields") != fields)):
            atomic.write_json(fp_file, {"fingerprint": fingerprint,
                                        "fields": fields})

    def _log_mismatch(self, stored_fields: Optional[Dict[str, Any]]) -> None:
        """Name the fields that differ."""
        if stored_fields and self.fields:
            diffs = [k for k in sorted(set(stored_fields) | set(self.fields))
                     if stored_fields.get(k) != self.fields.get(k)]
            logger.warning(
                "Checkpoint at %s belongs to a different run configuration "
                "(mismatched fields: %s); starting fresh", self.path,
                ", ".join(diffs) or "<unknown>")
            for k in diffs:
                logger.warning("  %s: checkpoint=%r, run=%r", k,
                               stored_fields.get(k), self.fields.get(k))
        else:
            logger.warning("Checkpoint at %s belongs to a different run "
                           "configuration; starting fresh", self.path)

    @property
    def enabled(self) -> bool:
        return self.path is not None

    # -- the precluster distance pass ------------------------------------

    def load_distances(self) -> Optional[PairDistanceCache]:
        if not self.enabled:
            return None
        fn = os.path.join(self.path, _DISTANCES)
        if not os.path.exists(fn):
            return None
        with np.load(fn) as z:
            ii, jj = z["ii"], z["jj"]
            vals, has_val = z["vals"], z["has_val"]
        cache = PairDistanceCache()
        for i, j, v, hv in zip(ii.tolist(), jj.tolist(), vals.tolist(),
                               has_val.tolist()):
            cache.insert((i, j), float(v) if hv else None)
        logger.info("Resumed precluster distances from checkpoint "
                    "(%d pairs)", len(cache))
        return cache

    def save_distances(self, cache: PairDistanceCache) -> None:
        if not self.enabled:
            return
        keys = sorted(cache.keys())
        ii = np.array([k[0] for k in keys], dtype=np.int64)
        jj = np.array([k[1] for k in keys], dtype=np.int64)
        has_val = np.array([cache.get(k) is not None for k in keys],
                           dtype=bool)
        vals = np.array([cache.get(k) or 0.0 for k in keys],
                        dtype=np.float64)
        atomic.write_npz(os.path.join(self.path, _DISTANCES),
                         {"ii": ii, "jj": jj, "vals": vals,
                          "has_val": has_val},
                         site="io.atomic.write[ckpt.distances]")
        logger.info("Checkpointed precluster distances (%d pairs)",
                    len(cache))

    # -- finished preclusters ----------------------------------------------

    def load_completed(self) -> Dict[int, List[List[int]]]:
        """{precluster index: its clusters (global genome ids)}."""
        out: Dict[int, List[List[int]]] = {}
        if not self.enabled:
            return out
        fn = os.path.join(self.path, _CLUSTERS)
        records, bad = atomic.read_jsonl(fn)
        if bad:
            # a torn tail from a kill mid-write: that precluster is
            # computed again
            logger.warning("Dropped %d torn checkpoint record(s) (torn "
                           "tail or corrupt frame) in %s", bad, fn)
        for rec in records:
            out[int(rec["precluster"])] = rec["clusters"]
        if out:
            logger.info("Resuming: %d preclusters already clustered",
                        len(out))
        return out

    def save_precluster(self, index: int, clusters: List[List[int]]) -> None:
        if not self.enabled:
            return
        atomic.append_jsonl(os.path.join(self.path, _CLUSTERS),
                            {"precluster": index, "clusters": clusters},
                            site="io.atomic.append[ckpt.clusters]")

    # -- greedy rounds -----------------------------------------------------
    #
    # The rounds are deterministic given the ANI values, so a round's
    # record holds only the (i, j, ani) triples the backend computed in
    # it, bound to the digest of the pending preclusters
    # (engine._greedy_digest); records of another digest are ignored.

    def load_greedy_rounds(self, digest: str
                           ) -> List[Tuple[int, int, Optional[float]]]:
        """Every (i, j, ani or None) recorded for `digest`."""
        out: List[Tuple[int, int, Optional[float]]] = []
        if not self.enabled:
            return out
        fn = os.path.join(self.path, _GREEDY)
        records, bad = atomic.read_jsonl(fn)
        if bad:
            # a torn tail from a kill mid-write: that round's pairs are
            # computed again
            logger.warning("Dropped %d torn/corrupt greedy-round "
                           "record(s) in %s", bad, fn)
        for rec in records:
            if rec.get("digest") != digest:
                continue
            for i, j, ani in rec["pairs"]:
                out.append((int(i), int(j),
                            float(ani) if ani is not None else None))
        if out:
            logger.info("Resuming: replaying %d greedy-round ANI pairs",
                        len(out))
        return out

    def save_greedy_round(self, digest: str,
                          pairs: List[Tuple[int, int, Optional[float]]]
                          ) -> None:
        if not self.enabled:
            return
        atomic.append_jsonl(
            os.path.join(self.path, _GREEDY),
            {"digest": digest,
             "pairs": [[i, j, ani] for i, j, ani in pairs]},
            site="io.atomic.append[ckpt.greedy]")

    def clear_greedy_rounds(self) -> None:
        """Drop the round log once its preclusters are all in the
        clusters log."""
        if not self.enabled:
            return
        try:
            os.unlink(os.path.join(self.path, _GREEDY))
        except FileNotFoundError:
            pass

    # -- interruptions -----------------------------------------------------

    def record_interruption(self, info: Dict[str, Any]) -> None:
        """One record a cooperative stop, appended by the CLI as it
        exits with ``EXIT_PREEMPTED``."""
        if not self.enabled:
            return
        atomic.append_jsonl(os.path.join(self.path, _INTERRUPTIONS), info,
                            site="io.atomic.append[ckpt.interrupts]")

    def load_interruptions(self) -> List[Dict[str, Any]]:
        if not self.enabled:
            return []
        records, bad = atomic.read_jsonl(
            os.path.join(self.path, _INTERRUPTIONS))
        if bad:
            logger.warning("Dropped %d torn interruption record(s) in %s",
                           bad, self.path)
        return records
