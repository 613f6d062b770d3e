"""Deterministic shard planning for fleet execution: the port's copy of
``galah_tpu/fleet/plan.py``.

The quality-ordered genome set is sliced into ``n_shards`` contiguous
spans (sizes differing by at most one), so each shard's local greedy
pass sees the intra-shard quality order a single-process run would, and
the merge can replay the global order from the shards' ``lo`` offsets.
``fleet_plan.json`` stores the run-configuration fields verbatim beside
their sha256 fingerprint (``cluster/checkpoint.fields_digest``), so a
resume under other inputs is refused naming the fields that changed.
Its bytes are ``galah_tpu``'s for the same genomes, flags and shard
count.

``load_plan`` and ``ShardSpec`` import neither torch nor numpy, so
``fleet status`` renders with neither; the digest and the durable write
are imported inside the writers.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

PLAN_FILENAME = "fleet_plan.json"
EVENTS_FILENAME = "fleet_events.jsonl"


@dataclass(frozen=True)
class ShardSpec:
    """One contiguous quality-order slice, genomes[lo:hi] by global
    index, holding the path strings as given: outputs echo them, and
    realpaths live only inside fingerprints."""

    shard_id: int
    lo: int
    hi: int
    genomes: Tuple[str, ...]

    def to_dict(self) -> Dict[str, Any]:
        return {"shard_id": self.shard_id, "lo": self.lo,
                "hi": self.hi, "genomes": list(self.genomes)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ShardSpec":
        return ShardSpec(shard_id=int(d["shard_id"]), lo=int(d["lo"]),
                         hi=int(d["hi"]), genomes=tuple(d["genomes"]))


def build_plan(genomes: Sequence[str], n_shards: int) -> List[ShardSpec]:
    """Contiguous quality-order slices whose sizes differ by at most
    one; empty shards are dropped (n_shards > len(genomes) is legal)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n = len(genomes)
    shards: List[ShardSpec] = []
    base, extra = divmod(n, n_shards)
    lo = 0
    for k in range(n_shards):
        hi = lo + base + (1 if k < extra else 0)
        if hi > lo:
            shards.append(ShardSpec(shard_id=len(shards), lo=lo, hi=hi,
                                    genomes=tuple(genomes[lo:hi])))
        lo = hi
    return shards


def plan_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, PLAN_FILENAME)


def events_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, EVENTS_FILENAME)


def shard_dir(fleet_dir: str, shard_id: int) -> str:
    return os.path.join(fleet_dir, "shards", f"shard_{shard_id:03d}")


def save_plan(fleet_dir: str, fields: Dict[str, Any],
              shards: Sequence[ShardSpec]) -> None:
    from galah_tpu_torch.cluster.checkpoint import fields_digest
    from galah_tpu_torch.io import atomic

    os.makedirs(fleet_dir, exist_ok=True)
    atomic.write_json(plan_path(fleet_dir), {
        "fingerprint": fields_digest(fields),
        "fields": fields,
        "shards": [s.to_dict() for s in shards],
    }, site="fleet-plan")


def load_plan(fleet_dir: str) -> Optional[Dict[str, Any]]:
    """The stored plan document, or None when it is missing or
    unreadable (a torn plan is no plan: ``ensure_plan`` rebuilds it)."""
    try:
        with open(plan_path(fleet_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _mismatched_fields(stored: Dict[str, Any],
                       current: Dict[str, Any]) -> List[str]:
    return [k for k in sorted(set(stored) | set(current))
            if stored.get(k) != current.get(k)]


def ensure_plan(fleet_dir: str, genomes: Sequence[str],
                fields: Dict[str, Any], n_shards: int,
                require_match: bool = False) -> List[ShardSpec]:
    """Load or create the shard plan, bound to the run's fingerprint.

    ``fields`` is ``cluster/checkpoint.fingerprint_fields``' dict, with
    ``n_shards`` folded in (another shard layout invalidates the shard
    checkpoints' genome subsets). On a mismatch, ``require_match``
    (``--resume``) raises ValueError naming the fields that differ;
    otherwise the stale plan and event log are dropped and a fresh plan
    is written (shard checkpoints reset themselves through their own
    fingerprints)."""
    from galah_tpu_torch.cluster.checkpoint import fields_digest

    plan_fields = dict(fields)
    plan_fields["n_shards"] = n_shards
    fingerprint = fields_digest(plan_fields)
    stored = load_plan(fleet_dir)
    if stored is not None:
        if stored.get("fingerprint") == fingerprint:
            return [ShardSpec.from_dict(d)
                    for d in stored.get("shards", [])]
        diffs = _mismatched_fields(stored.get("fields") or {},
                                   plan_fields)
        if require_match:
            raise ValueError(
                f"--resume: fleet plan at {plan_path(fleet_dir)} "
                f"belongs to a different run configuration "
                f"(mismatched fields: {', '.join(diffs) or '<unknown>'})")
        logger.warning(
            "Fleet plan at %s belongs to a different run configuration "
            "(mismatched fields: %s); starting fresh",
            plan_path(fleet_dir), ", ".join(diffs) or "<unknown>")
        for path in (plan_path(fleet_dir), events_path(fleet_dir)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
    elif require_match:
        raise ValueError(
            f"--resume: no fleet plan at {plan_path(fleet_dir)}")
    shards = build_plan(genomes, n_shards)
    save_plan(fleet_dir, plan_fields, shards)
    return shards
