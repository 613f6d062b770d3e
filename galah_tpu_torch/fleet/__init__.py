"""Fleet execution on the port: shard, supervise, merge. The port's
copy of ``galah_tpu/fleet/``.

``plan`` slices the quality-ordered genome set into self-describing
shard specs; ``scheduler`` supervises one ``python -m galah_tpu_torch
cluster`` worker subprocess per shard (preemption-aware, bounded
retries); ``merge`` recombines the shard checkpoints into clusters
byte-identical to a single-process run.

This module stays stdlib-only: the run report reads the snapshot below
(``obs/report.py``), and ``fleet status`` runs without torch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: the last fleet run's summary, the run report's ``fleet`` section
#: (cleared by ``obs.reset_run``)
_SNAPSHOT: Optional[Dict[str, Any]] = None


def set_snapshot(snap: Dict[str, Any]) -> None:
    global _SNAPSHOT
    _SNAPSHOT = dict(snap)


def snapshot() -> Optional[Dict[str, Any]]:
    return dict(_SNAPSHOT) if _SNAPSHOT is not None else None


def reset() -> None:
    global _SNAPSHOT
    _SNAPSHOT = None
