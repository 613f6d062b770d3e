"""The persistent versioned sketch index: the port of
``galah_tpu/index/``.

``store`` is the on-disk format (framed JSONL logs, generation
manifests, the commit pointer, fsck), byte for byte ``galah_tpu``'s, so
either package reads and writes the other's index directories;
``incremental`` is the update engine (build, insert, query, remove)
that re-derives the cluster engine's greedy decisions from the
persisted sketches and pairs. See ``docs/index.md``.

This module stays stdlib-only: the run report reads the last
operation's summary below (``obs/report.py``), as ``galah_tpu``'s does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: the environment variable that names the index directory when no
#: --index-dir is given
INDEX_DIR_ENV = "GALAH_TPU_INDEX_DIR"

#: the last index operation's summary, the run report's ``index``
#: section (cleared by ``obs.reset_run``)
_SNAPSHOT: Optional[Dict[str, Any]] = None


def set_snapshot(snap: Dict[str, Any]) -> None:
    global _SNAPSHOT
    _SNAPSHOT = dict(snap)


def snapshot() -> Optional[Dict[str, Any]]:
    return dict(_SNAPSHOT) if _SNAPSHOT is not None else None


def reset() -> None:
    global _SNAPSHOT
    _SNAPSHOT = None
