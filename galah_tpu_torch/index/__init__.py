"""The persistent versioned sketch index: the port of
``galah_tpu/index/``.

``store`` is the on-disk format (framed JSONL logs, generation
manifests, the commit pointer, fsck), byte for byte ``galah_tpu``'s, so
either package reads and writes the other's index directories;
``incremental`` is the update engine (build, insert, query, remove)
that re-derives the cluster engine's greedy decisions from the
persisted sketches and pairs. See ``docs/index.md``.

This module stays stdlib-only. ``galah_tpu``'s package also holds the
last operation's summary for its run report; the port has no run
report yet, and its operations return their summary instead.
"""

from __future__ import annotations

#: the environment variable that names the index directory when no
#: --index-dir is given
INDEX_DIR_ENV = "GALAH_TPU_INDEX_DIR"
