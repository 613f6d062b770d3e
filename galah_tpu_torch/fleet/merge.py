"""The cross-shard merge: shard pair caches, cross pairs, replay. The
port's copy of ``galah_tpu/fleet/merge.py``.

Why the merge equals a single-process run byte for byte:

* the skani pair pipeline does not depend on which other genomes are in
  the run: a pair's exact ANI depends only on its two genomes' fragment
  profiles, and the marker screen is a per-pair predicate, so a shard's
  ``distances()`` gives its intra-shard pairs the values a full run
  would (and the CLI's skani/skani gate thresholds every shard at the
  final ANI, so a shard's cache is the full run's cache restricted to
  that shard);
* the cross-shard pairs are computed here through the same profile,
  screen and exact-ANI path, filtered to cross pairs
  (``SkaniPreclusterer.distances_subset``);
* their union, remapped to global quality-order indices by each shard's
  ``lo``, is the full run's pair cache, and replaying the greedy engine
  over it (``index/incremental.screen_new_genomes`` and
  ``clusters_from_state``) reproduces ``cluster/engine.py``'s
  decisions.

A merge of shard representatives alone is not used: a shard's local rep
that globally joins an earlier rep can locally absorb a genome that
globally becomes a rep of its own, so only the full-pair replay is
safe.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from galah_tpu_torch.fleet import scheduler as fleet_scheduler
from galah_tpu_torch.fleet.plan import ShardSpec

logger = logging.getLogger(__name__)


def shard_lookup(shards: Sequence[ShardSpec]) -> Callable[[int], int]:
    """Global genome index -> shard id (contiguous spans)."""
    bounds = [(s.lo, s.hi, s.shard_id) for s in shards]

    def lookup(g: int) -> int:
        for lo, hi, sid in bounds:
            if lo <= g < hi:
                return sid
        raise IndexError(f"genome index {g} outside every shard")

    return lookup


def load_shard_pairs(fleet_dir: str, shards: Sequence[ShardSpec]
                     ) -> Dict[Tuple[int, int], float]:
    """The union of the shard checkpoints' distance caches, remapped
    from shard-local to global indices by each shard's ``lo``."""
    pairs: Dict[Tuple[int, int], float] = {}
    for s in shards:
        path = fleet_scheduler.shard_distances_path(fleet_dir, s.shard_id)
        with np.load(path) as z:
            ii, jj = z["ii"], z["jj"]
            vals, has_val = z["vals"], z["has_val"]
        kept = 0
        for i, j, v, hv in zip(ii.tolist(), jj.tolist(), vals.tolist(),
                               has_val.tolist()):
            if not hv:
                continue
            pairs[(i + s.lo, j + s.lo)] = float(v)
            kept += 1
        logger.info("fleet merge: shard %d contributed %d pair(s)",
                    s.shard_id, kept)
    return pairs


def cross_shard_pairs(genomes: Sequence[str], shards: Sequence[ShardSpec],
                      preclusterer) -> Dict[Tuple[int, int], float]:
    """Thresholded exact ANI of every screened pair whose genomes lie in
    different shards (the full run's code path)."""
    lookup = shard_lookup(shards)
    cache = preclusterer.distances_subset(
        genomes, lambda i, j: lookup(i) != lookup(j))
    return {k: cache.get(k) for k in cache.keys()
            if cache.get(k) is not None}


def merge(fleet_dir: str, genomes: Sequence[str],
          shards: Sequence[ShardSpec], preclusterer,
          ani_threshold: float, clock=None) -> List[List[int]]:
    """The final cluster list (global quality-order indices, in
    ``cluster/engine.py``'s order) from the shard checkpoints. `clock`
    (a ``timing.StageClock``), when given, counts
    ``fleet-within-shard-pairs`` and ``fleet-cross-shard-pairs``."""
    from galah_tpu_torch.index.incremental import (clusters_from_state,
                                                   screen_new_genomes)
    from galah_tpu_torch.index.store import IndexState

    pairs = load_shard_pairs(fleet_dir, shards)
    n_within = len(pairs)
    pairs.update(cross_shard_pairs(genomes, shards, preclusterer))
    logger.info("fleet merge: %d within-shard + %d cross-shard pairs",
                n_within, len(pairs) - n_within)
    if clock is not None:
        clock.count("fleet-within-shard-pairs", n_within)
        clock.count("fleet-cross-shard-pairs", len(pairs) - n_within)
    state = IndexState(generation=0, genomes=list(genomes), keys=[],
                       sketches=[], pairs=pairs, reps=[],
                       membership={}, tombstones=set())
    screen_new_genomes(state, 0, ani_threshold)
    return clusters_from_state(state)
