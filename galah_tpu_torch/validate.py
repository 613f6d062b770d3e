"""``cluster-validate``: re-check a cluster file with exact ANI, the port
of ``galah_tpu/validate.py`` (reference: src/cluster_validation.rs:7-78).

Every member must reach the ANI threshold to its representative, and no
two representatives may reach it to each other (a gated-out pair, ANI
None, passes). Each check is one ``calculate_ani_batch`` call of the
clusterer: the member-to-representative pairs, then every pair of
representatives. Violations are logged as errors and counted; like the
reference, validation does not fail on them.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging

from galah_tpu_torch.outputs import read_cluster_file
from galah_tpu_torch.timing import Stopwatch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Validation:
    violations: int
    clusters: int
    member_pairs: int
    rep_pairs: int
    # host-clock seconds of each check (the ANIs come back to the host)
    member_seconds: float
    rep_seconds: float


def validate_clusters(cluster_file: str, clusterer) -> Validation:
    """Validate `cluster_file` with `clusterer` (a
    ``FastANIEquivalentClusterer``)."""
    clusters = read_cluster_file(cluster_file)
    thr = clusterer.ani_threshold
    violations = 0

    member_pairs = [(cluster[0], member)
                    for cluster in clusters for member in cluster[1:]]
    watch = Stopwatch()
    anis = clusterer.calculate_ani_batch(member_pairs)
    member_seconds = watch.seconds()
    for (rep, member), ani in zip(member_pairs, anis):
        if ani is None or ani < thr:
            violations += 1
            logger.error(
                "Member %s is not within %s ANI of its representative %s "
                "(found %s)", member, thr, rep, ani)

    reps = [c[0] for c in clusters]
    rep_pairs = list(itertools.combinations(reps, 2))
    watch = Stopwatch()
    anis = clusterer.calculate_ani_batch(rep_pairs)
    rep_seconds = watch.seconds()
    for (r1, r2), ani in zip(rep_pairs, anis):
        if ani is not None and ani >= thr:
            violations += 1
            logger.error(
                "Representatives %s and %s are within %s ANI of each "
                "other (found %s)", r1, r2, thr, ani)

    if violations == 0:
        logger.info("Validated %d clusters: no violations", len(clusters))
    else:
        logger.error("Found %d validation violations", violations)
    return Validation(violations=violations, clusters=len(clusters),
                      member_pairs=len(member_pairs),
                      rep_pairs=len(rep_pairs),
                      member_seconds=member_seconds,
                      rep_seconds=rep_seconds)
