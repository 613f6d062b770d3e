"""The HLL cardinality-bucketed finch precluster
(``GALAH_TPU_HLL_BUCKETS``): the port of ``galah_tpu/ops/bucketing.py``.

A pair's true Jaccard is bounded by its cardinalities,

    J(A, B) = |A n B| / |A u B| <= min(|A|, |B|) / max(|A|, |B|),

so two genomes whose k-mer cardinalities differ by more than the
threshold ratio can never pass. Genomes are put in log-cardinality
bands and only same- and adjacent-band pairs are scheduled; the rest of
the lattice is pruned before any MinHash screen.

The band width is conservative for the pipeline's own decisions:

  * the pair decision is the sketch Jaccard (common/total >= j_thr with
    j_thr = ani_to_jaccard(min_ani, k)); the bottom-k estimate has
    standard error sqrt(J(1-J)/K), so a pair that can pass has
    J >= j_lo := j_thr - 6 sqrt(j_thr (1 - j_thr) / K);
  * HLL cardinality estimates carry relative standard error
    sigma = 1.04 / sqrt(2^p) (~1.6% at p = 12); padding by
    delta = 6 sigma bounds the estimates' ratio:
    chat_A / chat_B >= j_lo (1 - delta) / (1 + delta);
  * so every admissible pair has
    |ln chat_A - ln chat_B| <= L := ln(1/j_lo) + ln((1+delta)/(1-delta)),
    and with band(g) = floor(ln chat_g / L) its bands differ by at
    most one.

Exact cover without repeats: for each band b the submatrix S_b is
members(b) + members(b+1) in ascending global order; the pair pass runs
over S_b and only pairs with an endpoint in band b are kept (pairs
inside band b+1 belong to S_{b+1}'s run). Every admissible pair is
evaluated once, with the same integer stats as the full pass, so the
pair dict equals the unbucketed one bit for bit. When the margins
degenerate (j_lo <= 0 at tiny sketch sizes) the width is infinite: one
band, nothing pruned, still exact.

Each S_b goes to the card as a biased int64 submatrix (a gather of the
resident matrix's rows on its device, or, from a paged store,
``band_gather``'s contiguous host copy of the rows, uploaded), and
``ops/pairwise.threshold_pairs`` runs on it: a band under the sparse
crossover takes ``tile_stats``' full form, one of 1024 rows or more the
collision screen and ``pairlist``.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch import config
from galah_tpu_torch.obs import events
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops import collision
from galah_tpu_torch.ops.pairwise import ani_to_jaccard, threshold_pairs
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

#: The bucketed pass returns the exact pair dict of the unbucketed
#: pass: band assignment is f64 host math and every scheduled pair's
#: ANI comes from the unchanged per-pair integer stats.
DETERMINISM_CONTRACT = {
    "family": "bucketing",
    "dtype": "float64",
    "functions": ["band_width", "assign_bands",
                  "bucketed_threshold_pairs"],
}

#: 6-sigma margins on both estimators (per-pair miss odds ~1e-9)
_SIGMAS = 6.0


def resolve_hll_buckets() -> str:
    """The GALAH_TPU_HLL_BUCKETS flag value ('auto' | '0' | '1')."""
    return (config.env_value("GALAH_TPU_HLL_BUCKETS") or "auto").strip()


def bucketing_engaged(n: int) -> bool:
    """Whether the bucketed precluster pass runs for `n` genomes:
    forced on ('1', from two genomes), forced off ('0'), or AUTO: from
    the sparse-screen crossover up (``collision.sparse_screen_min_n()``,
    read at call time; ``GALAH_TPU_DENSE_PAIRS`` does not move it)."""
    raw = resolve_hll_buckets()
    if raw == "0":
        return False
    if raw == "1":
        return n >= 2
    return n >= collision.sparse_screen_min_n()


def band_width(min_ani: float, k: int, p: int, sketch_size: int) -> float:
    """Log-cardinality band width L (module docstring); inf when the
    MinHash margin swallows the threshold (no safe pruning)."""
    j_thr = float(ani_to_jaccard(min_ani, k))
    eps_mh = _SIGMAS * math.sqrt(
        j_thr * (1.0 - j_thr) / float(sketch_size))
    j_lo = j_thr - eps_mh
    if j_lo <= 0.0:
        return math.inf
    delta = _SIGMAS * 1.04 / math.sqrt(float(1 << p))
    if delta >= 1.0:
        return math.inf
    return (-math.log(j_lo)
            + math.log((1.0 + delta) / (1.0 - delta)))


def assign_bands(cards: np.ndarray, min_ani: float, k: int, p: int,
                 sketch_size: int) -> np.ndarray:
    """Band index per genome from its HLL cardinality estimate; an
    infinite width puts every genome in band 0."""
    width = band_width(min_ani, k, p, sketch_size)
    c = np.maximum(np.asarray(cards, dtype=np.float64), 1.0)
    if not math.isfinite(width):
        return np.zeros(c.shape[0], dtype=np.int64)
    return np.floor(np.log(c) / width).astype(np.int64)


def _pair_counts(bands: np.ndarray) -> Tuple[int, int]:
    """(possible, scheduled) pair counts for the gauges."""
    n = int(bands.shape[0])
    possible = n * (n - 1) // 2
    uniq, counts = np.unique(bands, return_counts=True)
    by_band = dict(zip(uniq.tolist(), counts.tolist()))
    scheduled = 0
    for b, m_b in by_band.items():
        m_next = by_band.get(b + 1, 0)
        s = m_b + m_next
        # pairs of S_b with an endpoint in band b (the kept set)
        scheduled += s * (s - 1) // 2 - m_next * (m_next - 1) // 2
    return possible, scheduled


def bucketed_threshold_pairs(
    sketch_mat,
    cards: np.ndarray,
    k: int,
    min_ani: float,
    sketch_size: Optional[int] = None,
    p: int = 12,
    pair_pass: Optional[Callable[[torch.Tensor], dict]] = None,
    device=None,
    clock: Optional[StageClock] = None,
) -> Dict[Tuple[int, int], float]:
    """``threshold_pairs`` with the cardinality-band prefilter: the same
    {(i, j): ani} dict, with only same- and adjacent-band submatrices
    scheduled. `cards` are the HLL cardinality estimates aligned with
    the rows.

    `sketch_mat` is the (N, K) biased int64 matrix on its device, or a
    paged view (``io/pagestore.PagedRowView``) with ``shape`` and
    ``band_gather(indices)``, which returns a contiguous host copy of
    the rows (u64) while only their pages are pinned; that copy goes to
    `device` (the view has none of its own). `pair_pass` maps a band's
    (m, K) biased submatrix on the device to its local pair dict; by
    default ``ops/pairwise.threshold_pairs`` on the same device, its
    mesh ``parallel/mesh.auto_mesh``'s: each band's pass goes over the
    run's mesh (every card of the process, on its grid)."""
    n = sketch_mat.shape[0]
    eff_size = (sketch_size if sketch_size is not None
                else sketch_mat.shape[1])
    band_gather = getattr(sketch_mat, "band_gather", None)
    if device is None:
        device = sketch_mat.device
    clock = clock or StageClock(torch.device(device))
    if pair_pass is None:
        def pair_pass(sub):
            return threshold_pairs(sub, k, min_ani, eff_size, clock)

    bands = assign_bands(cards, min_ani, k, p, eff_size)
    possible, scheduled = _pair_counts(bands)
    pruned = possible - scheduled

    members: Dict[int, np.ndarray] = {
        int(b): np.nonzero(bands == b)[0]
        for b in np.unique(bands).tolist()}

    out: Dict[Tuple[int, int], float] = {}
    for b in sorted(members):
        own = members[b]
        nxt = members.get(b + 1)
        idx = (own if nxt is None
               else np.sort(np.concatenate([own, nxt])))
        if idx.shape[0] < 2:
            continue
        in_b = set(own.tolist())
        if band_gather is not None:
            # the pinned pages' rows as one owned host copy, uploaded;
            # no mapped page outlives the gather
            sub = to_biased(band_gather(idx), device)
        else:
            sub = sketch_mat[torch.from_numpy(idx).to(sketch_mat.device)]
        for (a, bb), ani in pair_pass(sub).items():
            ga, gb = int(idx[a]), int(idx[bb])
            # within-(b+1) pairs belong to S_{b+1}'s run
            if ga in in_b or gb in in_b:
                out[(ga, gb)] = ani
        del sub

    n_bands = len(members)
    obs_metrics.gauge(
        "precluster.bucket_pruned_pairs",
        help="Candidate pairs the HLL cardinality-band prefilter "
             "removed from the all-pairs schedule (last precluster "
             "pass)", unit="pairs").set(float(pruned))
    obs_metrics.gauge(
        "precluster.bucket_pruned_fraction",
        help="Fraction of the full pair lattice the cardinality-band "
             "prefilter pruned (last precluster pass)",
        unit="fraction").set(
        float(pruned) / possible if possible else 0.0)
    obs_metrics.gauge(
        "precluster.bucket_count",
        help="Non-empty HLL cardinality bands in the last bucketed "
             "precluster pass", unit="bands").set(float(n_bands))
    events.record("hll-buckets", bands=n_bands, possible=possible,
                  scheduled=scheduled, pruned=pruned)
    logger.info(
        "HLL cardinality bucketing: %d bands, %d/%d candidate pairs "
        "pruned (%.1f%%)", n_bands, pruned, possible,
        100.0 * pruned / possible if possible else 0.0)
    return out
