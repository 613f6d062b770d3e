"""Two-stage greedy clustering engine: the port of the stage-serial
``galah_tpu/cluster/engine.py`` with its round-based device strategy.

Semantics (reference: src/clusterer.rs:14-125): genomes arrive in
quality order; genome i becomes a representative iff no earlier rep
with a precluster hit has exact ANI >= threshold; every non-rep joins
its argmax-ANI rep, ties to the lowest rep index. When the precluster
and cluster methods match (skani+skani), the precluster ANIs are
reused and the greedy stage computes nothing new.

The greedy scan runs in rounds (``_cluster_pending_rounds``): each
round takes the next K genomes of all pending preclusters, computes
their ANIs against existing reps in one batch, materializes the
intra-window pairs the decisions need in frontier sub-rounds, and
decides the window with one device fold (``ops/greedy_select``).
Windows deeper than the fold budget ("conflict windows") finish on the
exact host-order scan; that is part of the algorithm, not a fallback.
``find_representatives`` / ``find_memberships`` are the per-precluster
host-order scan the rounds must agree with.

With a checkpoint (``cluster/checkpoint.py``) the distance pass, each
round's backend-computed ANIs and each finished precluster reach the
disk as they are made, and a resume skips or replays them. A stop
requested by a signal (``resilience/interrupt.py``) is honoured only
at three boundaries, each right after its state is durable:
``distances-saved``, ``greedy-round-saved`` and ``precluster-saved``;
never inside a kernel launch or a profile group.

In a multi-process job (``parallel/distributed.py``) every rank runs
the same rounds, and each backend ANI batch is split over the ranks
(``_backend_ani_batch``) and exchanged.
"""

from __future__ import annotations

import hashlib
import json
import logging
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from galah_tpu_torch.cluster.cache import PairDistanceCache, pair_key
from galah_tpu_torch.cluster.partition import partition_preclusters
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.obs import profile as obs_profile
from galah_tpu_torch.ops import greedy_select
from galah_tpu_torch.parallel import distributed
from galah_tpu_torch.resilience import interrupt
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

# Materialization sub-rounds per window: bounds the rep-chain depth a
# window resolves on the device; deeper windows are conflict windows
# (greedy_select.FOLD_ITERS is kept at 2x this).
MAX_SUBROUNDS = 16

# Unique-genome cap per backend batch of a round: bounds the profile
# working set one batch pins at once.
ROUND_BATCH_GENOMES = 64

# Host-scan speculative batch width: genomes per window evaluated
# against all current reps in one backend call.
REP_SCAN_WINDOW = 128


def cluster(
    genomes: Sequence[str],
    preclusterer,
    clusterer,
    device="cuda",
    rep_rounds: Optional[int] = None,
    clock: Optional[StageClock] = None,
    checkpoint=None,
) -> List[List[int]]:
    """Cluster quality-ordered genome paths -> list of index clusters,
    each with its representative first; clusters ordered by precluster
    (biggest first) then by representative index. `checkpoint`, a
    ``cluster.checkpoint.ClusterCheckpoint``, persists the run and
    resumes from what it holds; its reads and writes are stages
    ``checkpoint-read`` and ``checkpoint-write``."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    skip_clusterer = preclusterer.method_name() == clusterer.method_name()
    if skip_clusterer:
        logger.info("Preclustering and clustering methods are the same, "
                    "so reusing ANI values")
    # the workload's N and sketch K: the perf ledger (obs/ledger.py)
    # keys a run on them, so a run is compared only with runs of the
    # same N and K (galah_tpu's gauges; only the finch store has a K)
    obs_metrics.gauge(
        "workload.n_genomes",
        help="Genomes in this clustering run").set(float(len(genomes)))
    sketch_k = getattr(getattr(preclusterer, "store", None),
                       "sketch_size", None)
    if sketch_k:
        obs_metrics.gauge(
            "workload.sketch_k",
            help="MinHash sketch size of the precluster backend").set(
            float(sketch_k))
    pre_cache = None
    if checkpoint:
        with clock.stage("checkpoint-read"):
            pre_cache = checkpoint.load_distances()
    if pre_cache is None:
        pre_cache = preclusterer.distances(genomes)
        if checkpoint:
            with clock.stage("checkpoint-write"):
                checkpoint.save_distances(pre_cache)
    obs_profile.sample_memory("precluster-distances")
    # safe boundary: the distance pass, the largest recompute, is durable
    interrupt.check("distances-saved")
    preclusters = partition_preclusters(len(genomes), pre_cache.keys())
    obs_profile.sample_memory("partition")
    logger.info("Found %d preclusters. The largest contained %d genomes",
                len(preclusters), len(preclusters[0]) if preclusters else 0)
    done: Dict[int, List[List[int]]] = {}
    if checkpoint:
        with clock.stage("checkpoint-read"):
            done = checkpoint.load_completed()
    pending = [(i, m) for i, m in enumerate(preclusters) if i not in done]
    if pending:
        with clock.stage("greedy"):
            finished = _cluster_pending_rounds(
                clusterer, genomes, pre_cache, pending, skip_clusterer,
                rep_rounds, device, checkpoint, clock)
        done.update(finished)
        if checkpoint:
            with clock.stage("checkpoint-write"):
                for pc_index, global_clusters in sorted(finished.items()):
                    checkpoint.save_precluster(pc_index, global_clusters)
                checkpoint.clear_greedy_rounds()
        # safe boundary: every precluster's clusters are durable
        interrupt.check("precluster-saved")
    all_clusters: List[List[int]] = []
    for pc_index in range(len(preclusters)):
        all_clusters.extend(done[pc_index])
    obs_profile.sample_memory("greedy-cluster")
    logger.info("Found %d clusters", len(all_clusters))
    return all_clusters


def _greedy_digest(pending: List[Tuple[int, Sequence[int]]]) -> str:
    """Digest of the pending-precluster sequence a greedy-round record
    is valid for: a resume whose pending set differs drops the records
    instead of replaying them into a differently shaped scan."""
    ident = json.dumps([[pc, list(m)] for pc, m in pending])
    return hashlib.sha256(ident.encode()).hexdigest()


def _batch_ani(
    clusterer,
    skip_clusterer: bool,
    pre_cache: PairDistanceCache,
    genomes: Sequence[str],
    pairs: Sequence[Tuple[int, int]],
    computed_log: Optional[List[Tuple[int, int]]] = None,
) -> List[Optional[float]]:
    """ANI for index pairs: the precluster value when the methods match
    (reference: src/clusterer.rs:264-279), else one batched backend
    call for the missing pairs, which are appended to `computed_log`
    when it is given."""
    out: List[Optional[float]] = [None] * len(pairs)
    to_compute: List[Tuple[int, Tuple[str, str]]] = []
    for n, (i, j) in enumerate(pairs):
        if skip_clusterer and pre_cache.contains((i, j)):
            out[n] = pre_cache.get((i, j))
        else:
            to_compute.append((n, (genomes[i], genomes[j])))
            if computed_log is not None:
                computed_log.append(pairs[n])
    if to_compute:
        anis = _backend_ani_batch(clusterer, [p for _, p in to_compute])
        for (n, _), ani in zip(to_compute, anis):
            out[n] = ani
    return out


def _backend_ani_batch(clusterer, path_pairs: List[Tuple[str, str]]
                       ) -> List[Optional[float]]:
    """One backend ANI batch, split over the ranks of a multi-process
    job. Every rank reaches this with the same pairs (the engine is
    deterministic and its caches agree), and a pair goes to the rank
    that ``zlib.crc32`` of its second path names, so that a genome's
    pairs against the representatives land on one rank; a failing rank
    makes every rank raise. In one process, a plain call."""
    n_proc = distributed.process_count()
    if n_proc <= 1 or len(path_pairs) < n_proc:
        return clusterer.calculate_ani_batch(path_pairs)
    owners = [zlib.crc32(b.encode()) for _a, b in path_pairs]
    return distributed.sharded_optional_floats(
        len(path_pairs),
        lambda idxs: clusterer.calculate_ani_batch(
            [path_pairs[k] for k in idxs]),
        owner=lambda k: owners[k])


def _cluster_pending_rounds(
    clusterer,
    genomes: Sequence[str],
    pre_cache: PairDistanceCache,
    pending: List[Tuple[int, Sequence[int]]],
    skip_clusterer: bool,
    rep_rounds: Optional[int],
    device: torch.device,
    checkpoint=None,
    clock: Optional[StageClock] = None,
) -> Dict[int, List[List[int]]]:
    """The round-based greedy strategy over ALL pending preclusters at
    once: {precluster index -> its global clusters}. With a
    checkpoint, each round's backend-computed pairs are appended to its
    round log, and the log's pairs for these pending preclusters are
    replayed into the cache first, so no replayed pair reaches the
    backend again."""
    clock = clock or StageClock(device)
    thr = clusterer.ani_threshold
    width = (int(rep_rounds) if rep_rounds is not None
             else greedy_select.DEFAULT_ROUND_WIDTH)
    if width < 1:
        raise ValueError(f"rep_rounds must be >= 1, got {width}")

    seq: List[int] = []
    pc_of: Dict[int, int] = {}
    for pc, members in pending:
        for g in members:
            seq.append(g)
            pc_of[g] = pc
    # precluster-hit adjacency: the hit graph's components ARE the
    # preclusters, so both endpoints of a key lie in one precluster
    adj: Dict[int, List[int]] = {g: [] for g in seq}
    for a, b in pre_cache.keys():
        if a in pc_of:
            adj[a].append(b)
            adj[b].append(a)
    for v in adj.values():
        v.sort()

    ani_cache = PairDistanceCache()
    reps_by_pc: Dict[int, List[int]] = {pc: [] for pc, _ in pending}
    rep_set: Set[int] = set()
    computed: List[Tuple[int, int]] = []  # pairs that hit the backend
    consulted: Set[Tuple[int, int]] = set()  # pairs a rep decision read

    digest = _greedy_digest(pending)
    if checkpoint:
        with clock.stage("checkpoint-read"):
            for i, j, ani in checkpoint.load_greedy_rounds(digest):
                ani_cache.insert((i, j), ani)
                computed.append((i, j))
    if computed:
        clock.count("greedy-replayed-pairs", len(computed))

    def batch(pairs: List[Tuple[int, int]]) -> None:
        """Compute the pairs missing from the cache, in chunks of at
        most ROUND_BATCH_GENOMES unique genomes (pair order kept)."""
        seen: Set[Tuple[int, int]] = set()
        uniq: List[Tuple[int, int]] = []
        for p in pairs:
            k = pair_key(*p)
            if k in seen or ani_cache.contains(p):
                continue
            seen.add(k)
            uniq.append(p)
        chunk: List[Tuple[int, int]] = []
        chunk_genomes: Set[int] = set()

        def flush() -> None:
            if not chunk:
                return
            anis = _batch_ani(clusterer, skip_clusterer, pre_cache,
                              genomes, chunk, computed_log=computed)
            for p, ani in zip(chunk, anis):
                ani_cache.insert(p, ani)
            chunk.clear()
            chunk_genomes.clear()

        for p in uniq:
            if chunk and len(chunk_genomes | set(p)) > \
                    ROUND_BATCH_GENOMES:
                flush()
            chunk.append(p)
            chunk_genomes.update(p)
        flush()

    def value(i: int, j: int) -> Optional[float]:
        if skip_clusterer and pre_cache.contains((i, j)):
            return pre_cache.get((i, j))
        return ani_cache.get((i, j))

    pos = 0
    while pos < len(seq):
        window = seq[pos:pos + width]
        pos += len(window)
        rstart = len(computed)
        _device_round(window, pc_of, adj, reps_by_pc, rep_set, batch,
                      value, consulted, thr, device)
        clock.count("greedy-rounds", 1)
        if checkpoint and len(computed) > rstart:
            with clock.stage("checkpoint-write"):
                checkpoint.save_greedy_round(
                    digest, [(i, j, ani_cache.get((i, j)))
                             for i, j in computed[rstart:]])
        # safe boundary: this round's ANIs are durable; a resume replays
        # them and derives the same decisions without computing them
        interrupt.check("greedy-round-saved")

    # membership: one batch for every (rep, non-rep) hit pair, then the
    # device argmax per precluster
    todo: List[Tuple[int, int]] = []
    for a, b in pre_cache.keys():
        if a not in pc_of:
            continue
        a_rep, b_rep = a in rep_set, b in rep_set
        if a_rep == b_rep:
            continue
        r, i = (a, b) if a_rep else (b, a)
        if not (skip_clusterer and pre_cache.contains((i, r))) \
                and not ani_cache.contains((i, r)):
            todo.append((r, i))
    todo.sort(key=lambda p: (p[1], p[0]))
    n_rep_computed = len(computed)
    batch(todo)

    results: Dict[int, List[List[int]]] = {}
    for pc, members in pending:
        rep_list = reps_by_pc[pc]
        rep_col = {r: c for c, r in enumerate(rep_list)}
        nonreps = [g for g in members if g not in rep_set]
        clusters: List[List[int]] = [[r] for r in rep_list]
        if nonreps:
            mat = np.full((len(nonreps), len(rep_list)), np.nan,
                          dtype=np.float64)
            for gi, g in enumerate(nonreps):
                for r in adj[g]:
                    c = rep_col.get(r)
                    if c is None:
                        continue
                    v = value(g, r)
                    if v is not None:
                        mat[gi, c] = v
            best, has = greedy_select.membership_argmax(mat, device)
            for gi, g in enumerate(nonreps):
                if not has[gi]:
                    raise RuntimeError(
                        f"genome {genomes[g]} passed the representative "
                        "test but has no ANI to any representative — "
                        "inconsistent backend")
                clusters[int(best[gi])].append(g)
        results[pc] = clusters

    # waste, split by the phase that paid for each pair: the membership
    # argmax reads every cached (non-rep, rep) pair, so a computed key
    # joining a rep and a non-rep was read
    computed_keys = {pair_key(*p) for p in computed}
    # galah-lint: ignore[GL902] a set built from a set, read only for its size
    mem_consulted = {k for k in computed_keys
                     if (k[0] in rep_set) != (k[1] in rep_set)}
    live = consulted | mem_consulted
    rep_keys = {pair_key(*p) for p in computed[:n_rep_computed]}
    mem_keys = {pair_key(*p) for p in computed[n_rep_computed:]} \
        - rep_keys
    _count_waste(clock, len(computed_keys), rep=len(rep_keys - live),
                 membership=len(mem_keys - live), warm=0)
    return results


def _count_waste(clock: StageClock, n_computed: int, rep: int,
                 membership: int, warm: int) -> None:
    """The exact ANIs computed and those no greedy decision read, the
    waste split by the phase that paid for it (``galah_tpu``'s
    ``_emit_waste_counters``; no warm pass runs here, so its share is
    0)."""
    wasted = rep + membership + warm
    clock.count("exact-ani-computed", n_computed)
    clock.count("exact-ani-wasted", wasted)
    clock.count("exact-ani-wasted-rep", rep)
    clock.count("exact-ani-wasted-membership", membership)
    clock.count("exact-ani-wasted-warm", warm)
    obs_metrics.counter(
        "ani.exact_computed",
        help="Exact ANI pairs the backend computed",
        unit="pairs").inc(n_computed)
    obs_metrics.counter(
        "ani.exact_wasted",
        help="Backend-computed ANI pairs no greedy decision "
             "ever consulted (speculation waste)",
        unit="pairs").inc(wasted)


def _device_round(
    window: List[int],
    pc_of: Dict[int, int],
    adj: Dict[int, List[int]],
    reps_by_pc: Dict[int, List[int]],
    rep_set: Set[int],
    batch,
    value,
    consulted: Set[Tuple[int, int]],
    thr: float,
    device: torch.device,
) -> None:
    """Resolve one K-genome window; commits new reps into reps_by_pc.

    (1) one batch of window x existing-rep hit pairs and the derived
    already-clustered flags; (2) bounded frontier sub-rounds that
    materialize the intra-window pairs the decisions depend on (the
    first undecided genome of every segment is provably the next rep);
    (3) the device fold as the authoritative decision, cross-checked
    against the sub-round bookkeeping. A window the budget cannot
    finish completes its undecided tail on the exact host-order scan.
    Every pair a decision reads is added to `consulted`.
    """
    w = len(window)
    win_pos = {g: wi for wi, g in enumerate(window)}
    hits = {g: set(adj[g]) for g in window}

    batch([(r, g) for g in window for r in reps_by_pc[pc_of[g]]
           if r in hits[g]])
    ext = np.zeros(w, dtype=bool)
    for wi, g in enumerate(window):
        for r in reps_by_pc[pc_of[g]]:
            if r not in hits[g]:
                continue
            consulted.add(pair_key(r, g))
            v = value(r, g)
            if v is not None and v >= thr:
                ext[wi] = True

    decided = ext.copy()
    tentative = np.zeros(w, dtype=bool)
    for _ in range(MAX_SUBROUNDS):
        frontier: List[int] = []
        seen_seg: Set[int] = set()
        for wi in range(w):
            if decided[wi]:
                continue
            s = pc_of[window[wi]]
            if s in seen_seg:
                continue
            seen_seg.add(s)
            frontier.append(wi)
        if not frontier:
            break
        pairs: List[Tuple[int, int]] = []
        claims: List[Tuple[int, int]] = []
        for fi in frontier:
            f = window[fi]
            for t in adj[f]:
                ti = win_pos.get(t)
                if ti is None or ti <= fi or decided[ti]:
                    continue
                pairs.append((f, t))
                claims.append((fi, ti))
        batch(pairs)
        for fi in frontier:
            decided[fi] = True
            tentative[fi] = True
        for fi, ti in claims:
            consulted.add(pair_key(window[fi], window[ti]))
            v = value(window[fi], window[ti])
            if v is not None and v >= thr:
                decided[ti] = True

    complete = bool(decided.all())
    mat = np.full((w, w), np.nan, dtype=np.float64)
    for wi, g in enumerate(window):
        for t in adj[g]:
            ti = win_pos.get(t)
            if ti is None or ti <= wi:
                continue
            v = value(g, t)
            if v is not None:
                mat[wi, ti] = v
    rep_flags, converged = greedy_select.window_select(mat, ext, thr,
                                                       device)
    if complete:
        if not converged or not np.array_equal(rep_flags, tentative):
            raise RuntimeError(
                "device window fold disagreed with the exact sub-round "
                "bookkeeping — refusing speculative greedy decisions")
    else:
        # conflict window: finish the undecided tail with the exact
        # host-order scan; decisions are unchanged
        logger.debug("conflict window of %d genomes finishes on the "
                     "host-order scan", w)
        for ti in range(w):
            if decided[ti]:
                continue
            t = window[ti]
            cands = [fi for fi in range(ti)
                     if tentative[fi] and window[fi] in hits[t]]
            batch([(window[fi], t) for fi in cands])
            is_rep = True
            for fi in cands:
                consulted.add(pair_key(window[fi], t))
                v = value(window[fi], t)
                if v is not None and v >= thr:
                    is_rep = False
                    break
            decided[ti] = True
            if is_rep:
                tentative[ti] = True

    for wi in range(w):
        if tentative[wi]:
            g = window[wi]
            reps_by_pc[pc_of[g]].append(g)
            rep_set.add(g)


def find_representatives(
    clusterer,
    pre_cache: PairDistanceCache,
    genomes: Sequence[str],
    skip_clusterer: bool,
    rep_scan_window: int = REP_SCAN_WINDOW,
) -> Tuple[Set[int], PairDistanceCache]:
    """The per-precluster host-order representative scan (reference:
    src/clusterer.rs:155-225) on local ids: genome i is a rep iff no
    current rep with a precluster hit has exact ANI >= threshold, reps
    tried in ascending precluster-ANI order."""
    reps: Set[int] = set()
    ani_cache = PairDistanceCache()
    thr = clusterer.ani_threshold
    n = len(genomes)

    def ensure_anis(pairs: List[Tuple[int, int]]) -> None:
        missing = [(j, g) for j, g in pairs
                   if not ani_cache.contains((j, g))]
        if missing:
            anis = _batch_ani(clusterer, skip_clusterer, pre_cache,
                              genomes, missing)
            for (j, g), ani in zip(missing, anis):
                ani_cache.insert((j, g), ani)

    for w0 in range(0, n, rep_scan_window):
        window = range(w0, min(w0 + rep_scan_window, n))
        rep_list = list(reps)
        ensure_anis([(j, g) for g in window for j in rep_list
                     if pre_cache.contains((g, j))])
        for i in window:
            cands = [(j, pre_cache.get((i, j))) for j in sorted(reps)
                     if pre_cache.contains((i, j))]
            cands.sort(key=lambda t: t[1] if t[1] is not None else -1.0)
            ensure_anis([(j, i) for j, _ in cands])
            is_rep = True
            for j, _ in cands:
                ani = ani_cache.get((j, i))
                if ani is not None and ani >= thr:
                    is_rep = False
                    break
            if is_rep:
                reps.add(i)
                ensure_anis([(i, gx) for gx in window if gx > i
                             and pre_cache.contains((gx, i))])
    return reps, ani_cache


def find_memberships(
    clusterer,
    reps: Set[int],
    pre_cache: PairDistanceCache,
    genomes: Sequence[str],
    ani_cache: PairDistanceCache,
    skip_clusterer: bool,
) -> List[List[int]]:
    """Assign every non-rep to its argmax-ANI rep, ties to the lowest
    rep index (reference: src/clusterer.rs:316-406), on local ids."""
    rep_list = sorted(reps)
    rep_to_cluster = {r: n for n, r in enumerate(rep_list)}
    clusters: List[List[int]] = [[r] for r in rep_list]
    todo: List[Tuple[int, int]] = []
    for a, b in pre_cache.keys():
        a_rep, b_rep = a in reps, b in reps
        if a_rep == b_rep:
            continue
        r, i = (a, b) if a_rep else (b, a)
        if not ani_cache.contains((i, r)):
            todo.append((r, i))
    todo.sort(key=lambda p: (p[1], p[0]))
    anis = _batch_ani(clusterer, skip_clusterer, pre_cache, genomes, todo)
    for (r, i), ani in zip(todo, anis):
        ani_cache.insert((r, i), ani)
    for i in range(len(genomes)):
        if i in reps:
            continue
        best_rep, best_ani = None, None
        for r in rep_list:
            ani = ani_cache.get((i, r))
            if ani is not None and (best_ani is None or ani > best_ani):
                best_rep, best_ani = r, ani
        if best_rep is None:
            raise RuntimeError(
                f"genome {genomes[i]} passed the representative test but "
                "has no ANI to any representative — inconsistent backend")
        clusters[rep_to_cluster[best_rep]].append(i)
    return clusters
