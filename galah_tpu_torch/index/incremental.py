"""The incremental update engine over the persistent sketch index: the
port of ``galah_tpu/index/incremental.py``.

Why persisted state suffices: with the MinHash preclusterer and a
clusterer that names the same method (``SketchANIClusterer``), the
cluster engine takes every greedy decision from the precluster pair
cache: genome ``i`` is a representative iff no earlier representative
with a cached pair reaches the threshold, and a non-representative
joins its argmax-ANI representative, ties to the lowest index. The
decisions are functions of the greedy order and the thresholded pair
set, which is what the index persists. So:

* *insert* appends new genomes after every existing one in the greedy
  order and needs only the new genomes' pairs; an existing member moves
  only to a new representative with a strictly higher ANI;
* *query* runs the same screen against the live representatives and
  writes nothing;
* *remove* tombstones a genome; a removed representative's cluster
  re-elects its lowest-index member (a local repair, not a from-scratch
  equivalence).

The pair passes run on the device. ``build`` runs the port's finch
distance pass (``MinHashPreclusterer.distances``). ``insert`` holds
every sketch of the index in one sorted, sentinel-padded, biased int64
(N, sketch_size) matrix on the device for the whole insert, and takes
each batch's pairs of a new genome g and every live u < g in one
``ops/sparse_device.pair_stats_for_pairs`` pass (the pairlist kernel on
the card, g as its staged row); ``query`` does the same over (query,
live rep) pairs. The
kernel's int32 (common, total) are those of ``galah_tpu``'s host
``merge_stats``, and the keep rule and the float64 ANI are
``pair_ani``'s, so an index grown by inserts holds exactly the bytes of
a from-scratch build, and either package's index is the other's.
``merge_stats`` and ``pair_ani`` stay here as the plain host reference.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch import config
from galah_tpu_torch import index as index_pkg
from galah_tpu_torch.backends.minhash_backend import (MinHashPreclusterer,
                                                      SketchStore)
from galah_tpu_torch.cluster.partition import partition_preclusters
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.index import store as index_store
from galah_tpu_torch.index.store import IndexState, IndexStore
from galah_tpu_torch.io import diskcache
from galah_tpu_torch.obs import flow as obs_flow
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops.minhash import sketch_rows
from galah_tpu_torch.ops.pairwise import ani_to_jaccard, stats_to_ani_f64
from galah_tpu_torch.ops.sketch_stream import iter_path_sketches
from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs
from galah_tpu_torch.resilience import interrupt
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

# Concurrency contract (GL805 and the GALAH_SAN sanitizer): this module
# holds no locked shared state of its own: mutation is serialized by
# the single-writer IndexStore (index/store.py's GUARDED_BY), and the
# streamed sketch stage's threads live in ops/sketch_stream.py.
GUARDED_BY: Dict[str, str] = {}
LOCK_ORDER: List[str] = []

# The insert and query sketch stage (GL10xx, obs/flow.py). It feeds no
# occupancy gauge of its own: the sketch stream below it does.
PIPELINE_STAGE = {
    "streaming": ["iter_insert_sketches"],
}

#: pairs per pass of the pair statistics: bounds the index lists and
#: results of one pass on the device (2**24 pairs: 256 MB of indices)
PAIR_CHUNK = 1 << 24


class SketchANIClusterer:
    """A clusterer that names the preclusterer's method, so the engine
    takes every decision from the precluster pair cache: sketch ANI is
    the exact ANI, and a persisted pair set re-derives the engine's
    output exactly."""

    def __init__(self, ani_threshold: float) -> None:
        self.ani_threshold = float(ani_threshold)

    def method_name(self) -> str:
        return "finch"


def _sketch_store(params: Dict[str, Any], device: torch.device,
                  cache_dir: Optional[str],
                  clock: StageClock) -> SketchStore:
    if params["seed"] != Defaults.MINHASH_SEED:
        raise ValueError(f"index sketch seed {params['seed']}: "
                         "galah_tpu_torch sketches with seed "
                         f"{Defaults.MINHASH_SEED} only")
    return SketchStore(device, sketch_size=params["sketch_size"],
                       k=params["k"], algo=params["algo"], clock=clock,
                       cache=diskcache.get_cache(cache_dir, clock))


# -- the plain host reference ------------------------------------------


def iter_insert_sketches(paths: Sequence[str], sk_store, threads: int = 1
                         ) -> Iterator[Tuple[str, Any]]:
    """The insert and query sketch stage: (path, sketch) over the sketch
    stream, each wait on it the ``index-sketch`` stage's upstream-empty
    wait (``obs/flow.py``; ``galah_tpu/index/incremental
    .iter_insert_sketches``)."""
    return obs_flow.waited(iter_path_sketches(paths, sk_store, threads),
                           "index-sketch")


def merge_stats(a: np.ndarray, b: np.ndarray,
                sketch_size: int) -> Tuple[int, int]:
    """Integer (common, total) of two sorted-distinct bottom-k sketches
    over the first ``min(sketch_size, |union|)`` union elements:
    ``galah_tpu``'s numpy twin of its device pair statistics. The device
    passes above compute the same integers; this is their reference."""
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return 0, min(sketch_size, na + nb)
    pos = np.searchsorted(b, a)
    safe = np.minimum(pos, nb - 1)
    match = (pos < nb) & (b[safe] == a)
    n_common = int(match.sum())
    total = min(sketch_size, na + nb - n_common)
    # union rank of a[i]: a-elements before it + b-elements below it -
    # matches already counted once
    urank = np.arange(na) + pos - (np.cumsum(match) - match)
    common = int((match & (urank < total)).sum())
    return common, total


def pair_ani(a: np.ndarray, b: np.ndarray, sketch_size: int, k: int,
             j_thr: float) -> Optional[float]:
    """ANI of a sketch pair under the precluster keep rule, or None if
    the pair falls below it: keep iff common > 0 and common >=
    jaccard_threshold * total, in float64."""
    common, total = merge_stats(a, b, sketch_size)
    if common <= 0 or float(common) < j_thr * total:
        return None
    return float(stats_to_ani_f64(np.asarray([common]),
                                  np.asarray([total]), k)[0])


def default_batch() -> int:
    """Genomes per insert batch when the caller gives none:
    ``GALAH_TPU_INDEX_BATCH`` (default 32), as in ``galah_tpu``."""
    return max(1, int(config.env_value("GALAH_TPU_INDEX_BATCH")))


# -- the device pair pass ----------------------------------------------


def kept_pairs(mat: torch.Tensor, pi: np.ndarray, pj: np.ndarray,
               sketch_size: int, k: int, j_thr: float, clock: StageClock
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pi, pj, ani) of the listed pairs of `mat`'s rows that pass
    ``pair_ani``'s keep rule, in list order: the pair statistics in one
    device pass a ``PAIR_CHUNK`` of pairs (stage ``pair-stats``), the
    keep rule and the float64 ANI on the host."""
    keep_i, keep_j, anis = [], [], []
    for s in range(0, pi.shape[0], PAIR_CHUNK):
        ci, cj = pi[s:s + PAIR_CHUNK], pj[s:s + PAIR_CHUNK]
        with clock.stage("pair-stats"):
            common, total = pair_stats_for_pairs(mat, ci, cj, sketch_size,
                                                 clock)
        common = common.astype(np.int64)
        total = total.astype(np.int64)
        # pair_ani's rule, element for element in IEEE float64
        keep = (common > 0) & (common.astype(np.float64) >= j_thr * total)
        keep_i.append(ci[keep])
        keep_j.append(cj[keep])
        anis.append(stats_to_ani_f64(common[keep], total[keep], k))
    clock.count("index-pairs", int(pi.shape[0]))
    clock.count("screen-possible-pairs", int(pi.shape[0]))
    if not keep_i:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, np.zeros(0, dtype=np.float64)
    ki = np.concatenate(keep_i)
    clock.count("index-kept-pairs", int(ki.shape[0]))
    return ki, np.concatenate(keep_j), np.concatenate(anis)


def pairs_below(live: np.ndarray, g0: int, g1: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(pg, pu) of every pair (g, u), g in [g0, g1) and u < g in the
    ascending index array `live`, grouped by g, u ascending. The new
    genome is the first (the kernel's a) row: the pairlist kernel stages
    the a row that consecutive pairs share (``kernels/pairlist.cu``) and
    reads the b row in place, so the list's shared row goes first; the
    merge statistics are symmetric."""
    gs = np.arange(g0, g1, dtype=np.int64)
    counts = np.searchsorted(live, gs)
    pu = (np.concatenate([live[:c] for c in counts]) if gs.size
          else np.zeros(0, dtype=np.int64))
    return np.repeat(gs, counts), pu.astype(np.int64)


# -- decision re-derivation (the engine's greedy semantics) ------------


def screen_new_genomes(state: IndexState, new_start: int,
                       thr: float) -> Dict[str, int]:
    """Extend representatives and membership for genomes
    ``[new_start, n)`` and re-home affected existing members, in place;
    returns the counts {new_reps, new_members, reassigned}."""
    pairs = state.pairs
    tomb = state.tombstones
    # ascending live reps: state.reps is sorted and new genomes are
    # screened in ascending order, so appends keep it sorted
    rep_list = [r for r in state.reps if r not in tomb]
    rep_all = set(state.reps)
    new_reps: List[int] = []
    joiners: List[int] = []
    # pass 1: representative decisions, against the reps chosen before
    # each genome (all lower indices in the greedy order)
    for g in range(new_start, state.n_genomes):
        if g in tomb:
            continue
        if not any(pairs[(r, g)] >= thr for r in rep_list
                   if (r, g) in pairs):
            rep_all.add(g)
            rep_list.append(g)
            new_reps.append(g)
        else:
            joiners.append(g)
    # pass 2: membership over the full final rep list (a non-rep can
    # join a higher-index rep): ascending reps, strict improvement, no
    # threshold
    for g in joiners:
        best_r, best_ani = None, None
        for r in rep_list:
            ani = pairs.get((min(g, r), max(g, r)))
            if ani is not None and (best_ani is None or ani > best_ani):
                best_r, best_ani = r, ani
        state.membership[g] = best_r
    new_members = len(joiners)
    # an existing member with a pair to a NEW rep re-homes iff strictly
    # better: every new rep index exceeds every old one
    reassigned = 0
    if new_reps:
        for m, cur in list(state.membership.items()):
            if m >= new_start or m in tomb:
                continue
            cur_key = (min(m, cur), max(m, cur))
            best_r, best_ani = cur, pairs.get(cur_key)
            for r in new_reps:
                ani = pairs.get((m, r))
                if ani is not None and (best_ani is None
                                        or ani > best_ani):
                    best_r, best_ani = r, ani
            if best_r != cur:
                state.membership[m] = best_r
                reassigned += 1
    state.reps = sorted(rep_all)
    return {"new_reps": len(new_reps), "new_members": new_members,
            "reassigned": reassigned}


def clusters_from_state(state: IndexState) -> List[List[int]]:
    """The engine-ordered cluster list: preclusters biggest-first (ties
    to the lowest genome index), representatives ascending within one,
    each cluster ``[rep] + members ascending``."""
    live = set(state.live)
    keys = [kk for kk in state.pairs
            if kk[0] in live and kk[1] in live]
    rep_set = set(state.reps)
    members: Dict[int, List[int]] = {}
    for g, r in state.membership.items():
        members.setdefault(r, []).append(g)
    out: List[List[int]] = []
    for comp in partition_preclusters(state.n_genomes, keys):
        for r in comp:
            if r in rep_set:
                out.append([r] + sorted(members.get(r, [])))
    return out


def cluster_paths(state: IndexState) -> List[List[str]]:
    return [[state.genomes[g] for g in c]
            for c in clusters_from_state(state)]


# -- operations --------------------------------------------------------


def _publish(state: IndexState, op: str,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The operation's summary, also set as the run report's ``index``
    section, and the index gauges."""
    live = len(state.live)
    obs_metrics.gauge(
        "index.generation",
        help="Committed generation of the persistent sketch index",
        unit="generation").set(float(state.generation))
    obs_metrics.gauge(
        "index.genomes",
        help="Live (non-tombstoned) genomes in the sketch index",
        unit="genomes").set(float(live))
    obs_metrics.gauge(
        "index.clusters",
        help="Clusters (representatives) in the sketch index",
        unit="clusters").set(float(len(state.reps)))
    out: Dict[str, Any] = {
        "op": op,
        "generation": state.generation,
        "genomes": live,
        "clusters": len(state.reps),
        "tombstones": len(state.tombstones),
        "pairs": len(state.pairs),
    }
    if extra:
        out.update(extra)
    index_pkg.set_snapshot(out)
    return out


def build(path: str, ordered_paths: Sequence[str], ani: float,
          precluster_ani: float, device="cuda",
          sketch_size: Optional[int] = None, k: Optional[int] = None,
          seed: Optional[int] = None, algo: Optional[str] = None,
          cache_dir: Optional[str] = None, threads: int = 1,
          clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Build (or finish a killed build of) the index at `path` from the
    quality-ordered `ordered_paths`, committing generation 1. The pair
    pass is a ``cluster`` run's finch distance pass."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    params = index_store.index_params(
        ani=ani, precluster_ani=precluster_ani,
        sketch_size=(Defaults.MINHASH_SKETCH_SIZE
                     if sketch_size is None else sketch_size),
        k=Defaults.MINHASH_KMER if k is None else k,
        seed=Defaults.MINHASH_SEED if seed is None else seed,
        algo=Defaults.HASH_ALGO if algo is None else algo)
    idx = IndexStore(path, params=params, create=True)
    if idx.generation():
        raise ValueError(
            f"index at {path} is already built (generation "
            f"{idx.generation()}); use `galah-tpu index insert`")
    state = idx.begin_mutation()

    paths = [os.path.abspath(p) for p in ordered_paths]
    if len(set(os.path.realpath(p) for p in paths)) != len(paths):
        raise ValueError("duplicate genome paths in index build input")

    store = _sketch_store(params, device, cache_dir, clock)
    pre = MinHashPreclusterer(min_ani=params["precluster_ani"],
                              store=store, threads=threads)
    pair_cache = pre.distances(paths)

    with clock.stage("index-write"):
        for g, p in enumerate(paths):
            hashes = np.asarray(store.get_cached(p).hashes,
                                dtype=np.uint64)
            key = index_store.genome_key(p, idx.sketch_params)
            idx.append_genome(g, p, key)
            idx.append_sketch(g, hashes)
            state.genomes.append(p)
            state.keys.append(key)
            state.sketches.append(hashes)
        # grouped by the higher index, the order insert appends in, so
        # a grown index and a from-scratch build hold the same bytes
        pair_rows = sorted(
            ((i, j, ani_val) for (i, j), ani_val in pair_cache.items()),
            key=lambda row: (row[1], row[0]))
        idx.append_pairs(pair_rows)
        state.pairs = {(i, j): v for i, j, v in pair_rows}
        counts = screen_new_genomes(state, 0, params["ani"])
        generation = idx.commit(state)
    logger.info(
        "Built index at %s: generation %d, %d genomes, %d clusters, "
        "%d pairs", path, generation, len(state.genomes),
        len(state.reps), len(state.pairs))
    return _publish(state, "build", counts)


def insert(idx: IndexStore, new_paths: Sequence[str], device="cuda",
           cache_dir: Optional[str] = None, threads: int = 1,
           batch: Optional[int] = None,
           clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Insert the quality-ordered `new_paths`, committing one new
    generation. Only the new genomes are sketched, `batch` at a time
    (``ops/sketch_stream``); each batch's pairs go through one device
    pass against the matrix of every sketch so far, and its records are
    durable before the ``index-batch-saved`` boundary, where a requested
    stop raises ``interrupt.PreemptionRequested``. The index stays
    loadable at the prior generation, and the same insert run again
    (its sketches cache-warm with a disk cache) writes the bytes an
    uninterrupted one writes."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    batch = max(1, int(default_batch() if batch is None else batch))
    state = idx.begin_mutation()
    if state.generation == 0:
        raise ValueError(
            f"index at {idx.path} has no committed generation; run "
            "`galah-tpu index build` first")
    known = {os.path.realpath(p) for p in state.genomes}
    fresh: List[str] = []
    skipped = 0
    for p in new_paths:
        rp = os.path.realpath(p)
        if rp in known:
            skipped += 1
            continue
        known.add(rp)
        fresh.append(os.path.abspath(p))
    if skipped:
        logger.info("Skipping %d genome(s) already in the index",
                    skipped)
    if not fresh:
        return _publish(state, "insert",
                        {"inserted": 0, "skipped": skipped})

    params = idx.params
    size, k = params["sketch_size"], params["k"]
    j_thr = ani_to_jaccard(params["precluster_ani"], k)
    sk_store = _sketch_store(params, device, cache_dir, clock)
    new_start = state.n_genomes
    n_end = new_start + len(fresh)
    # every sketch of the index and of this insert, on the device for
    # the whole insert; the new rows are filled a batch at a time
    with clock.stage("index-load"):
        mat = sketch_rows(state.sketches, size, device, rows=n_end)
    live = np.ones(n_end, dtype=bool)
    live[sorted(state.tombstones)] = False
    live_idx = np.flatnonzero(live).astype(np.int64)
    for b0 in range(0, len(fresh), batch):
        # galah-lint: ignore[GL1001] one --batch of sketches, bounded; its pair pass needs all of them
        got = list(iter_insert_sketches(fresh[b0:b0 + batch], sk_store,
                                        threads))
        g0 = state.n_genomes
        g1 = g0 + len(got)
        hashes = [np.asarray(sk.hashes, dtype=np.uint64) for _, sk in got]
        mat[g0:g1] = sketch_rows(hashes, size, device)
        pg, pu = pairs_below(live_idx, g0, g1)
        kg, ku, anis = kept_pairs(mat, pg, pu, size, k, j_thr, clock)
        bounds = np.searchsorted(kg, np.arange(g0, g1 + 1))
        with clock.stage("index-write"):
            for n, (p, _) in enumerate(got):
                g = g0 + n
                lo, hi = bounds[n], bounds[n + 1]
                rows = [(int(u), g, float(v))
                        for u, v in zip(ku[lo:hi], anis[lo:hi])]
                key = index_store.genome_key(p, idx.sketch_params)
                idx.append_genome(g, p, key)
                idx.append_sketch(g, hashes[n])
                idx.append_pairs(rows)
                state.genomes.append(p)
                state.keys.append(key)
                state.sketches.append(hashes[n])
                for u, gg, v in rows:
                    state.pairs[(u, gg)] = v
        # this batch's records are durable: a stop here leaves the
        # index loadable at the prior generation
        interrupt.check("index-batch-saved")
    counts = screen_new_genomes(state, new_start, params["ani"])
    with clock.stage("index-write"):
        generation = idx.commit(state)
    logger.info(
        "Inserted %d genome(s) into %s: generation %d, %d clusters "
        "(%d new rep(s), %d reassigned)", len(fresh), idx.path,
        generation, len(state.reps), counts["new_reps"],
        counts["reassigned"])
    counts.update({"inserted": len(fresh), "skipped": skipped})
    return _publish(state, "insert", counts)


def query(idx: IndexStore, paths: Sequence[str], device="cuda",
          cache_dir: Optional[str] = None, threads: int = 1,
          clock: Optional[StageClock] = None) -> List[Dict[str, Any]]:
    """Which cluster each genome would join, against the committed
    state; writes nothing. A genome joins its argmax-ANI live
    representative (reps ascending, the first strictly greater wins)
    if that ANI reaches the cluster threshold, and would found a new
    cluster otherwise. The (query, live rep) pairs take one device
    pass."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    state = idx.load()
    params = idx.params
    size, k = params["sketch_size"], params["k"]
    j_thr = ani_to_jaccard(params["precluster_ani"], k)
    reps = [r for r in state.reps if r not in state.tombstones]
    sk_store = _sketch_store(params, device, cache_dir, clock)
    wanted = [os.path.abspath(p) for p in paths]
    sketches = {p: np.asarray(sk.hashes, dtype=np.uint64)
                for p, sk in iter_insert_sketches(wanted, sk_store, threads)}
    unique = list(sketches)
    with clock.stage("index-load"):
        mat = sketch_rows([state.sketches[r] for r in reps]
                          + [sketches[p] for p in unique], size, device)
    n_r = len(reps)
    # the query is the first (staged) row of its pairs, as in insert
    pq = np.repeat(np.arange(n_r, n_r + len(unique), dtype=np.int64), n_r)
    pr = np.tile(np.arange(n_r, dtype=np.int64), len(unique))
    kq, kr, anis = kept_pairs(mat, pq, pr, size, k, j_thr, clock)
    hits: Dict[str, List[Tuple[int, float]]] = {p: [] for p in unique}
    for qi, ri, v in zip(kq.tolist(), kr.tolist(), anis.tolist()):
        hits[unique[qi - n_r]].append((reps[ri], v))
    out: List[Dict[str, Any]] = []
    for p in wanted:
        best_r, best_ani = None, None
        for r, v in hits[p]:
            if best_ani is None or v > best_ani:
                best_r, best_ani = r, v
        joins = best_ani is not None and best_ani >= params["ani"]
        out.append({
            "path": p,
            "decision": "member" if joins else "novel",
            "rep": state.genomes[best_r] if joins else None,
            "rep_index": best_r if joins else None,
            "ani": best_ani,
            "candidates": len(hits[p]),
        })
    return out


def remove(idx: IndexStore, path: str) -> Dict[str, Any]:
    """Tombstone one genome and repair only its own cluster: a removed
    representative's cluster re-elects its lowest-index remaining
    member; every other cluster is untouched."""
    state = idx.begin_mutation()
    if state.generation == 0:
        raise ValueError(
            f"index at {idx.path} has no committed generation; run "
            "`galah-tpu index build` first")
    rp = os.path.realpath(path)
    target = next((g for g, p in enumerate(state.genomes)
                   if os.path.realpath(p) == rp
                   and g not in state.tombstones), None)
    if target is None:
        raise ValueError(f"{path} is not a live genome of the index "
                         f"at {idx.path}")
    state.tombstones.add(target)
    reelected: Optional[int] = None
    if target in state.membership:
        del state.membership[target]
    else:  # a representative: local re-election
        orphans = sorted(g for g, r in state.membership.items()
                         if r == target)
        state.reps = [r for r in state.reps if r != target]
        if orphans:
            reelected = orphans[0]
            state.membership.pop(reelected)
            state.reps = sorted(state.reps + [reelected])
            for g in orphans[1:]:
                state.membership[g] = reelected
    generation = idx.commit(state)
    logger.info(
        "Removed genome %d (%s) from %s: generation %d%s", target, rp,
        idx.path, generation,
        f", re-elected {reelected}" if reelected is not None else "")
    return _publish(state, "remove",
                    {"removed": target, "reelected": reelected})
