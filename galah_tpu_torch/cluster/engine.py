"""Two-stage greedy clustering engine: the port of
``galah_tpu/cluster/engine.py``, with its overlapped dataflow, its
round-based device strategy, the slab folds and the host scan.

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
With ``GALAH_TPU_GREEDY_STRATEGY=host`` each precluster takes that
host-order scan instead (``find_representatives`` at
``rep_scan_window``, then ``find_memberships``; preclusters of at most
``DENSE_PRECLUSTER_CAP`` members compute all their hit pairs first).
The decisions are the same either way.

The overlapped dataflow (``_cluster_overlapped``,
``GALAH_TPU_OVERLAP``): for a fresh finch run whose precluster pass
streams (``MinHashPreclusterer.distances_streamed``), the rounds run
while the sketch stream is still producing. When the stream has
screened rows [0, r1), every hit edge of a genome below r1 is known,
so windows at fixed boundaries [0, w), [w, 2w), ... are decided as
soon as r1 reaches their end, exactly as the stage-serial rounds
decide them; pairs with a committed rep endpoint go to speculative
exact-ANI batches (the same pairs the stage-serial rounds compute,
earlier). Membership waits for the end of the stream. Nothing durable
is written while the stream is live: the distances and one greedy-round
record follow the quiesce (``_finish_overlapped``).

The slab folds (``ops/megakernel.py``, ``GALAH_TPU_MEGAKERNEL``):
consecutive ready windows fuse into one slab whose hit edges go into
the device pair queue (``ops/device_queue.py``) and are folded in one
``slab_fold.cu`` launch. A slab whose edges do not fit the queue takes
the dense per-window fold (``megakernel-overflow-spills``).

No fallback: where ``galah_tpu`` under ``auto`` demotes a failed
overlapped run, device round or slab fold to a slower route, the port
raises, under ``auto`` exactly as under ``1``. Under ``auto`` a run the
overlapped engine cannot take (a resume, another precluster, the host
strategy) is routed to the stage-serial engine before any work; under
``1`` that raises with ``galah_tpu``'s messages.

With a checkpoint (``cluster/checkpoint.py``) the distance pass, each
round's backend-computed ANIs and each finished precluster reach the
disk as they are made, and a resume skips or replays them. A stop
requested by a signal (``resilience/interrupt.py``) is honoured only
at three boundaries, each right after its state is durable:
``distances-saved``, ``greedy-round-saved`` and ``precluster-saved``;
never inside a kernel launch or a profile group. A resume is always
stage-serial.

In a multi-process job (``parallel/distributed.py``) every rank runs
the same rounds, and each backend ANI batch is split over the ranks
(``_backend_ani_batch``) and exchanged. Each batch (a rank's share in a
job) is a guarded call at the dispatch site ``dispatch.ani``
(``resilience/dispatch.py``): retried, then raised.
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
from galah_tpu_torch.config import env_value
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.obs import flow as obs_flow
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.obs import profile as obs_profile
from galah_tpu_torch.ops import greedy_select
from galah_tpu_torch.parallel import distributed
from galah_tpu_torch.resilience import dispatch as rdispatch
from galah_tpu_torch.resilience import interrupt
from galah_tpu_torch.timing import StageClock, Stopwatch

logger = logging.getLogger(__name__)

# The overlapped dataflow consumes the precluster pair stream as it
# arrives (GL10xx) and reports how busy it kept its downstream stages
# (speculative fragment-ANI, eager greedy rounds).
PIPELINE_STAGE = {
    "streaming": ["_cluster_overlapped"],
    "occupancy_gauge": "workload.pipeline_occupancy",
}

#: Preclusters up to this many members compute every hit pair's exact
#: ANI in one batch before the host scan.
DENSE_PRECLUSTER_CAP = 64

# Materialization sub-rounds per window: bounds the rep-chain depth a
# window resolves on the device; deeper windows are conflict windows
# (greedy_select.FOLD_ITERS is kept at 2x this).
MAX_SUBROUNDS = 16

# Unique-genome cap per backend batch of a round: bounds the profile
# working set one batch pins at once.
ROUND_BATCH_GENOMES = 64

# Host-scan speculative batch width: genomes per window evaluated
# against all current reps in one backend call (--rep-scan-window).
REP_SCAN_WINDOW = 128

OVERLAP_MODES = ("auto", "0", "1")


def cluster(
    genomes: Sequence[str],
    preclusterer,
    clusterer,
    device="cuda",
    rep_rounds: Optional[int] = None,
    clock: Optional[StageClock] = None,
    checkpoint=None,
    rep_scan_window: Optional[int] = None,
) -> List[List[int]]:
    """Cluster quality-ordered genome paths -> list of index clusters,
    each with its representative first; clusters ordered by precluster
    (biggest first) then by representative index. `checkpoint`, a
    ``cluster.checkpoint.ClusterCheckpoint``, persists the run and
    resumes from what it holds; its reads and writes are stages
    ``checkpoint-read`` and ``checkpoint-write``. `rep_rounds` is the
    device rounds' width, `rep_scan_window` the host scan's."""
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
    strategy, _explicit = greedy_select.resolve_greedy_strategy()
    from galah_tpu_torch.ops.megakernel import resolve_megakernel

    if resolve_megakernel()[0] == "1" and strategy != "device":
        raise RuntimeError(
            "GALAH_TPU_MEGAKERNEL=1 requires the device greedy "
            f"strategy; GALAH_TPU_GREEDY_STRATEGY pins {strategy!r}"
            " — the fused slab fold only exists inside device "
            "rounds")
    pre_cache = None
    if checkpoint:
        with clock.stage("checkpoint-read"):
            pre_cache = checkpoint.load_distances()
    overlap_state = None
    if pre_cache is None:
        overlap_state = _maybe_cluster_overlapped(
            genomes, preclusterer, clusterer, skip_clusterer, checkpoint,
            rep_rounds, strategy, device, clock)
        if overlap_state is not None:
            pre_cache = overlap_state.pre_cache
            obs_profile.sample_memory("overlap-dataflow")
        else:
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
    clock.count(f"greedy-strategy-{strategy}", 1)
    if pending and (overlap_state is not None or strategy == "device"):
        with clock.stage("greedy"):
            if overlap_state is not None:
                finished = _finish_overlapped(
                    overlap_state, genomes, clusterer, pending,
                    skip_clusterer, device, checkpoint, clock)
            else:
                finished = _cluster_pending_rounds(
                    clusterer, genomes, pre_cache, pending,
                    skip_clusterer, rep_rounds, device, checkpoint, clock)
        done.update(finished)
        if checkpoint:
            with clock.stage("checkpoint-write"):
                for pc_index, global_clusters in sorted(finished.items()):
                    checkpoint.save_precluster(pc_index, global_clusters)
                checkpoint.clear_greedy_rounds()
        # safe boundary: every precluster's clusters are durable
        interrupt.check("precluster-saved")
    elif pending:
        for pc_index, members in pending:
            with clock.stage("greedy"):
                global_clusters = _host_scan_precluster(
                    clusterer, pre_cache, genomes, members,
                    skip_clusterer, rep_scan_window, clock)
            done[pc_index] = global_clusters
            if checkpoint:
                with clock.stage("checkpoint-write"):
                    checkpoint.save_precluster(pc_index, global_clusters)
            # safe boundary: this precluster's clusters are durable — a
            # resume recomputes only the preclusters after it
            interrupt.check("precluster-saved")
    all_clusters: List[List[int]] = []
    for pc_index in range(len(preclusters)):
        all_clusters.extend(done[pc_index])
    obs_profile.sample_memory("greedy-cluster")
    logger.info("Found %d clusters", len(all_clusters))
    return all_clusters


def _host_scan_precluster(clusterer, pre_cache: PairDistanceCache,
                          genomes: Sequence[str], members: Sequence[int],
                          skip_clusterer: bool,
                          rep_scan_window: Optional[int],
                          clock: StageClock) -> List[List[int]]:
    """One precluster through the host strategy: the dense warm pass
    (small preclusters, when the methods differ), the host-order rep
    scan and the membership argmax; its waste counted by the phase
    that paid for each pair. Returns its clusters in global ids."""
    local_cache = pre_cache.transform_ids(members)
    local_genomes = [genomes[g] for g in members]
    warm_cache = None
    if not skip_clusterer and len(members) <= DENSE_PRECLUSTER_CAP:
        warm_cache = _warm_all_hit_pairs(clusterer, local_cache,
                                         local_genomes)
    computed: List[Tuple[int, int]] = []
    consulted: Set[Tuple[int, int]] = set()
    reps, ani_cache = find_representatives(
        clusterer, local_cache, local_genomes, skip_clusterer,
        rep_scan_window, warm_cache=warm_cache, computed=computed,
        consulted=consulted)
    n_rep_computed = len(computed)
    local_clusters = find_memberships(
        clusterer, reps, local_cache, local_genomes, ani_cache,
        skip_clusterer, warm_cache=warm_cache, computed=computed,
        consulted=consulted)
    rep_keys = {pair_key(*p) for p in computed[:n_rep_computed]}
    mem_keys = {pair_key(*p) for p in computed[n_rep_computed:]} \
        - rep_keys
    warm_keys = (set(warm_cache.keys()) - rep_keys - mem_keys
                 if warm_cache is not None else set())
    computed_keys = rep_keys | mem_keys | warm_keys
    _count_waste(clock, len(computed_keys),
                 rep=len(rep_keys - consulted),
                 membership=len(mem_keys - consulted),
                 warm=len(warm_keys - consulted))
    return [[members[i] for i in c] for c in local_clusters]


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
    warm_cache: Optional[PairDistanceCache] = None,
) -> List[Optional[float]]:
    """ANI for index pairs: the precluster value when the methods match
    (reference: src/clusterer.rs:264-279), then a `warm_cache` of
    exact ANIs computed up front, else one batched backend call for the
    missing pairs, which are appended to `computed_log` when it is
    given."""
    out: List[Optional[float]] = [None] * len(pairs)
    to_compute: List[Tuple[int, Tuple[str, str]]] = []
    for n, (i, j) in enumerate(pairs):
        if skip_clusterer and pre_cache.contains((i, j)):
            out[n] = pre_cache.get((i, j))
        elif warm_cache is not None and warm_cache.contains((i, j)):
            out[n] = warm_cache.get((i, j))
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
    makes every rank raise. In one process, one guarded call
    (``_guarded_ani_batch``); in a job, each rank's local batch is
    guarded, never the exchange."""
    n_proc = distributed.process_count()
    if n_proc <= 1 or len(path_pairs) < n_proc:
        return _guarded_ani_batch(clusterer, path_pairs)
    owners = [zlib.crc32(b.encode()) for _a, b in path_pairs]
    return distributed.sharded_optional_floats(
        len(path_pairs),
        lambda idxs: _guarded_ani_batch(
            clusterer, [path_pairs[k] for k in idxs]),
        owner=lambda k: owners[k])


def _guarded_ani_batch(clusterer, path_pairs: List[Tuple[str, str]]
                       ) -> List[Optional[float]]:
    """The backend's batched ANI call at the dispatch site
    ``dispatch.ani`` (``resilience/dispatch.py``): retried on a
    transient failure or a result out of [0, 1], then raised; there is
    no per-pair fallback (``galah_tpu``'s ``_guarded_ani_batch``)."""
    return rdispatch.run(
        "dispatch.ani",
        lambda: clusterer.calculate_ani_batch(path_pairs),
        validate=rdispatch.expect_ani_values(len(path_pairs)))


def _warm_all_hit_pairs(clusterer, pre_cache: PairDistanceCache,
                        genomes: Sequence[str]) -> PairDistanceCache:
    """Exact ANI for every precluster-hit pair in one batch."""
    keys = sorted(pre_cache.keys())
    warm = PairDistanceCache()
    if keys:
        anis = _backend_ani_batch(
            clusterer, [(genomes[i], genomes[j]) for i, j in keys])
        for key, ani in zip(keys, anis):
            warm.insert(key, ani)
    return warm


class _RoundState:
    """The ANI cache, the computed log and the batch closure of a run
    of device rounds, shared by the stage-serial and the overlapped
    engines."""

    def __init__(self, clusterer, genomes: Sequence[str],
                 pre_cache: PairDistanceCache, skip_clusterer: bool
                 ) -> None:
        self.clusterer = clusterer
        self.genomes = genomes
        self.pre_cache = pre_cache
        self.skip_clusterer = skip_clusterer
        self.ani_cache = PairDistanceCache()
        self.computed: List[Tuple[int, int]] = []  # pairs the backend saw
        self.consulted: Set[Tuple[int, int]] = set()  # pairs a rep
        # decision read

    def batch(self, pairs: List[Tuple[int, int]]) -> int:
        """Compute the pairs missing from the cache, in chunks of at
        most ROUND_BATCH_GENOMES unique genomes (pair order kept);
        returns how many were missing."""
        seen: Set[Tuple[int, int]] = set()
        uniq: List[Tuple[int, int]] = []
        for p in pairs:
            k = pair_key(*p)
            if k in seen or self.ani_cache.contains(p):
                continue
            seen.add(k)
            uniq.append(p)
        chunk: List[Tuple[int, int]] = []
        chunk_genomes: Set[int] = set()

        def flush() -> None:
            if not chunk:
                return
            anis = _batch_ani(self.clusterer, self.skip_clusterer,
                              self.pre_cache, self.genomes, chunk,
                              computed_log=self.computed)
            for p, ani in zip(chunk, anis):
                self.ani_cache.insert(p, ani)
            chunk.clear()
            chunk_genomes.clear()

        for p in uniq:
            if chunk and len(chunk_genomes | set(p)) > \
                    ROUND_BATCH_GENOMES:
                flush()
            chunk.append(p)
            chunk_genomes.update(p)
        flush()
        return len(uniq)

    def value(self, i: int, j: int) -> Optional[float]:
        """The decision value of a hit pair, with ``_batch_ani``'s
        precedence: the precluster value when the methods match, else
        the computed exact ANI (None when absent or gated)."""
        if self.skip_clusterer and self.pre_cache.contains((i, j)):
            return self.pre_cache.get((i, j))
        return self.ani_cache.get((i, j))


class _MegaCtx:
    """The slab folds' run state: the pair queue, its capacity, and the
    seconds of the folds' device brackets, which the greedy stage's
    recorded service excludes (the flow's host-blame split)."""

    def __init__(self, cap: int, queue) -> None:
        self.cap = cap
        self.queue = queue
        self.dev_busy = 0.0


def _megakernel_ctx(device: torch.device,
                    stage_serial: bool = False) -> Optional[_MegaCtx]:
    """The slab-fold context of one run, or None where it does not
    engage: under ``auto`` only in the overlapped engine (the
    stage-serial rounds keep one fold, one durable record and one
    preemption boundary a window), under ``1`` in every device round,
    never under ``0``."""
    from galah_tpu_torch.ops import device_queue
    from galah_tpu_torch.ops.megakernel import resolve_megakernel

    mode, _explicit = resolve_megakernel()
    if mode == "0" or (stage_serial and mode != "1"):
        return None
    cap = device_queue.resolve_queue_cap()
    return _MegaCtx(cap, device_queue.PairQueue(cap, device))


def _grow_slab(seq, pos: int, width: int, adj: Dict[int, List[int]],
               cap: int, ready_limit: Optional[int] = None) -> List[int]:
    """Fuse up to ``megakernel.SLAB_WINDOWS`` consecutive round windows
    from ``pos`` into one slab while the intra-slab hit-edge count stays
    within the queue capacity (every hit pair counts; the enqueued set,
    non-None values only, is a subset, so a fitting estimate never
    overflows). The rounds are width-invariant, so the slab decides as
    its windows would. ``ready_limit`` (the overlapped engine's
    resolved prefix) stops growth at a window not yet final."""
    from galah_tpu_torch.ops.megakernel import SLAB_WINDOWS

    n = len(seq)
    window = list(seq[pos:pos + width])
    # membership tests only (never iterated): hash order cannot leak
    slab_members = set(window)
    edges = sum(1 for g in window
                for t in adj[g] if t in slab_members) // 2
    k = 1
    while k < SLAB_WINDOWS:
        nstart = pos + len(window)
        if nstart >= n:
            break
        nend = min(nstart + width, n)
        if ready_limit is not None and ready_limit < nend:
            break
        nxt = list(seq[nstart:nend])
        nxt_members = set(nxt)
        grown = sum(1 for g in nxt for t in adj[g] if t in slab_members)
        grown += sum(1 for g in nxt for t in adj[g]
                     if t in nxt_members) // 2
        if edges + grown > cap:
            break
        edges += grown
        window += nxt
        slab_members |= nxt_members
        k += 1
    return window


def _megakernel_fold(mega: _MegaCtx, window: List[int],
                     win_pos: Dict[int, int], adj: Dict[int, List[int]],
                     ext: np.ndarray, value, thr: float,
                     clock: StageClock):
    """The slab's materialized hit edges through the pair queue and one
    ``slab_fold.cu`` launch (``ops/megakernel.slab_select``), in place
    of one dense fold a window. Returns ``(rep_flags, converged)``, or
    ``(None, False)`` when the slab spilled over the queue's capacity:
    the caller then takes the exact dense path."""
    from galah_tpu_torch.ops import megakernel as mk

    ei: List[int] = []
    ej: List[int] = []
    ev: List[float] = []
    for wi, g in enumerate(window):
        for t in adj[g]:
            ti = win_pos.get(t)
            if ti is None or ti <= wi:
                continue
            v = value(g, t)
            if v is None:
                continue
            ei.append(wi)
            ej.append(ti)
            ev.append(v)
    if len(ei) > mega.cap:
        clock.count("megakernel-overflow-spills", 1)
        return None, False
    with obs_flow.blocked("greedy", "device-dispatch") as bdev:
        rep, converged = mk.slab_select(
            mega.queue, np.asarray(ei, dtype=np.int32),
            np.asarray(ej, dtype=np.int32),
            np.asarray(ev, dtype=np.float64), ext, thr, clock)
    mega.dev_busy += bdev.seconds
    if rep is None:
        clock.count("megakernel-overflow-spills", 1)
        return None, False
    clock.count("megakernel-slab-folds", 1)
    return rep, converged


def _overlap_mode() -> str:
    mode = (env_value("GALAH_TPU_OVERLAP") or "auto").strip().lower()
    if mode not in OVERLAP_MODES:
        logger.warning("ignoring malformed GALAH_TPU_OVERLAP=%r "
                       "(want auto/0/1)", mode)
        return "auto"
    return mode


def _overlap_depth() -> int:
    try:
        return max(1, int(env_value("GALAH_TPU_OVERLAP_DEPTH") or 512))
    except ValueError:
        logger.warning("ignoring malformed GALAH_TPU_OVERLAP_DEPTH")
        return 512


class _OverlapState:
    """What the streaming phase hands to the finish after the quiesce:
    the complete pair cache, the greedy decisions made over the arrived
    prefix, and the round state whose batch and values the membership
    pass shares."""

    def __init__(self, n: int, rounds: _RoundState) -> None:
        self.pre_cache = rounds.pre_cache
        self.adj: Dict[int, List[int]] = {g: [] for g in range(n)}
        self.rounds = rounds
        self.batch = rounds.batch
        self.rep_order: List[int] = []
        self.rep_set: Set[int] = set()
        self.eager_rounds = 0


def _maybe_cluster_overlapped(genomes: Sequence[str], preclusterer,
                              clusterer, skip_clusterer: bool, checkpoint,
                              rep_rounds: Optional[int], strategy: str,
                              device: torch.device, clock: StageClock
                              ) -> Optional[_OverlapState]:
    """The overlapped dataflow's state when it engages, else None for
    the stage-serial engine.

    It engages (``GALAH_TPU_OVERLAP`` auto or 1) on a fresh run (no
    completed preclusters: a resume is stage-serial, its saved state
    makes the recompute free), with the device greedy strategy, where
    the preclusterer's ``distances_streamed`` takes the workload. Under
    auto the rest is routed to the stage-serial engine before any
    work; under 1 it raises. A failure raises under either."""
    mode = _overlap_mode()
    if mode == "0":
        return None
    forced = mode == "1"
    if checkpoint:
        with clock.stage("checkpoint-read"):
            completed = checkpoint.load_completed()
        if completed:
            # a resume is stage-serial by design, even when forced
            return None
    if strategy != "device":
        if forced:
            raise RuntimeError(
                "GALAH_TPU_OVERLAP=1 requires the device greedy "
                f"strategy; GALAH_TPU_GREEDY_STRATEGY pins {strategy!r}")
        return None
    streamed = getattr(preclusterer, "distances_streamed", None)
    stream = streamed(genomes) if streamed is not None else None
    if stream is None:
        if forced:
            raise RuntimeError(
                "GALAH_TPU_OVERLAP=1 but the precluster backend "
                f"({preclusterer.method_name()}) did not engage its "
                "streamed pair pass for this workload")
        return None
    with clock.stage("overlap-dataflow"):
        st = _cluster_overlapped(genomes, clusterer, stream,
                                 skip_clusterer, rep_rounds, device, clock)
    clock.count("overlap-engaged", 1)
    return st


def _cluster_overlapped(genomes: Sequence[str], clusterer, stream,
                        skip_clusterer: bool, rep_rounds: Optional[int],
                        device: torch.device, clock: StageClock
                        ) -> _OverlapState:
    """Consume the streamed pair pass as one overlapped dataflow: while
    the sketch stream's read threads run ahead, this thread runs,
    between block arrivals, the pair stripes (inside the stream),
    speculative exact-ANI batches over survivor pairs with a committed
    rep endpoint, and the greedy rounds over the resolved prefix.

    Why eager decisions equal the stage-serial engine's: genome g's rep
    decision reads exactly the hit edges (i, g), i < g, and the rep
    status of those i. Once the stream has screened rows [0, r1), every
    such edge of every g < r1 is known, so decisions over the prefix
    are final. Windows run at fixed boundaries as soon as r1 reaches
    their end, grouped by the live union-find component of the hit
    graph (a hit pair's endpoints are joined when the edge arrives, so
    the current roots cover every edge a decision can read). Membership
    waits for the end of the stream: a later rep can still win a
    non-rep's argmax.

    Speculation: a survivor pair goes to the exact-ANI buffer iff one
    endpoint is already a committed rep, when the edge arrives for an
    earlier rep and when a window commits new reps (the back-offer).
    Every backend pair the rounds and the membership compute has a rep
    endpoint, so the offered set is the stage-serial computed set: the
    speculation moves batches earlier and adds none. The buffer
    launches at ``GALAH_TPU_OVERLAP_DEPTH`` pending pairs.

    Nothing durable is written while the stream is live; this returns
    once the stream is drained and every window decided."""
    thr = clusterer.ani_threshold
    width = (int(rep_rounds) if rep_rounds is not None
             else greedy_select.DEFAULT_ROUND_WIDTH)
    if width < 1:
        raise ValueError(f"rep_rounds must be >= 1, got {width}")
    depth = _overlap_depth()
    n = len(genomes)
    rounds = _RoundState(clusterer, genomes, PairDistanceCache(),
                         skip_clusterer)
    st = _OverlapState(n, rounds)
    pre_cache, adj, rep_set = st.pre_cache, st.adj, st.rep_set
    ani_cache = rounds.ani_cache

    # a union-find over arrived hit edges: current roots group the window
    # genomes with every rep a candidate edge can reach
    parent = list(range(n))

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    frag_busy = [0.0]    # speculative batches' wall
    greedy_busy = [0.0]  # windows' wall net of nested batches

    def batch(pairs: List[Tuple[int, int]]) -> int:
        """The round state's batch, with the fragment stage's flow
        record and busy seconds."""
        watch = Stopwatch()
        fid = obs_flow.begin("fragment_batch")
        items = rounds.batch(pairs)
        dt = watch.seconds()
        frag_busy[0] += dt
        obs_flow.record_service("fragment", dt, items=items)
        obs_flow.complete(fid)
        return items

    st.batch = batch
    hist = obs_metrics.histogram(
        "greedy.round_seconds",
        help="Wall-clock of one device-strategy selection round "
             "(speculative dispatch + frontier sub-rounds + window "
             "fold)", unit="s")
    rounds_c = obs_metrics.counter(
        "greedy.rounds",
        help="Device-strategy selection rounds run", unit="rounds")
    eager_c = obs_metrics.counter(
        "overlap.eager_rounds",
        help="Greedy device rounds run while the sketch stream was "
             "still producing (the overlapped engine's eager windows)",
        unit="rounds")
    spec_c = obs_metrics.counter(
        "overlap.spec_pairs",
        help="Survivor pairs offered to the speculative fragment-ANI "
             "buffer", unit="pairs")

    # the speculative exact-ANI buffer: survivor pairs with a committed
    # rep endpoint, launched when `depth` accumulate
    spec: List[Tuple[int, int]] = []
    offered: Set[Tuple[int, int]] = set()
    stats = {"offered": 0, "batches": 0, "peak": 0}

    def flush_spec() -> None:
        if not spec:
            return
        stats["batches"] += 1
        batch(spec)
        spec.clear()

    def offer(pair: Tuple[int, int]) -> None:
        k = pair_key(*pair)
        if k in offered or ani_cache.contains(pair):
            return
        if skip_clusterer and pre_cache.contains(pair):
            return  # the precluster value is reused: never computed
        offered.add(k)
        spec.append(pair)
        stats["offered"] += 1
        stats["peak"] = max(stats["peak"], len(spec))
        if len(spec) >= depth:
            flush_spec()

    frontier = [0]  # the next undecided window's start: the prefix is final
    mega = _megakernel_ctx(device)
    seq_all = range(n)
    run_watch = Stopwatch()

    def run_ready_windows(r1: int) -> None:
        while frontier[0] < n:
            end = min(frontier[0] + width, n)
            if r1 < end:
                return
            if mega is not None:
                # fuse every consecutive window already final into one
                # slab; growth stops at the resolved prefix, so no
                # window waits for the stream
                window = _grow_slab(seq_all, frontier[0], width, adj,
                                    mega.cap, ready_limit=r1)
                end = frontier[0] + len(window)
            else:
                window = list(range(frontier[0], end))
            n_windows = (len(window) + width - 1) // width
            watch = Stopwatch()
            fid = obs_flow.begin("greedy_round")
            fb0 = frag_busy[0]
            db0 = mega.dev_busy if mega is not None else 0.0
            pc_of = {g: find(g) for g in window}
            reps_by_pc: Dict[int, List[int]] = {}
            for r in st.rep_order:
                reps_by_pc.setdefault(find(r), []).append(r)
            for g in window:
                reps_by_pc.setdefault(pc_of[g], [])
            with hist.time(), clock.stage("greedy"):
                _device_round(window, pc_of, adj, reps_by_pc, rep_set,
                              batch, rounds.value, rounds.consulted, thr,
                              device, clock, mega=mega)
            clock.count("greedy-rounds", 1)
            rounds_c.inc()
            clock.count("overlap-eager-rounds", n_windows)
            eager_c.inc(n_windows)
            st.eager_rounds += n_windows
            # _device_round appends reps in window order, and every
            # window genome was undecided before, so the window genomes
            # now in rep_set ARE this round's commits, in order
            new_reps = [g for g in window if g in rep_set]
            st.rep_order.extend(new_reps)
            # the back-offer: every hit pair of a fresh rep is one a later
            # candidate row or the membership argmax will read
            for r in new_reps:
                for t in adj[r]:
                    offer((r, t))
            frontier[0] = end
            dev_dt = mega.dev_busy - db0 if mega is not None else 0.0
            dt = watch.seconds() - (frag_busy[0] - fb0) - dev_dt
            greedy_busy[0] += dt
            obs_flow.record_service("greedy", dt)
            obs_flow.complete(fid)
            # refreshed as the rounds go: the heartbeat samples a series
            wall_now = max(run_watch.seconds(), 1e-9)
            obs_metrics.pipeline_occupancy(
                min(1.0, greedy_busy[0] / wall_now), stage="greedy")
            if not skip_clusterer:
                obs_metrics.pipeline_occupancy(
                    min(1.0, frag_busy[0] / wall_now), stage="fragment")

    stream_it = iter(stream)
    while True:
        # blocked on the pair stream: the greedy stage's upstream-empty
        # wait, which `flow analyze` forwards to the producer's blame
        with obs_flow.blocked("greedy", "upstream-empty"):
            try:
                r1, inc = next(stream_it)
            except StopIteration:
                break
        obs_flow.absorb("pairs", "greedy")
        for (a, b), v in inc.items():
            pre_cache.insert((a, b), v)
            adj[a].append(b)
            adj[b].append(a)
            parent[find(a)] = find(b)
            if a in rep_set:
                offer((a, b))
        run_ready_windows(r1)
    if frontier[0] < n:
        raise RuntimeError(
            f"overlapped stream ended with the greedy frontier at "
            f"{frontier[0]} of {n} genomes")
    flush_spec()

    clock.count("overlap-spec-pairs", stats["offered"])
    clock.count("overlap-spec-batches", stats["batches"])
    spec_c.inc(stats["offered"])
    obs_metrics.gauge(
        "overlap.spec_pending_peak",
        help="High-water mark of the speculative fragment-ANI buffer "
             "(bounded by GALAH_TPU_OVERLAP_DEPTH)",
        unit="pairs").set(float(stats["peak"]))

    # each stage's occupancy over the streaming phase's wall, and the
    # mean of the run's per-stage gauges as the unlabelled gauge
    wall = max(run_watch.seconds(), 1e-9)
    obs_metrics.pipeline_occupancy(greedy_busy[0] / wall, stage="greedy")
    if not skip_clusterer:
        obs_metrics.pipeline_occupancy(frag_busy[0] / wall,
                                       stage="fragment")
    prefix = obs_metrics.PIPELINE_OCCUPANCY_GAUGE + "["
    vals = [m["value"] for name, m in obs_metrics.snapshot().items()
            if name.startswith(prefix) and m.get("value") is not None]
    if vals:
        obs_metrics.pipeline_occupancy(sum(vals) / len(vals))
    return st


def _finish_overlapped(st: _OverlapState, genomes: Sequence[str],
                       clusterer, pending: List[Tuple[int, Sequence[int]]],
                       skip_clusterer: bool, device: torch.device,
                       checkpoint, clock: StageClock
                       ) -> Dict[int, List[List[int]]]:
    """After the quiesce: every ANI the streaming phase computed goes
    into ONE digest-bound greedy-round record (a stop after it resumes
    stage-serial and replays them with no dispatch), then the
    membership pass and the per-precluster assembly run as in the
    stage-serial rounds; the decisions were made while streaming."""
    rounds = st.rounds
    pc_of: Dict[int, int] = {}
    for pc, members in pending:
        for g in members:
            pc_of[g] = pc
    reps_by_pc: Dict[int, List[int]] = {pc: [] for pc, _ in pending}
    for r in st.rep_order:
        if r in pc_of:
            reps_by_pc[pc_of[r]].append(r)

    digest = _greedy_digest(pending)
    if checkpoint and rounds.computed:
        with clock.stage("checkpoint-write"):
            checkpoint.save_greedy_round(
                digest, [(i, j, rounds.ani_cache.get((i, j)))
                         for i, j in rounds.computed])
    # safe boundary: the streaming phase's ANIs are durable; a
    # stage-serial resume replays them and derives every decision again
    interrupt.check("greedy-round-saved")
    return _memberships(rounds, st.adj, pending, reps_by_pc, st.rep_set,
                        pc_of, device, clock, batch=st.batch)


def _memberships(rounds: _RoundState, adj: Dict[int, List[int]],
                 pending: List[Tuple[int, Sequence[int]]],
                 reps_by_pc: Dict[int, List[int]], rep_set: Set[int],
                 pc_of: Dict[int, int], device: torch.device,
                 clock: StageClock, batch=None
                 ) -> Dict[int, List[List[int]]]:
    """The membership pass of the device rounds: one batch (`batch`,
    by default the round state's) for every (rep, non-rep) hit pair,
    the device argmax per precluster, then the waste, split by the
    phase that paid for each pair. Returns {precluster index -> its
    global clusters}."""
    pre_cache, computed = rounds.pre_cache, rounds.computed
    todo: List[Tuple[int, int]] = []
    for a, b in pre_cache.keys():
        if a not in pc_of:
            continue
        a_rep, b_rep = a in rep_set, b in rep_set
        if a_rep == b_rep:
            continue  # rep-rep and non-rep pairs decide no membership
        # (rep, non-rep); the (genome, rep) sort keeps the host scan's
        # batch order
        r, i = (a, b) if a_rep else (b, a)
        if not (rounds.skip_clusterer and pre_cache.contains((i, r))) \
                and not rounds.ani_cache.contains((i, r)):
            todo.append((r, i))
    todo.sort(key=lambda p: (p[1], p[0]))
    n_rep_computed = len(computed)
    (batch or rounds.batch)(todo)

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
                    v = rounds.value(g, r)
                    if v is not None:
                        mat[gi, c] = v
            best, has = greedy_select.membership_argmax(mat, device)
            for gi, g in enumerate(nonreps):
                if not has[gi]:
                    raise RuntimeError(
                        f"genome {rounds.genomes[g]} passed the "
                        "representative test but has no ANI to any "
                        "representative — inconsistent backend")
                clusters[int(best[gi])].append(g)
        results[pc] = clusters

    # the membership argmax reads every cached (non-rep, rep) pair, so a
    # computed key joining a rep and a non-rep was read
    computed_keys = {pair_key(*p) for p in computed}
    # galah-lint: ignore[GL902] a set built from a set, read only for its size
    mem_consulted = {k for k in computed_keys
                     if (k[0] in rep_set) != (k[1] in rep_set)}
    live = rounds.consulted | mem_consulted
    rep_keys = {pair_key(*p) for p in computed[:n_rep_computed]}
    mem_keys = {pair_key(*p) for p in computed[n_rep_computed:]} \
        - rep_keys
    _count_waste(clock, len(computed_keys), rep=len(rep_keys - live),
                 membership=len(mem_keys - live), warm=0)
    return results


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
    backend again. Under ``GALAH_TPU_MEGAKERNEL=1`` consecutive windows
    fuse into slabs (one record a slab)."""
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

    rounds = _RoundState(clusterer, genomes, pre_cache, skip_clusterer)
    reps_by_pc: Dict[int, List[int]] = {pc: [] for pc, _ in pending}
    rep_set: Set[int] = set()

    digest = _greedy_digest(pending)
    if checkpoint:
        with clock.stage("checkpoint-read"):
            for i, j, ani in checkpoint.load_greedy_rounds(digest):
                rounds.ani_cache.insert((i, j), ani)
                rounds.computed.append((i, j))
    if rounds.computed:
        clock.count("greedy-replayed-pairs", len(rounds.computed))

    mega = _megakernel_ctx(device, stage_serial=True)
    pos = 0
    while pos < len(seq):
        if mega is not None:
            window = _grow_slab(seq, pos, width, adj, mega.cap)
        else:
            window = seq[pos:pos + width]
        pos += len(window)
        rstart = len(rounds.computed)
        _device_round(window, pc_of, adj, reps_by_pc, rep_set,
                      rounds.batch, rounds.value, rounds.consulted, thr,
                      device, clock, mega=mega)
        clock.count("greedy-rounds", 1)
        if checkpoint and len(rounds.computed) > rstart:
            with clock.stage("checkpoint-write"):
                checkpoint.save_greedy_round(
                    digest, [(i, j, rounds.ani_cache.get((i, j)))
                             for i, j in rounds.computed[rstart:]])
        # safe boundary: this round's ANIs are durable; a resume replays
        # them and derives the same decisions without computing them
        interrupt.check("greedy-round-saved")
    return _memberships(rounds, adj, pending, reps_by_pc, rep_set, pc_of,
                        device, clock)


def _count_waste(clock: StageClock, n_computed: int, rep: int,
                 membership: int, warm: int) -> None:
    """The exact ANIs computed and those no greedy decision read, the
    waste split by the phase that paid for it (``galah_tpu``'s
    ``_emit_waste_counters``; the warm share is the host strategy's
    dense pass)."""
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
    clock: StageClock,
    mega: Optional[_MegaCtx] = None,
) -> None:
    """Resolve one K-genome window (or a slab of them); commits new reps
    into reps_by_pc.

    (1) one batch of window x existing-rep hit pairs and the derived
    already-clustered flags; (2) bounded frontier sub-rounds that
    materialize the intra-window pairs the decisions depend on (the
    first undecided genome of every segment is provably the next rep);
    (3) the device fold as the authoritative decision, cross-checked
    against the sub-round bookkeeping: with `mega`, a complete slab's
    fold goes through the pair queue and one ``slab_fold.cu`` launch,
    else (or when the slab spills) one dense window fold. A window the
    budget cannot finish completes its undecided tail on the exact
    host-order scan. Every pair a decision reads is added to
    `consulted`.
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
    n_sub = 0
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
        n_sub += 1
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
    clock.count("greedy-subrounds", n_sub)

    # a fold decides only over a completely materialized matrix: a
    # missing edge would read as no edge
    complete = bool(decided.all())
    rep_flags = None
    if complete and mega is not None:
        rep_flags, converged = _megakernel_fold(
            mega, window, win_pos, adj, ext, value, thr, clock)
        if rep_flags is not None and (
                not converged or not np.array_equal(rep_flags, tentative)):
            raise RuntimeError(
                "megakernel slab fold disagreed with the exact "
                "sub-round bookkeeping — refusing speculative "
                "greedy decisions")
    if rep_flags is None:
        mat = np.full((w, w), np.nan, dtype=np.float64)
        for wi, g in enumerate(window):
            for t in adj[g]:
                ti = win_pos.get(t)
                if ti is None or ti <= wi:
                    continue
                v = value(g, t)
                if v is not None:
                    mat[wi, ti] = v
        clock.count("greedy-select-dispatches", 1)
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
        clock.count("greedy-conflict-windows", 1)
        clock.count("greedy-host-fallback-windows", 1)
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
    rep_scan_window: Optional[int] = REP_SCAN_WINDOW,
    warm_cache: Optional[PairDistanceCache] = None,
    computed: Optional[List[Tuple[int, int]]] = None,
    consulted: Optional[Set[Tuple[int, int]]] = None,
) -> Tuple[Set[int], PairDistanceCache]:
    """The per-precluster host-order representative scan (reference:
    src/clusterer.rs:155-225) on local ids: genome i is a rep iff no
    current rep with a precluster hit has exact ANI >= threshold, reps
    tried in ascending precluster-ANI order.

    The scan is sequential but ANI values are not, so a window of
    `rep_scan_window` upcoming genomes is evaluated against all current
    reps in one batch, and only pairs against reps that emerge inside
    the window need follow-up batches; the decisions are the
    per-genome scan's. `warm_cache` holds ANIs computed up front;
    `computed` gets the pairs that reached the backend and `consulted`
    the pairs a decision read (the waste accounting's inputs)."""
    reps: Set[int] = set()
    ani_cache = PairDistanceCache()
    thr = clusterer.ani_threshold
    n = len(genomes)
    window_size = (int(rep_scan_window) if rep_scan_window is not None
                   else REP_SCAN_WINDOW)
    if window_size < 1:
        raise ValueError(
            f"rep_scan_window must be >= 1, got {window_size}")
    def ensure_anis(pairs: List[Tuple[int, int]]) -> None:
        missing = [(j, g) for j, g in pairs
                   if not ani_cache.contains((j, g))]
        if not missing:
            return
        anis = _batch_ani(clusterer, skip_clusterer, pre_cache, genomes,
                          missing, computed_log=computed,
                          warm_cache=warm_cache)
        for (j, g), ani in zip(missing, anis):
            ani_cache.insert((j, g), ani)

    for w0 in range(0, n, window_size):
        window = range(w0, min(w0 + window_size, n))
        # order is irrelevant here: ensure_anis only fills the cache
        # galah-lint: ignore[GL902] fills a cache; no order reaches a result
        rep_list = list(reps)
        ensure_anis([(j, g) for g in window for j in rep_list
                     if pre_cache.contains((g, j))])
        for i in window:
            cands = [(j, pre_cache.get((i, j))) for j in sorted(reps)
                     if pre_cache.contains((i, j))]
            # ascending by precluster ANI, as the reference sorts
            cands.sort(key=lambda t: t[1] if t[1] is not None else -1.0)
            # reps that emerged inside the window were not in its batch
            ensure_anis([(j, i) for j, _ in cands])
            is_rep = True
            for j, _ in cands:
                ani = ani_cache.get((j, i))
                if consulted is not None:
                    consulted.add(pair_key(j, i))
                if ani is not None and ani >= thr:
                    is_rep = False
                    break
            if is_rep:
                reps.add(i)
                # the new rep is a candidate for the rest of the window
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
    warm_cache: Optional[PairDistanceCache] = None,
    computed: Optional[List[Tuple[int, int]]] = None,
    consulted: Optional[Set[Tuple[int, int]]] = None,
) -> List[List[int]]:
    """Assign every non-rep to its argmax-ANI rep, ties to the lowest
    rep index (reference: src/clusterer.rs:316-406), on local ids; one
    batch for every (genome, rep) hit pair still missing."""
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
    anis = _batch_ani(clusterer, skip_clusterer, pre_cache, genomes, todo,
                      computed_log=computed, warm_cache=warm_cache)
    for (r, i), ani in zip(todo, anis):
        ani_cache.insert((r, i), ani)
    for i in range(len(genomes)):
        if i in reps:
            continue
        best_rep, best_ani = None, None
        for r in rep_list:
            ani = ani_cache.get((i, r))
            if consulted is not None:
                consulted.add(pair_key(i, r))
            if ani is not None and (best_ani is None or ani > best_ani):
                best_rep, best_ani = r, ani
        if best_rep is None:
            raise RuntimeError(
                f"genome {genomes[i]} passed the representative test but "
                "has no ANI to any representative — inconsistent backend")
        clusters[rep_to_cluster[best_rep]].append(i)
    return clusters
