"""The finch precluster on the device: the port of
``galah_tpu/backends/minhash_backend.py``.

Semantics of the reference's FinchPreclusterer (reference:
src/finch.rs:4-73): sketch every genome (bottom-k 1000, k=21, seed 0),
all-pairs Mash ANI, keep the pairs at or above the threshold. Sketches
come from the streaming fused sketcher (``ops/sketch_stream``) and are
held in memory by a ``SketchStore`` and, with a disk cache
(``--sketch-cache``), persisted as ``galah_tpu``'s entries of kind
``minhash``. Below the sparse crossover, with
unique paths, the all-pairs pass is streamed: it takes the sketch rows
in blocks, one stripe at a time, while later genomes are still read
and sketched (``distances_streamed``, a generator over
``ops/pairwise.iter_threshold_pairs_streamed`` that the overlapped
engine consumes block by block and ``distances`` drains). From the
crossover up (``GALAH_TPU_HLL_BUCKETS``: AUTO, or 1 at any size, when the
stream is declined) the pass is the cardinality-bucketed one
(``ops/bucketing.py``): HLL cardinalities in stage
`precluster-hll-cards` (the dashing store's registers, a read group a
murmur3_k21 launch, through its disk-cache entries of kind ``hll``),
then ``threshold_pairs`` over each band and the next; with the page
store's gate (``io/pagestore.py``) the sketches are kept in mmapped
pages and only the walked bands' rows are gathered and uploaded.
Otherwise the whole sketch matrix goes through
``ops/pairwise.threshold_pairs`` (the collision screen plus the
pairlist kernel from the crossover up). In a
multi-process job (``parallel/distributed.py``) each rank sketches its
strided shard of the genomes and the rows are exchanged; the stream is
not taken there, as in ``galah_tpu``, and the pair pass is split over
the ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import atexit
import logging
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from galah_tpu_torch.backends.base import PreclusterBackend
from galah_tpu_torch.backends.hll_backend import HLLStore
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io import diskcache, pagestore
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops import bucketing, collision, sketch_stream
from galah_tpu_torch.ops.constants import SENTINEL_U64
from galah_tpu_torch.ops.hll import DEFAULT_P, hll_cardinality
from galah_tpu_torch.ops.minhash import sketch_matrix, sketch_rows
from galah_tpu_torch.ops.minhash_np import MinHashSketch
from galah_tpu_torch.ops.pairwise import (iter_threshold_pairs_streamed,
                                          threshold_pairs)
from galah_tpu_torch.ops.sketch_stream import (iter_path_sketches,
                                               iter_sketch_row_blocks,
                                               sketch_genomes_fused)
from galah_tpu_torch.ops.u64 import from_biased, to_biased
from galah_tpu_torch.parallel import distributed
from galah_tpu_torch.parallel import mesh as pmesh
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

#: genomes whose registers the paged bucketed pass holds at a time for
#: their cardinalities (~2 MB of registers at p = 12)
HLL_CHUNK = 512


class SketchStore:
    """Per-run cache: genome path -> MinHash sketch, held in memory,
    over an optional disk cache (`cache`; by default the one
    ``GALAH_TPU_CACHE`` names, if any).

    With a page store attached (``io/pagestore.py``) the retained
    sketches live as rows of the mmap-backed store instead of the
    in-memory dict: ``get_cached`` hands back views of its rows, and
    the resident set is bounded by the store's budget. Either way the
    same sketches come back."""

    #: the store's guarded dispatch site (``ops/sketch_stream``)
    DISPATCH_SITE = "dispatch.sketch-minhash"

    def __init__(self, device="cuda",
                 sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
                 k: int = Defaults.MINHASH_KMER,
                 algo: str = Defaults.HASH_ALGO,
                 clock: Optional[StageClock] = None,
                 cache: Optional[diskcache.CacheDir] = None) -> None:
        self.device = resolve_device(device)
        self.sketch_size = sketch_size
        self.k = k
        self.algo = algo
        self.clock = clock or StageClock(self.device)
        self.cache = cache or diskcache.get_cache(clock=self.clock)
        self._sketches: Dict[str, MinHashSketch] = {}
        self.pagestore = None  # io/pagestore.SketchPageStore when paged

    def _params(self) -> dict:
        # galah_tpu's names: the seed is the finch contract's, fixed here
        return {"sketch_size": self.sketch_size, "k": self.k,
                "seed": Defaults.MINHASH_SEED, "algo": self.algo}

    def attach_pagestore(self, pagestore) -> None:
        """Keep sketches in a page store from now on: the dict's
        residents spill into it, later sketches append to it."""
        for path, s in self._sketches.items():
            pagestore.append(path, s.hashes)
        pagestore.flush()
        self._sketches.clear()
        self.pagestore = pagestore

    def _retain(self, path: str, s: MinHashSketch) -> MinHashSketch:
        if self.pagestore is not None:
            self.pagestore.append(path, s.hashes)
        else:
            self._sketches[path] = s
        return s

    def get_cached(self, path: str) -> Optional[MinHashSketch]:
        """The sketch from memory, the page store or the disk cache (no
        FASTA read)."""
        s = self._sketches.get(path)
        if s is not None:
            return s
        if self.pagestore is not None:
            hashes = self.pagestore.get(path)
            if hashes is not None:
                return MinHashSketch(hashes=hashes,
                                     sketch_size=self.sketch_size,
                                     kmer=self.k)
        entry = self.cache.load(path, "minhash", self._params())
        if entry is None:
            return None
        s = MinHashSketch(hashes=entry["hashes"],
                          sketch_size=self.sketch_size, kmer=self.k)
        return self._retain(path, s)

    def insert(self, path: str, s: MinHashSketch) -> MinHashSketch:
        """Hold a computed sketch, and store it to the disk cache (stage
        `cache-write`)."""
        if self.cache.enabled:
            with self.clock.stage("cache-write"):
                self.cache.store(path, "minhash", self._params(),
                                 {"hashes": s.hashes})
        return self._retain(path, s)

    def insert_prefiltered(self, path: str,
                           s: MinHashSketch) -> MinHashSketch:
        """Hold and cache a sketch the ingest prefilter resolved without
        the fused sketch (``ops/prefilter.py``): a duplicate's first
        occurrence's, or a degenerate genome's empty one. Stored like
        ``insert``'s; the prefilter's counters count it."""
        return self.insert(path, s)

    def sketch_group(self, genomes: Sequence[Genome]
                     ) -> List[MinHashSketch]:
        """Fused-kernel sketches of a launch group's genomes."""
        return sketch_genomes_fused(genomes, self.sketch_size, self.k,
                                    self.algo, self.device, self.clock)


class MinHashPreclusterer(PreclusterBackend):
    def __init__(self, min_ani: float, store: SketchStore,
                 threads: int = 1) -> None:
        self.min_ani = float(min_ani)
        self.store = store
        self.threads = max(1, int(threads))

    def method_name(self) -> str:
        return "finch"

    def _sketch_matrix_multihost(self, genome_paths: Sequence[str]
                                 ) -> torch.Tensor:
        """Each rank reads and sketches only its strided shard of the
        unique genomes; the sketch rows are exchanged
        (``distributed.allgather_host_rows``) into the same full matrix
        on every rank, so every rank's pair pass and decisions agree. K
        x 8 bytes a genome travel (8 KB at K = 1000)."""
        unique = list(dict.fromkeys(genome_paths))
        mine = distributed.host_shard(unique)
        by_path = dict(iter_path_sketches(mine, self.store, self.threads))
        local = sketch_rows([by_path[p].hashes for p in mine],
                            self.store.sketch_size, "cpu")
        full = distributed.allgather_host_rows(
            len(unique), from_biased(local), fill=SENTINEL_U64)
        index = {path: i for i, path in enumerate(unique)}
        return to_biased(full[[index[p] for p in genome_paths]],
                         self.store.device)

    def distances_streamed(self, genome_paths: Sequence[str]):
        """The pair pass as a stream: a generator of ``(r1,
        increment)``, one a block of arriving sketch rows
        (``ops/pairwise.iter_threshold_pairs_streamed``), the pair
        neighbourhood of the prefix [0, r1) complete at each yield; the
        overlapped engine (``cluster/engine.py``) decides greedy windows
        over it while later genomes are still read and sketched. Taken
        where the staged pass streams, and so gives the same pairs: one
        process, unique paths, below the sparse crossover, and the
        bucketed pass not engaged (it needs every cardinality before
        its first band); None otherwise. The stripes go over
        ``parallel/mesh.auto_mesh`` of the store's device, as the
        staged pass's do."""
        store = self.store
        n = len(genome_paths)
        if (distributed.process_count() > 1
                or n >= collision.SPARSE_SCREEN_MIN_N
                or len(dict.fromkeys(genome_paths)) != n
                or bucketing.bucketing_engaged(n)):
            return None
        logger.info("Streaming all-pairs Mash ANI behind the reads ..")
        blocks = iter_sketch_row_blocks(genome_paths, store, self.threads)
        return iter_threshold_pairs_streamed(
            blocks, n, store.k, self.min_ani, store.sketch_size,
            store.clock, block=sketch_stream.ROW_BLOCK,
            mesh=pmesh.auto_mesh(store.device))

    def _make_pagestore(self) -> pagestore.SketchPageStore:
        """The run's paged sketch store: a fresh directory under the
        disk cache (under TMPDIR when the cache is off), removed at
        exit, its short rows padded with the sentinel so gathered rows
        equal ``ops/minhash.sketch_matrix``'s."""
        base = self.store.cache.path if self.store.cache.enabled else None
        d = tempfile.mkdtemp(prefix="pagestore-", dir=base)
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        return pagestore.SketchPageStore(d, cols=self.store.sketch_size,
                                         fill=int(SENTINEL_U64))

    def _paged_sketch_rows(self, genome_paths: Sequence[str]
                           ) -> pagestore.PagedRowView:
        """Sketch into the page store and return the row view the band
        walk gathers from: the whole (N, K) matrix is never held, in
        memory or on the card."""
        ps = self._make_pagestore()
        self.store.attach_pagestore(ps)
        logger.info("Paged sketch retention engaged: %d genomes, %d MiB "
                    "resident budget", len(genome_paths),
                    ps.budget_bytes >> 20)
        for _p, _s in iter_path_sketches(genome_paths, self.store,
                                         self.threads):
            pass
        ps.flush()
        rids = np.empty(len(genome_paths), dtype=np.int64)
        for i, p in enumerate(genome_paths):
            rid = ps.rid_for(p)
            if rid is None:
                raise RuntimeError(f"paged sketch retention lost {p!r}")
            rids[i] = rid
        return pagestore.PagedRowView(ps, rids)

    def _hll_cardinalities(self, genome_paths: Sequence[str],
                           chunk: Optional[int] = None) -> np.ndarray:
        """(n,) f64 HLL cardinality estimates for the bucketed pass: the
        registers through the dashing store and its disk-cache entries
        of kind ``hll`` (``ops/hll.hll_sketch_genomes``, a read group a
        launch; with a disk cache, mostly the prefilter's pre-warmed
        entries), then ``hll_cardinality``. With `chunk` (the paged
        path) that many unique genomes' registers are held at a time,
        reduced and dropped; a cardinality reduces its own row only, so
        the values are the same."""
        store = self.store
        unique = list(dict.fromkeys(genome_paths))
        chunk = chunk or max(len(unique), 1)
        card_by_path: Dict[str, float] = {}
        for lo in range(0, len(unique), chunk):
            paths = unique[lo:lo + chunk]
            h = HLLStore(store.device, DEFAULT_P, store.k, store.algo,
                         store.clock, store.cache)
            by_path = dict(iter_path_sketches(paths, h, self.threads))
            cards = hll_cardinality(torch.stack(
                [by_path[q] for q in paths])).cpu().numpy()
            card_by_path.update(zip(paths, cards.astype(np.float64)))
        return np.array([card_by_path[q] for q in genome_paths],
                        dtype=np.float64)

    def distances(self, genome_paths: Sequence[str]) -> PairDistanceCache:
        store = self.store
        n = len(genome_paths)
        logger.info("Sketching MinHash representations of %d genomes "
                    "on %s ..", n, store.device)
        # the stream's rows are the unique paths, and the sparse pass
        # from the crossover up needs the whole matrix, as do the
        # bucketed pass and a multi-process job's exchange of rows
        stream = self.distances_streamed(genome_paths)
        if stream is not None:
            pairs: Dict = {}
            for _r1, inc in stream:
                pairs.update(inc)
        elif distributed.process_count() > 1:
            mat = self._sketch_matrix_multihost(genome_paths)
            logger.info("Computing all-pairs Mash ANI over %d ranks ..",
                        distributed.process_count())
            pairs = threshold_pairs(mat, store.k, self.min_ani,
                                    store.sketch_size, store.clock)
        elif bucketing.bucketing_engaged(n):
            pairs = self._bucketed_pairs(genome_paths)
        else:
            by_path = dict(iter_path_sketches(genome_paths, store,
                                              self.threads))
            mat = sketch_matrix([by_path[p] for p in genome_paths],
                                store.sketch_size, store.device)
            logger.info("Computing all-pairs Mash ANI ..")
            pairs = threshold_pairs(mat, store.k, self.min_ani,
                                    store.sketch_size, store.clock)
        cache = PairDistanceCache()
        for (i, j), ani in pairs.items():
            cache.insert((i, j), ani)
        logger.info("Found %d pairs passing precluster threshold %.4f",
                    len(cache), self.min_ani)
        return cache

    def _bucketed_pairs(self, genome_paths: Sequence[str]) -> Dict:
        """The cardinality-bucketed pass (``ops/bucketing.py``): the
        sketches (into the page store when its gate engages, so only
        bands b and b+1 are ever resident), the HLL cardinalities in
        stage `precluster-hll-cards`, then the band walk. Its pair dict
        equals the unbucketed pass's."""
        store = self.store
        n = len(genome_paths)
        paged = pagestore.pagestore_engaged(n, store.sketch_size)
        if paged:
            mat = self._paged_sketch_rows(genome_paths)
        else:
            by_path = dict(iter_path_sketches(genome_paths, store,
                                              self.threads))
            mat = sketch_matrix([by_path[p] for p in genome_paths],
                                store.sketch_size, store.device)
        logger.info("Computing cardinality-bucketed all-pairs Mash ANI ..")
        with store.clock.stage("precluster-hll-cards"):
            cards = self._hll_cardinalities(genome_paths,
                                            HLL_CHUNK if paged else None)
        return bucketing.bucketed_threshold_pairs(
            mat, cards, store.k, self.min_ani, store.sketch_size,
            p=DEFAULT_P, device=store.device, clock=store.clock)
