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
engine consumes block by block and ``distances`` drains). Otherwise the
whole sketch matrix goes through ``ops/pairwise.threshold_pairs`` (the
collision screen plus the pairlist kernel from the crossover up). In a
multi-process job (``parallel/distributed.py``) each rank sketches its
strided shard of the genomes and the rows are exchanged; the stream is
not taken there, as in ``galah_tpu``, and the pair pass is split over
the ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import torch

from galah_tpu_torch.backends.base import PreclusterBackend
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io import diskcache
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops import collision, sketch_stream
from galah_tpu_torch.ops.constants import SENTINEL_U64
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


class SketchStore:
    """Per-run cache: genome path -> MinHash sketch, held in memory,
    over an optional disk cache (`cache`; by default the one
    ``GALAH_TPU_CACHE`` names, if any)."""

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

    def _params(self) -> dict:
        # galah_tpu's names: the seed is the finch contract's, fixed here
        return {"sketch_size": self.sketch_size, "k": self.k,
                "seed": Defaults.MINHASH_SEED, "algo": self.algo}

    def get_cached(self, path: str) -> Optional[MinHashSketch]:
        """The sketch from memory or the disk cache (no FASTA read)."""
        s = self._sketches.get(path)
        if s is not None:
            return s
        entry = self.cache.load(path, "minhash", self._params())
        if entry is None:
            return None
        s = MinHashSketch(hashes=entry["hashes"],
                          sketch_size=self.sketch_size, kmer=self.k)
        self._sketches[path] = s
        return s

    def insert(self, path: str, s: MinHashSketch) -> MinHashSketch:
        """Hold a computed sketch, and store it to the disk cache (stage
        `cache-write`)."""
        if self.cache.enabled:
            with self.clock.stage("cache-write"):
                self.cache.store(path, "minhash", self._params(),
                                 {"hashes": s.hashes})
        self._sketches[path] = s
        return s

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
        process, unique paths, below the sparse crossover; None
        otherwise. The stripes go over ``parallel/mesh.auto_mesh`` of
        the store's device, as the staged pass's do."""
        store = self.store
        n = len(genome_paths)
        if (distributed.process_count() > 1
                or n >= collision.SPARSE_SCREEN_MIN_N
                or len(dict.fromkeys(genome_paths)) != n):
            return None
        logger.info("Streaming all-pairs Mash ANI behind the reads ..")
        blocks = iter_sketch_row_blocks(genome_paths, store, self.threads)
        return iter_threshold_pairs_streamed(
            blocks, n, store.k, self.min_ani, store.sketch_size,
            store.clock, block=sketch_stream.ROW_BLOCK,
            mesh=pmesh.auto_mesh(store.device))

    def distances(self, genome_paths: Sequence[str]) -> PairDistanceCache:
        store = self.store
        logger.info("Sketching MinHash representations of %d genomes "
                    "on %s ..", len(genome_paths), store.device)
        # the stream's rows are the unique paths, and the sparse pass
        # from the crossover up needs the whole matrix, as does a
        # multi-process job's exchange of sketch rows
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
