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
and sketched (``ops/pairwise.threshold_pairs_streamed``). Otherwise the
whole sketch matrix goes through ``ops/pairwise.threshold_pairs`` (the
collision screen plus the pairlist kernel from the crossover up).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from galah_tpu_torch.backends.base import PreclusterBackend
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io import diskcache
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops import collision, sketch_stream
from galah_tpu_torch.ops.minhash import sketch_matrix
from galah_tpu_torch.ops.minhash_np import MinHashSketch
from galah_tpu_torch.ops.pairwise import (threshold_pairs,
                                          threshold_pairs_streamed)
from galah_tpu_torch.ops.sketch_stream import (iter_path_sketches,
                                               iter_sketch_row_blocks,
                                               sketch_genomes_fused)
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

    def distances(self, genome_paths: Sequence[str]) -> PairDistanceCache:
        store = self.store
        logger.info("Sketching MinHash representations of %d genomes "
                    "on %s ..", len(genome_paths), store.device)
        n = len(genome_paths)
        # the stream's rows are the unique paths, and the sparse pass
        # from the crossover up needs the whole matrix
        if (n < collision.SPARSE_SCREEN_MIN_N
                and len(dict.fromkeys(genome_paths)) == n):
            logger.info("Streaming all-pairs Mash ANI behind the reads ..")
            blocks = iter_sketch_row_blocks(genome_paths, store,
                                            self.threads)
            pairs = threshold_pairs_streamed(
                blocks, n, store.k, self.min_ani,
                store.sketch_size, store.clock,
                block=sketch_stream.ROW_BLOCK)
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
