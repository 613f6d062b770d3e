"""The dashing (HyperLogLog) precluster on the device: the port of
``galah_tpu/backends/hll_backend.py``.

The reference runs the dashing binary and parses its N x N distance
matrix (reference: src/dashing.rs:11-100). Here every genome's HLL
registers are built on the device (``ops/hll.hll_sketch_genomes``, the
murmur3_k21 kernel hashing on the card), held in memory by an
``HLLStore``, and the upper triangle is thresholded on the device
(``ops/hll.hll_threshold_pairs``, the hll_union kernel); only the
passing pairs reach the host. With a disk cache (``--sketch-cache``)
the registers persist as ``galah_tpu``'s entries of kind ``hll``.
Reading goes through the streaming stage
of the finch sketches (``ops/sketch_stream.iter_path_sketches``,
``ingest_depth(threads)`` reads in flight). In a multi-process job each
rank sketches its strided shard and the registers are exchanged
(``parallel/distributed.py``); the pair pass is split over the ranks.
``galah_tpu``'s resilient dispatch is not ported (ROADMAP).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from galah_tpu_torch.backends.base import PreclusterBackend
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io import diskcache
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops.hll import (DEFAULT_P, hll_sketch_genomes,
                                     hll_threshold_pairs)
from galah_tpu_torch.ops.sketch_stream import iter_path_sketches
from galah_tpu_torch.parallel import distributed
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)


class HLLStore:
    """Per-run cache: genome path -> (2^p,) uint8 registers on the
    device, held in memory, over an optional disk cache (`cache`; by
    default the one ``GALAH_TPU_CACHE`` names, if any)."""

    #: the store's guarded dispatch site (``ops/sketch_stream``)
    DISPATCH_SITE = "dispatch.sketch-hll"

    def __init__(self, device="cuda", p: int = DEFAULT_P,
                 k: int = Defaults.MINHASH_KMER,
                 algo: str = Defaults.HASH_ALGO,
                 clock: Optional[StageClock] = None,
                 cache: Optional[diskcache.CacheDir] = None) -> None:
        self.device = resolve_device(device)
        self.p = p
        self.k = k
        self.algo = algo
        self.clock = clock or StageClock(self.device)
        self.cache = cache or diskcache.get_cache(clock=self.clock)
        self._regs: Dict[str, torch.Tensor] = {}

    def _params(self) -> dict:
        # galah_tpu's names: the seed is the finch contract's, fixed here
        return {"p": self.p, "k": self.k, "seed": Defaults.MINHASH_SEED,
                "algo": self.algo}

    def get_cached(self, path: str) -> Optional[torch.Tensor]:
        """The registers from memory or the disk cache (no FASTA
        read)."""
        regs = self._regs.get(path)
        if regs is not None:
            return regs
        entry = self.cache.load(path, "hll", self._params())
        if entry is None:
            return None
        regs = torch.from_numpy(entry["regs"]).to(self.device)
        self._regs[path] = regs
        return regs

    def insert(self, path: str, regs: torch.Tensor) -> torch.Tensor:
        """Hold computed registers, and store them to the disk cache
        (stage `cache-write`)."""
        if self.cache.enabled:
            with self.clock.stage("cache-write"):
                self.cache.store(path, "hll", self._params(),
                                 {"regs": regs.cpu().numpy()})
        self._regs[path] = regs
        return regs

    def sketch_group(self, genomes: Sequence[Genome]):
        """Registers of a launch group's genomes, one row each."""
        return list(hll_sketch_genomes(genomes, self.p, self.k, self.algo,
                                       self.device, self.clock))


class HLLPreclusterer(PreclusterBackend):
    def __init__(self, min_ani: float, store: HLLStore,
                 threads: int = 1) -> None:
        self.min_ani = float(min_ani)
        self.store = store
        self.threads = max(1, int(threads))

    def method_name(self) -> str:
        return "dashing"

    def _regs_multihost(self, genome_paths: Sequence[str]) -> torch.Tensor:
        """Each rank sketches its strided shard of the unique genomes and
        the (4 KB) register rows are exchanged into the same matrix on
        every rank (``distributed.allgather_host_rows``)."""
        store = self.store
        unique = list(dict.fromkeys(genome_paths))
        mine = distributed.host_shard(unique)
        by_path = dict(iter_path_sketches(mine, store, self.threads))
        local = (torch.stack([by_path[p] for p in mine]).cpu().numpy()
                 if mine else np.zeros((0, 1 << store.p), np.uint8))
        full = distributed.allgather_host_rows(len(unique), local,
                                               fill=np.uint8(0))
        index = {path: i for i, path in enumerate(unique)}
        return torch.from_numpy(
            full[[index[p] for p in genome_paths]]).to(store.device)

    def distances(self, genome_paths: Sequence[str]) -> PairDistanceCache:
        store = self.store
        logger.info("Sketching HLL registers of %d genomes on %s ..",
                    len(genome_paths), store.device)
        if distributed.process_count() > 1:
            regs = self._regs_multihost(genome_paths)
        else:
            by_path = dict(iter_path_sketches(genome_paths, store,
                                              self.threads))
            regs = torch.stack([by_path[p] for p in genome_paths]) \
                if genome_paths else torch.zeros(
                    0, 1 << store.p, dtype=torch.uint8,
                    device=store.device)
        logger.info("Computing tiled all-pairs HLL ANI ..")
        with store.clock.stage("pair-stats"):
            pairs = hll_threshold_pairs(regs, store.k, self.min_ani)
        store.clock.count("precluster-pairs", len(pairs))
        cache = PairDistanceCache()
        for (i, j), ani in pairs.items():
            cache.insert((i, j), ani)
        logger.info("Found %d pairs passing precluster threshold %.4f",
                    len(cache), self.min_ani)
        return cache
