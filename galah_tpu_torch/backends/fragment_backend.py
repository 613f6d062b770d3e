"""Exact-ANI cluster backends and the skani-style preclusterer on the
fragment kernel: the port of ``galah_tpu/backends/fragment_backend.py``.

* ``SkaniPreclusterer`` — marker-containment screen over all pairs,
  then exact fragment ANI on the screened pairs only (reference:
  src/skani.rs:33-106).
* ``SkaniEquivalentClusterer`` — a gated pair is ANI 0.0, never None
  (reference: src/skani.rs:108-129).
* ``FastANIEquivalentClusterer`` — a gated pair is None (reference:
  src/fastani.rs:26-73).

Profiles are built once per genome and held in an in-memory LRU
``ProfileStore`` on the run's device. Its misses are read ahead on
``ingest_depth(threads)`` worker threads
(``io/prefetch.iter_prefetched``) and profiled a group at a time
(``io/prefetch.iter_batches``, ``ops/fragment_ani.build_profiles_batch``)
on the calling thread, the only one that touches CUDA.
``galah_tpu``'s disk-cache probe is not ported (ROADMAP).
"""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.io import group
from galah_tpu_torch.io.prefetch import (ingest_depth, iter_batches,
                                         iter_prefetched)
from galah_tpu_torch.ops import fragment_ani
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.fragment_ani import GenomeProfile
from galah_tpu_torch.ops.pairwise import screen_pairs
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

ANI_KMER = 15


class ProfileStore:
    """LRU cache: genome path -> GenomeProfile on `device`."""

    def __init__(self, device="cuda", k: int = ANI_KMER,
                 fraglen: int = Defaults.FRAGMENT_LENGTH,
                 maxsize: int = 128,
                 clock: Optional[StageClock] = None,
                 hash_algorithm: str = Defaults.HASH_ALGO,
                 threads: int = 1) -> None:
        self.device = resolve_device(device)
        self.threads = max(1, int(threads))
        self.k = k
        self.fraglen = fraglen
        self.hash_algorithm = hash_algorithm
        self.maxsize = maxsize
        self.clock = clock or StageClock(self.device)
        self._cache: "collections.OrderedDict[str, GenomeProfile]" = (
            collections.OrderedDict())

    @contextlib.contextmanager
    def reserve(self, n: int):
        """Grow the LRU to a batch's working set for the batch, then
        restore the bound and evict the overflow."""
        old = self.maxsize
        self.maxsize = max(self.maxsize, n)
        try:
            yield
        finally:
            self.maxsize = old
            while len(self._cache) > self.maxsize:
                self._cache.popitem(last=False)

    def _insert(self, path: str, prof: GenomeProfile) -> None:
        self._cache[path] = prof
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)

    def get_many(self, paths: Sequence[str]) -> List[GenomeProfile]:
        """Profiles of `paths`; misses are read ahead and profiled in
        path order, a group at a time. The `read` stage is the
        consumer's wait for a read, ``work_seconds["read"]`` the
        workers' reading time, the `profile` stage each group's build."""
        by_path = {}
        misses = []
        for p in dict.fromkeys(paths):
            prof = self._cache.get(p)
            if prof is not None:
                self._cache.move_to_end(p)
                by_path[p] = prof
            else:
                misses.append(p)
        reads = self.clock.waits(
            iter_prefetched(misses, self.clock.timed(read_genome, "read"),
                            depth=ingest_depth(self.threads)),
            "read", "genomes-read")
        for batch in iter_batches(reads, lambda g: g.codes.shape[0],
                                  fragment_ani.PROFILE_BATCH_BUDGET,
                                  group.ALONE_ABOVE):
            genomes = [g for _, g in batch]
            with self.clock.stage("profile"):
                profs = fragment_ani.build_profiles_batch(
                    genomes, k=self.k, fraglen=self.fraglen,
                    device=self.device, hash_algorithm=self.hash_algorithm)
            self.clock.count("profile-groups", 1)
            # galah_tpu's hash.batched_genomes: its long genomes take
            # the per-genome route
            self.clock.count("profile-batched-genomes", sum(
                g.codes.shape[0] <= group.ALONE_ABOVE for g in genomes))
            for (p, _), prof in zip(batch, profs):
                self._insert(p, prof)
                by_path[p] = prof
        return [by_path[p] for p in paths]


class _FragmentANIMixin:
    def __init__(self, threshold: float, min_aligned_fraction: float,
                 store: ProfileStore) -> None:
        self.ani_threshold = float(threshold)
        self.min_aligned_fraction = float(min_aligned_fraction)
        self.store = store

    def _batch_results(self, pairs: Sequence[Tuple[str, str]]
                       ) -> List[Optional[float]]:
        unique = list(dict.fromkeys(p for pair in pairs for p in pair))
        with self.store.reserve(len(unique)):
            by_path = dict(zip(unique, self.store.get_many(unique)))
        with self.store.clock.stage("exact-ani"):
            self.store.clock.count("directed_queries", 2 * len(pairs))
            return fragment_ani.bidirectional_ani_values(
                [(by_path[a], by_path[b]) for a, b in pairs],
                self.min_aligned_fraction)


class FastANIEquivalentClusterer(_FragmentANIMixin):
    def method_name(self) -> str:
        return "fastani"

    def calculate_ani_batch(self, pairs: Sequence[Tuple[str, str]]
                            ) -> List[Optional[float]]:
        return self._batch_results(pairs)


class SkaniEquivalentClusterer(_FragmentANIMixin):
    def method_name(self) -> str:
        return "skani"

    def calculate_ani_batch(self, pairs: Sequence[Tuple[str, str]]
                            ) -> List[Optional[float]]:
        # a gated-out pair is ANI 0.0, not None (reference:
        # src/skani.rs:126-129)
        return [ani if ani is not None else 0.0
                for ani in self._batch_results(pairs)]


class SkaniPreclusterer:
    """Marker screen on the device + exact fragment ANI on the
    screened pairs."""

    SCREEN_IDENTITY = 0.80  # reference: src/skani.rs:59 screen_refs(0.80,..)

    def __init__(self, threshold: float, min_aligned_fraction: float,
                 store: ProfileStore) -> None:
        self.threshold = float(threshold)
        self.min_aligned_fraction = float(min_aligned_fraction)
        self.store = store

    def method_name(self) -> str:
        return "skani"

    def marker_matrix(self, profiles: Sequence[GenomeProfile]
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """Markers padded to a common width (a multiple of 64) with the
        sentinel, and the per-genome marker counts."""
        n = len(profiles)
        m = -(-max(max((p.markers.shape[0] for p in profiles),
                       default=1), 1) // 64) * 64
        mat = torch.full((n, m), SENTINEL_BIASED, dtype=torch.int64,
                         device=self.store.device)
        counts = np.zeros(n, dtype=np.int64)
        for i, p in enumerate(profiles):
            cnt = p.markers.shape[0]
            mat[i, :cnt] = p.markers
            counts[i] = cnt
        return mat, counts

    def distances(self, genome_paths: Sequence[str]) -> PairDistanceCache:
        clock = self.store.clock
        n = len(genome_paths)
        logger.info("Profiling %d genomes for skani-style "
                    "preclustering ..", n)
        with self.store.reserve(n):
            profiles = self.store.get_many(genome_paths)
        mat, counts = self.marker_matrix(profiles)
        with clock.stage("screen"):
            pairs = screen_pairs(mat, counts,
                                 self.SCREEN_IDENTITY ** self.store.k)
        clock.count("screened_pairs", len(pairs))
        logger.info("%d pairs passed screening; computing exact ANI ..",
                    len(pairs))
        with clock.stage("exact-ani"):
            clock.count("directed_queries", 2 * len(pairs))
            anis = fragment_ani.bidirectional_ani_values(
                [(profiles[i], profiles[j]) for i, j in pairs],
                self.min_aligned_fraction)
        cache = PairDistanceCache()
        for (i, j), ani in zip(pairs, anis):
            if ani is not None and ani >= self.threshold:
                cache.insert((i, j), ani)
        logger.info("Found %d pairs passing precluster threshold %.4f",
                    len(cache), self.threshold)
        return cache
