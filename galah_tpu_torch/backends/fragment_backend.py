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
on the calling thread, the only one that touches CUDA. With a disk
cache (``io/diskcache.py``, ``--sketch-cache``) the profile arrays also
persist across runs, as ``galah_tpu``'s entries of kind ``profile``: a
cached genome is loaded onto the device instead of being read and
profiled.
"""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.backends.base import ClusterBackend, PreclusterBackend
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io import diskcache, group
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.io.prefetch import (ingest_depth, iter_batches,
                                         iter_prefetched)
from galah_tpu_torch.ops import fragment_ani
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.fragment_ani import GenomeProfile
from galah_tpu_torch.ops.pairwise import screen_pairs
from galah_tpu_torch.ops.u64 import from_biased, to_biased
from galah_tpu_torch.timing import StageClock

logger = logging.getLogger(__name__)

ANI_KMER = 15


class ProfileStore:
    """LRU cache: genome path -> GenomeProfile on `device`, over an
    optional disk cache (`cache`; by default the one
    ``GALAH_TPU_CACHE`` names, if any). Profiles keep only the k-mers
    whose hash is below 2^64 / `subsample_c` (``--ani-subsample``)."""

    def __init__(self, device="cuda", k: int = ANI_KMER,
                 fraglen: int = Defaults.FRAGMENT_LENGTH,
                 maxsize: int = 128,
                 clock: Optional[StageClock] = None,
                 hash_algorithm: str = Defaults.HASH_ALGO,
                 threads: int = 1,
                 cache: Optional[diskcache.CacheDir] = None,
                 subsample_c: int = Defaults.ANI_SUBSAMPLE) -> None:
        fragment_ani.check_subsample(subsample_c)
        self.device = resolve_device(device)
        self.threads = max(1, int(threads))
        self.k = k
        self.fraglen = fraglen
        self.subsample_c = int(subsample_c)
        self.hash_algorithm = hash_algorithm
        self.maxsize = maxsize
        self.clock = clock or StageClock(self.device)
        self.disk = cache or diskcache.get_cache(clock=self.clock)
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

    def _params(self) -> dict:
        # galah_tpu keys only non-default knobs, so its default-path
        # entries keep their names
        p = {"k": self.k, "fraglen": self.fraglen}
        if self.subsample_c != 1:
            p["subsample_c"] = self.subsample_c
        if self.hash_algorithm != "murmur3":
            p["hash_algorithm"] = self.hash_algorithm
        return p

    def _load_disk(self, path: str) -> Optional[GenomeProfile]:
        entry = self.disk.load(path, "profile", self._params())
        if entry is None:
            return None
        return GenomeProfile(
            path=path, k=self.k, fraglen=self.fraglen,
            flat_hashes=to_biased(entry["flat_hashes"], self.device),
            ref_set=to_biased(entry["ref_set"], self.device),
            markers=to_biased(entry["markers"], self.device),
            subsample_c=self.subsample_c)

    def _store_disk(self, path: str, prof: GenomeProfile) -> None:
        self.disk.store(path, "profile", self._params(), {
            "flat_hashes": from_biased(prof.flat_hashes),
            "ref_set": from_biased(prof.ref_set),
            "markers": from_biased(prof.markers),
        })

    def get_many(self, paths: Sequence[str]) -> List[GenomeProfile]:
        """Profiles of `paths`; those neither in memory nor in the disk
        cache are read ahead and profiled in path order, a group at a
        time, and stored to the disk cache. The `read` stage is the
        consumer's wait for a read, ``work_seconds["read"]`` the
        workers' reading time, the `profile` stage each group's build,
        `cache-read` and `cache-write` the disk cache's loads and
        stores."""
        by_path = {}
        misses = []
        for p in dict.fromkeys(paths):
            prof = self._cache.get(p)
            if prof is not None:
                self._cache.move_to_end(p)
                by_path[p] = prof
            else:
                misses.append(p)
        if self.disk.enabled and misses:
            unheld, misses = misses, []
            with self.clock.stage("cache-read"):
                for p in unheld:
                    prof = self._load_disk(p)
                    if prof is None:
                        misses.append(p)
                    else:
                        self._insert(p, prof)
                        by_path[p] = prof
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
                    device=self.device, subsample_c=self.subsample_c,
                    hash_algorithm=self.hash_algorithm)
            self.clock.count("profile-groups", 1)
            # galah_tpu's hash.batched_genomes: its long genomes take
            # the per-genome route
            self.clock.count("profile-batched-genomes", sum(
                g.codes.shape[0] <= group.ALONE_ABOVE for g in genomes))
            if self.disk.enabled:
                with self.clock.stage("cache-write"):
                    for (p, _), prof in zip(batch, profs):
                        self._store_disk(p, prof)
            for (p, _), prof in zip(batch, profs):
                self._insert(p, prof)
                by_path[p] = prof
        return [by_path[p] for p in paths]


def _exact_ani(clock: StageClock,
               pairs: Sequence[Tuple[GenomeProfile, GenomeProfile]],
               min_aligned_fraction: float) -> List[Optional[float]]:
    """Gated bidirectional ANI of profile pairs, in stage `exact-ani`;
    counts `directed_queries` and `query-elements`, the sorted-query
    hashes that window_hits tests (about 1/c of them under
    ``--ani-subsample c``)."""
    with clock.stage("exact-ani"):
        clock.count("directed_queries", 2 * len(pairs))
        anis = fragment_ani.bidirectional_ani_values(pairs,
                                                     min_aligned_fraction)
    clock.count("query-elements", sum(
        int(q.sorted_query()[0].shape[0]) for pair in pairs for q in pair
        if q.n_windows))
    return anis


class _FragmentANIMixin(ClusterBackend):
    def __init__(self, threshold: float, min_aligned_fraction: float,
                 store: ProfileStore) -> None:
        self._threshold = float(threshold)
        self.min_aligned_fraction = float(min_aligned_fraction)
        self.store = store

    @property
    def ani_threshold(self) -> float:
        return self._threshold

    def _batch_results(self, pairs: Sequence[Tuple[str, str]]
                       ) -> List[Optional[float]]:
        unique = list(dict.fromkeys(p for pair in pairs for p in pair))
        with self.store.reserve(len(unique)):
            by_path = dict(zip(unique, self.store.get_many(unique)))
        return _exact_ani(self.store.clock,
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


class SkaniPreclusterer(PreclusterBackend):
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
                                 self.SCREEN_IDENTITY ** self.store.k,
                                 clock=clock)
        clock.count("screened_pairs", len(pairs))
        logger.info("%d pairs passed screening; computing exact ANI ..",
                    len(pairs))
        anis = _exact_ani(clock, [(profiles[i], profiles[j])
                                  for i, j in pairs],
                          self.min_aligned_fraction)
        cache = PairDistanceCache()
        for (i, j), ani in zip(pairs, anis):
            if ani is not None and ani >= self.threshold:
                cache.insert((i, j), ani)
        logger.info("Found %d pairs passing precluster threshold %.4f",
                    len(cache), self.threshold)
        return cache
