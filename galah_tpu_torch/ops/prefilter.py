"""The ingest prefilter of the finch sketch stream: the port of
``galah_tpu/ops/prefilter.py``.

It screens the genomes the stream has read before they reach the fused
sketcher (``ops/sketch_stream.iter_path_sketches``); the digest and the
window test of each genome run on the read thread that parsed it
(``screening``), and the decisions, in path order, on the stream's
consumer:

* **Duplicates.** A content digest (sha256 over the code array and the
  contig offsets) spots byte-identical genomes behind different paths.
  A MinHash sketch is a function of (codes, contig offsets, k), so the
  first occurrence's sketch is the duplicate's, bit for bit.
* **Degenerate genomes.** A genome with no valid k-mer window (every
  contig shorter than k, or no run of k unambiguous bases) has an empty
  k-mer set, so its sketch is empty; it takes no place in a launch
  group.
* **HLL pre-warm.** With a disk cache on, the HLL registers that the
  bucketed precluster reads later (``backends/minhash_backend``'s
  cardinalities, entries of kind ``hll`` keyed as the dashing store
  keys them) are computed while the group's codes are at hand: one
  ``ops/hll.hll_sketch_genomes`` call a read group, so one
  ``murmur3_k21`` launch a group on the card, its rows equal to
  per-genome ones. A kernel or launch failure raises; only a disk-cache
  ``OSError`` turns the pre-warm off with a warning, as in
  ``galah_tpu``.

A skip is taken only where the skipped genome's sketch provably equals
what the full pipeline would make, so the prefilter changes no sketch,
pair or cluster; its ``prefilter.*`` counters are the only difference.

Gate: ``GALAH_TPU_PREFILTER`` (auto / 0 / 1); auto engages in a
single-process run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from galah_tpu_torch import config
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops.minhash_np import MinHashSketch

logger = logging.getLogger(__name__)


def prefilter_mode() -> str:
    """The ``GALAH_TPU_PREFILTER`` tri-state: 'auto', '0' or '1'."""
    val = config.env_value("GALAH_TPU_PREFILTER") or "auto"
    return val if val in ("auto", "0", "1") else "auto"


def prefilter_engaged() -> bool:
    """'1' forces the prefilter, '0' disables it; 'auto' engages in a
    single-process run (a multi-process job reads a shard a rank, where
    a duplicate on another rank would not be seen anyway)."""
    mode = prefilter_mode()
    if mode == "0":
        return False
    if mode == "1":
        return True
    from galah_tpu_torch.parallel import distributed

    return distributed.process_count() == 1


def _digest(genome: Genome) -> str:
    """Content digest of a parsed genome: equal digests mean equal
    canonical k-mer multisets, hence equal sketches."""
    h = hashlib.sha256()
    h.update(memoryview(np.ascontiguousarray(genome.codes)))
    h.update(b"|")
    h.update(memoryview(np.ascontiguousarray(genome.contig_offsets)))
    return h.hexdigest()


def _has_valid_window(genome: Genome, k: int) -> bool:
    """True unless the genome provably has no valid k-mer window (no
    contig holds k consecutive unambiguous bases)."""
    codes = genome.codes
    offsets = genome.contig_offsets
    if codes.shape[0] < k:
        return False
    valid = codes != 255
    for c in range(offsets.shape[0] - 1):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        if hi - lo < k:
            continue
        run = valid[lo:hi]
        if run.all():
            return True
        # the longest run of valid bases, between ambiguous ones
        idx = np.flatnonzero(~run)
        edges = np.concatenate(([-1], idx, [run.shape[0]]))
        if int(np.diff(edges).max()) - 1 >= k:
            return True
    return False


@dataclasses.dataclass(frozen=True)
class Screened:
    """A read genome with its content digest and whether it has a valid
    k-mer window, found on the read thread."""

    genome: Genome
    digest: str
    has_window: bool


def screening(read: Callable[[str], Genome], k: int
              ) -> Callable[[str], Screened]:
    """`read`, followed on the same thread by the genome's digest and
    window test (pure functions of the genome; hashlib releases the
    interpreter lock over the codes)."""
    def read_screened(path: str) -> Screened:
        g = read(path)
        return Screened(g, _digest(g), _has_valid_window(g, k))
    return read_screened


class IngestPrefilter:
    """Screens the stream's read groups; resolves screened paths to
    their provably equal sketches in the merge walk.

    Both ``screen`` and ``resolve`` run on the stream's consumer thread,
    never at once."""

    def __init__(self, store, prewarm_hll: bool = True) -> None:
        self.store = store
        # the registers need somewhere durable to go
        self.prewarm_hll = prewarm_hll and store.cache.enabled
        self._by_digest: Dict[str, str] = {}      # digest -> first path
        self._aliases: Dict[str, str] = {}        # duplicate -> first path
        self._degenerate: Dict[str, MinHashSketch] = {}
        self._c_skipped = obs_metrics.counter(
            "prefilter.skipped", unit="genomes",
            help="genomes screened out of the full sketch pipeline by "
                 "the ingest prefilter (skips are provably "
                 "bit-identical: duplicates alias the first "
                 "occurrence's sketch, degenerate genomes have an "
                 "empty k-mer set)")
        self._c_dup = obs_metrics.counter(
            "prefilter.skipped_duplicate", unit="genomes",
            help="prefilter skips taken because the genome bytes "
                 "duplicate an earlier path")
        self._c_degen = obs_metrics.counter(
            "prefilter.skipped_degenerate", unit="genomes",
            help="prefilter skips taken because the genome has no "
                 "valid k-mer window")
        self._c_prewarm = obs_metrics.counter(
            "prefilter.hll_prewarmed", unit="genomes",
            help="HLL register rows computed during ingest and cached "
                 "for the bucketed precluster's cardinality pass")

    def screen(self, batch: Sequence[Tuple[str, Screened]]
               ) -> List[Tuple[str, Genome]]:
        """A read group's (path, genome) pairs that need the fused
        sketch, from its (path, ``Screened``) reads in path order; the
        skips are recorded for ``resolve``. The group's registers are
        pre-warmed first, duplicates and degenerate genomes included, as
        ``galah_tpu`` pre-warms every read."""
        if self.prewarm_hll:
            self._prewarm([(path, r.genome) for path, r in batch])
        out = []
        for path, read in batch:
            first = self._by_digest.get(read.digest)
            if first is not None:
                self._aliases[path] = first
                self._c_skipped.inc()
                self._c_dup.inc()
                continue
            self._by_digest[read.digest] = path
            if not read.has_window:
                # no window to hash: the sketch is empty
                self._degenerate[path] = MinHashSketch(
                    hashes=np.zeros(0, dtype=np.uint64),
                    sketch_size=self.store.sketch_size,
                    kmer=self.store.k)
                self._c_skipped.inc()
                self._c_degen.inc()
                continue
            out.append((path, read.genome))
        return out

    def _hll_params(self) -> dict:
        from galah_tpu_torch.ops.hll import DEFAULT_P

        return {"p": DEFAULT_P, "k": self.store.k,
                "seed": Defaults.MINHASH_SEED, "algo": self.store.algo}

    def _prewarm(self, batch: Iterable[Tuple[str, Genome]]) -> None:
        """Cache the HLL registers of the group's genomes that have no
        entry yet: one ``hll_sketch_genomes`` call for all of them."""
        from galah_tpu_torch.ops.hll import DEFAULT_P, hll_sketch_genomes

        store, params = self.store, self._hll_params()
        try:
            todo = [(path, g) for path, g in batch
                    if store.cache.load(path, "hll", params) is None]
        except OSError as exc:
            self._stop_prewarm(exc)
            return
        if not todo:
            return
        regs = hll_sketch_genomes([g for _, g in todo], DEFAULT_P,
                                  store.k, store.algo, store.device,
                                  store.clock).cpu().numpy()
        for (path, _), row in zip(todo, regs):
            try:
                store.cache.store(path, "hll", params, {"regs": row})
            except OSError as exc:
                self._stop_prewarm(exc)
                return
            self._c_prewarm.inc()

    def _stop_prewarm(self, exc: OSError) -> None:
        logger.warning("HLL pre-warm stopped: the disk cache failed: %s",
                       exc)
        self.prewarm_hll = False

    def resolve(self, path: str) -> Optional[MinHashSketch]:
        """The screened path's sketch, or None if the path went through
        the full pipeline."""
        s = self._degenerate.pop(path, None)
        if s is not None:
            return s
        first = self._aliases.get(path)
        if first is None:
            return None
        s = self.store.get_cached(first)
        if s is None:
            raise RuntimeError(
                f"prefilter invariant broken: duplicate {path!r} "
                f"aliases {first!r} but its sketch is not retained")
        return s


def maybe_prefilter(store) -> Optional[IngestPrefilter]:
    """An armed prefilter when the gate engages, else None."""
    return IngestPrefilter(store) if prefilter_engaged() else None
