"""The finch sketch stage: the port of ``galah_tpu/ops/sketch_stream.py``'s
fused strategy and its streaming stage.

``sketch_genomes_fused`` sketches a group of genomes with one fused
launch: the genomes' codes and contig starts (each genome start a
contig boundary) are laid end to end in the shared pinned group buffer
and copied to the device at once (``io/group.py``), and the fused kernel (``ops/fused_sketch``) builds each
window's canonical k-mer (the reference's XLA preamble), hashes it and
keeps the 8 smallest distinct hashes of each of the 2048 position
classes of each genome. The post-pass sorts a genome's 16,384
candidates, drops repeats and keeps the first ``sketch_size``. Its
certificate: with ``T`` the ``sketch_size``-th distinct candidate, a
genome is *suspect* when some class's eighth register is below ``T``
(that class filled up below ``T`` and may have dropped a value the true
bottom-k needs). Suspect genomes are re-sketched exactly
(``ops/minhash.sketch_genome_device``), so fused sketches equal exact
ones bit for bit, always. Genomes longer than ``DEFAULT_CHUNK`` and
sketch sizes beyond a quarter of the candidate file take the exact path
outright, as in ``galah_tpu``.

``galah_tpu`` pads launch groups to power-of-two job counts and spans to
bound XLA's compile variants; a genome's candidates depend only on its
own windows, so the port groups genomes by a window budget alone.

``iter_path_sketches`` yields each unique path's sketch in path order,
reading FASTA files ahead on ``ingest_depth(threads)`` worker threads
(``io/prefetch.iter_prefetched``) and sketching them in budget-sized
groups (``io/prefetch.iter_ingest_batches``, which hands each group on
as a flow item, ``obs/flow.py``); sketches enter the store on the
consumer thread. The store
decides what a sketch is: the finch ``SketchStore`` makes MinHash
sketches, the dashing ``HLLStore`` HLL registers.
``iter_sketch_row_blocks`` turns the finch stream into blocks of
sketch rows on the device for the streamed pair pass. Each group's
sketch is a guarded call at the store's dispatch site
(``dispatch.sketch-minhash`` or ``dispatch.sketch-hll``,
``resilience/dispatch.py``), and each read first consults the fault
injector at ``io.ingest[<path>]``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from galah_tpu_torch import config
from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import pinned, resolve_device
from galah_tpu_torch.io.fasta import Genome, read_genome
from galah_tpu_torch.io.group import host_layout, iter_groups, load_group
from galah_tpu_torch.io.prefetch import (ingest_depth,
                                         iter_ingest_batches,
                                         iter_prefetched)
from galah_tpu_torch.obs import flow as obs_flow
from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.ops.constants import SENTINEL_BIASED, SENTINEL_U64
from galah_tpu_torch.ops.fused_sketch import (CLASSES, REGS,
                                              fused_sketch_candidates)
from galah_tpu_torch.ops.hashing import DEFAULT_CHUNK
from galah_tpu_torch.ops.minhash import (sketch_genome_device,
                                         sketch_genomes_device_batch,
                                         sketch_matrix)
from galah_tpu_torch.ops.minhash_np import MinHashSketch
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.resilience import dispatch as rdispatch
from galah_tpu_torch.resilience import faults
from galah_tpu_torch.timing import StageClock, Stopwatch

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): the
# reads run on io/prefetch.py's threads (which own no locked state),
# the sketches are made and inserted on the consumer thread, and the
# read seconds go through the clock's locked work_seconds; this module
# owns no locked shared state. (``galah_tpu``'s fused demotion latch
# has no counterpart: a failed launch raises.)
GUARDED_BY = {}
LOCK_ORDER = []

# The streaming stages (GL10xx, obs/flow.py): the sketch stream and its
# row blocks, and the occupancy gauges it feeds.
PIPELINE_STAGE = {
    "streaming": ["iter_path_sketches", "iter_sketch_row_blocks"],
    "occupancy_gauge": "workload.pipeline_occupancy",
}

# Numeric contract (GL9xx): a fused sketch equals the exact one bit for
# bit (suspect genomes are re-sketched), uint64 hashes end to end.
DETERMINISM_CONTRACT = {
    "family": "sketch",
    "dtype": "uint64",
    "functions": ["sketch_genomes_fused", "certify",
                  "iter_path_sketches"],
}

#: bases per fused launch group: 32 MB of codes copied to the device a
#: group; the HLL sketch's 8 B window hashes and its fold's int64
#: temporaries (``ops/hll.FOLD_CHUNK`` windows at a time) stay under
#: 1 GB
FUSED_BUDGET = 1 << 25

#: candidates per genome in the fused file
CANDIDATES = REGS * CLASSES

#: sketch rows a block of ``iter_sketch_row_blocks`` (the streamed pair
#: pass's column block); tests may lower it
ROW_BLOCK = 256

#: the sketch routes GALAH_TPU_SKETCH_STRATEGY may pin (``galah_tpu``'s)
SKETCH_STRATEGIES = ("fused", "xla", "c")


def resolve_sketch_strategy(device_type: str) -> str:
    """The finch sketch route: a ``GALAH_TPU_SKETCH_STRATEGY`` pin, else
    ``fused``, the port's route on either device (``galah_tpu``'s AUTO
    takes its C sketcher or XLA on a CPU backend; ``sketch_genomes_
    fused`` itself takes the exact route at a sketch size its candidate
    file cannot certify). ``xla`` sketches every genome on the exact route
    (``ops/minhash.sketch_genome_device``: murmur3_k21.cu, or
    positional_hashes.cu at k = 15, then a sort); ``c`` runs that
    route's plain version on the CPU and is refused on `device_type`
    ``cuda``, where it would put the host on a card run."""
    env = pinned("GALAH_TPU_SKETCH_STRATEGY",
                 config.env_value("GALAH_TPU_SKETCH_STRATEGY"),
                 device_type)
    return env if env in SKETCH_STRATEGIES else "fused"


def _concat(genomes: Sequence[Genome], k: int):
    """(codes, contig offsets, jobs) of the genomes laid end to end, as
    host arrays (``io/group.host_layout``); job j is genome j's (first
    window, window count). The stream itself loads its groups with
    ``io/group.load_group``; the CPU tests hold the sketch kernels'
    plain versions on these arrays."""
    return host_layout(genomes, k)


def certify(cand: torch.Tensor, sketch_size: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sketches (G, sketch_size) biased, ascending, sentinel-padded;
    suspect (G,) bool) from (G, REGS, CLASSES) candidate files."""
    g = cand.shape[0]
    flat = torch.sort(cand.reshape(g, -1), dim=1).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[:, 1:] = flat[:, 1:] == flat[:, :-1]
    distinct = torch.sort(torch.where(dup, SENTINEL_BIASED, flat),
                          dim=1).values
    t = distinct[:, sketch_size - 1]
    suspect = (cand[:, REGS - 1, :] < t[:, None]).any(dim=1)
    return distinct[:, :sketch_size], suspect


def sketch_genomes_fused(genomes: Sequence[Genome],
                         sketch_size: int = Defaults.MINHASH_SKETCH_SIZE,
                         k: int = Defaults.MINHASH_KMER,
                         algo: str = Defaults.HASH_ALGO,
                         device="cuda",
                         clock: Optional[StageClock] = None
                         ) -> List[MinHashSketch]:
    """Fused-kernel sketches, bit-identical per genome to
    ``sketch_genome_device``."""
    device = resolve_device(device)
    if sketch_size > CANDIDATES // 4:
        # the candidate file cannot certify this many; not a
        # production shape (1000 against 16,384 candidates)
        return sketch_genomes_device_batch(genomes, sketch_size, k, algo,
                                           device)
    out: List[Optional[MinHashSketch]] = [None] * len(genomes)
    short = []
    for i, g in enumerate(genomes):
        if g.codes.shape[0] > DEFAULT_CHUNK:
            out[i] = sketch_genome_device(g, sketch_size, k, algo, device)
        else:
            short.append(i)
    groups = [[short[j] for j in idx] for idx in iter_groups(
        [genomes[i] for i in short], FUSED_BUDGET)]
    suspects = 0
    for group in groups:
        loaded = load_group([genomes[i] for i in group], k, device)
        cand = fused_sketch_candidates(loaded.codes, loaded.starts,
                                       loaded.jobs, k, algo)
        sketch, suspect = certify(cand, sketch_size)
        suspect_host = suspect.cpu().tolist()
        rows = from_biased(sketch)
        for row, gi in enumerate(group):
            if suspect_host[row]:
                suspects += 1
                out[gi] = sketch_genome_device(genomes[gi], sketch_size, k,
                                               algo, device)
            else:
                hs = rows[row]
                out[gi] = MinHashSketch(hashes=hs[hs != SENTINEL_U64],
                                        sketch_size=sketch_size, kmer=k)
    if clock is not None:
        clock.count("sketch-fused-launches", len(groups))
        clock.count("sketch-fused-jobs", sum(len(g) for g in groups))
        clock.count("sketch-fused-suspect", suspects)
    return out  # type: ignore[return-value]


def _ingest_read(path: str) -> Genome:
    """The FASTA read of the stream, with the fault injector consulted
    first at the site ``io.ingest[<path>]``, so that slow disks and
    backpressure are testable (``GALAH_FI`` kind ``slow-io``;
    ``galah_tpu/ops/sketch_stream._ingest_read``)."""
    injector = faults.get_injector()
    if injector is not None:
        injector.filesystem(f"io.ingest[{path}]")
    return read_genome(path)


def _guarded_sketch_group(store, genomes: List[Genome]) -> list:
    """``store.sketch_group(genomes)`` at the store's dispatch site
    (``dispatch.sketch-minhash`` for the finch ``SketchStore``,
    ``dispatch.sketch-hll`` for the dashing ``HLLStore``;
    ``resilience/dispatch.py``): retried on a transient failure or a
    result of the wrong length, then raised. The group is loaded and
    launched again whole on a retry; no per-genome fallback."""
    return rdispatch.run(store.DISPATCH_SITE,
                         lambda: store.sketch_group(genomes),
                         validate=rdispatch.expect_len(len(genomes)))


def _iter_computed(paths: Sequence[str], store, threads: int,
                   waits: obs_flow.WaitTotal, pre=None
                   ) -> Iterator[Tuple[str, object]]:
    """(path, sketch) for `paths` in order, sketched by
    ``store.sketch_group`` in groups of at most FUSED_BUDGET bases.
    With an ingest prefilter (`pre`, ``ops/prefilter.py``) the read
    threads also take each genome's digest and window test, and each
    read group is screened before its sketch: the paths it skips are
    not yielded (the merge walk resolves them), and with a disk cache
    the group's HLL registers are pre-warmed in the ``sketch`` stage.

    Flow (``obs/flow.py``): each wait on the reads is the ``sketch``
    stage's upstream-empty wait (summed into `waits`), each group a
    ``genome_batch`` from ``ingest`` absorbed by ``sketch`` and a
    ``sketch`` service span; the group's reads, their seconds summed
    over the threads, are ``ingest``'s service."""
    from galah_tpu_torch.ops import prefilter

    read_s = store.clock.work_seconds["read"]
    if pre is None:
        read, bases = _ingest_read, (lambda g: g.codes.shape[0])
    else:
        read = prefilter.screening(_ingest_read, store.k)
        bases = (lambda r: r.genome.codes.shape[0])
    reads = iter_prefetched(paths, store.clock.timed(read, "read"),
                            depth=ingest_depth(threads))
    for batch in iter_ingest_batches(
            obs_flow.waited(store.clock.waits(reads, "read",
                                              "genomes-read"), "sketch",
                            waits),
            bases, FUSED_BUDGET):
        read_s, read_s0 = store.clock.work_seconds["read"], read_s
        obs_flow.record_service("ingest", read_s - read_s0,
                                items=len(batch))
        obs_flow.absorb("ingest", "sketch")
        with obs_flow.span("sketch"), store.clock.stage("sketch"):
            if pre is not None:
                batch = pre.screen(batch)
            sketches = (_guarded_sketch_group(store,
                                              [g for _, g in batch])
                        if batch else [])
        yield from ((p, s) for (p, _), s in zip(batch, sketches))


def _emit_occupancy(watch: Stopwatch, waits: obs_flow.WaitTotal,
                    ingest_s: float) -> float:
    """Set the ``sketch`` and ``ingest`` occupancy gauges of the stream
    so far (the heartbeat samples them into its series) and return the
    sketch stage's: one less its upstream-empty wait over the stream's
    wall. Ingest's is the read threads' seconds, summed, over the wall
    (``galah_tpu/ops/sketch_stream._emit_sketch_occupancy``)."""
    wall = max(watch.seconds(), 1e-9)
    occ = 1.0 - waits.seconds / wall
    obs_metrics.pipeline_occupancy(occ, stage="sketch")
    obs_metrics.pipeline_occupancy(ingest_s / wall, stage="ingest")
    return occ


def iter_path_sketches(paths: Sequence[str], store, threads: int = 1
                       ) -> Iterator[Tuple[str, object]]:
    """(path, sketch) for the UNIQUE paths, in path order. The store
    (memory, then its disk cache) is probed once a path before any read
    starts, in stage `cache-read` when the disk cache is on, so a cached
    genome is never read; the rest are computed (``store.sketch_group``:
    MinHash sketches for a ``SketchStore``, HLL registers for an
    ``HLLStore``) and inserted on this thread.

    A MinHash store's reads go through the ingest prefilter when its
    gate engages (``ops/prefilter.maybe_prefilter``): a path it skipped
    takes the sketch it resolves to (``store.insert_prefiltered``).
    The computed sketches then arrive ahead of the walk, so the next one
    waits in a one-slot pushback until its path comes up. A MinHash
    store's stream counts its route, ``sketch-strategy-<route>``
    (``store.sketch_strategy()``), once.

    When any genome is read, the ``workload.pipeline_occupancy`` gauges
    of stages ``sketch`` and ``ingest`` are set every 64 computed
    sketches and at the end, and the unlabelled gauge to the sketch
    stage's at the end, as ``galah_tpu``'s stream does."""
    from galah_tpu_torch.ops import prefilter

    watch = Stopwatch()
    waits = obs_flow.WaitTotal()
    work0 = store.clock.work_seconds["read"]
    strategy = getattr(store, "sketch_strategy", None)
    if strategy is not None:
        # galah_tpu's count, once a MinHash stream
        store.clock.count(f"sketch-strategy-{strategy()}", 1)
    unique = list(dict.fromkeys(paths))
    with (store.clock.stage("cache-read") if store.cache.enabled
          else contextlib.nullcontext()):
        held = {p: store.get_cached(p) for p in unique}
    misses = [p for p in unique if held[p] is None]
    # the HLL store's registers are never prefiltered, as in galah_tpu
    pre = (prefilter.maybe_prefilter(store)
           if misses and hasattr(store, "insert_prefiltered") else None)
    computed = _iter_computed(misses, store, threads, waits, pre)
    parked: Optional[Tuple[str, object]] = None
    n_computed = 0
    for p in unique:
        s = held[p]
        if s is None and pre is not None:
            ps = pre.resolve(p)
            if ps is not None:
                s = store.insert_prefiltered(p, ps)
        if s is None:
            if parked is None:
                parked = next(computed, None)
            if parked is not None and parked[0] == p:
                s = store.insert(p, parked[1])
                parked = None
                n_computed += 1
                if n_computed % 64 == 0:
                    _emit_occupancy(watch, waits, store.clock
                                    .work_seconds["read"] - work0)
            else:
                # the group that held p screened it while the stream
                # ran ahead to the parked path (or to its end)
                ps = pre.resolve(p) if pre is not None else None
                if ps is None:
                    raise RuntimeError(
                        f"sketch stream out of order: "
                        f"{parked[0] if parked else None} != {p}")
                s = store.insert_prefiltered(p, ps)
        yield p, s
    if misses:
        obs_metrics.pipeline_occupancy(_emit_occupancy(
            watch, waits, store.clock.work_seconds["read"] - work0))


def iter_sketch_row_blocks(paths: Sequence[str], store, threads: int = 1
                           ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(r0, rows) blocks of the finch stream: `rows` is a (b, sketch_size)
    sorted, sentinel-padded biased int64 matrix on the store's device,
    b = ``ROW_BLOCK`` but for the last block, over the unique paths in
    order, while the reads go on ahead."""
    buf: List[MinHashSketch] = []
    r0 = 0
    for _p, s in iter_path_sketches(paths, store, threads):
        buf.append(s)
        if len(buf) == ROW_BLOCK:
            yield r0, _row_block(buf, store)
            r0 += len(buf)
            buf = []
    if buf:
        yield r0, _row_block(buf, store)


def _row_block(buf: List[MinHashSketch], store) -> torch.Tensor:
    """The block's rows on the device, handed on as a ``sketch_block``
    flow item leaving ``sketch``."""
    fid = obs_flow.begin("sketch_block")
    rows = sketch_matrix(buf, store.sketch_size, store.device)
    obs_flow.emit("sketch", fid)
    return rows
