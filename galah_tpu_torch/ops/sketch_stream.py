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
groups (``io/prefetch.iter_batches``); sketches enter the store on the consumer thread. The store
decides what a sketch is: the finch ``SketchStore`` makes MinHash
sketches, the dashing ``HLLStore`` HLL registers.
``iter_sketch_row_blocks`` turns the finch stream into blocks of
sketch rows on the device for the streamed pair pass.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from galah_tpu_torch.config import Defaults
from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import Genome, read_genome
from galah_tpu_torch.io.group import host_layout, iter_groups, load_group
from galah_tpu_torch.io.prefetch import (ingest_depth, iter_batches,
                                         iter_prefetched)
from galah_tpu_torch.ops.constants import SENTINEL_BIASED, SENTINEL_U64
from galah_tpu_torch.ops.fused_sketch import (CLASSES, REGS,
                                              fused_sketch_candidates)
from galah_tpu_torch.ops.hashing import DEFAULT_CHUNK
from galah_tpu_torch.ops.minhash import (sketch_genome_device,
                                         sketch_genomes_device_batch,
                                         sketch_matrix)
from galah_tpu_torch.ops.minhash_np import MinHashSketch
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

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


def _iter_computed(paths: Sequence[str], store, threads: int
                   ) -> Iterator[Tuple[str, object]]:
    """(path, sketch) for `paths` in order, sketched by
    ``store.sketch_group`` in groups of at most FUSED_BUDGET bases."""
    reads = iter_prefetched(paths, store.clock.timed(read_genome, "read"),
                            depth=ingest_depth(threads))
    for batch in iter_batches(store.clock.waits(reads, "read",
                                                "genomes-read"),
                              lambda g: g.codes.shape[0], FUSED_BUDGET):
        with store.clock.stage("sketch"):
            sketches = store.sketch_group([g for _, g in batch])
        yield from ((p, s) for (p, _), s in zip(batch, sketches))


def iter_path_sketches(paths: Sequence[str], store, threads: int = 1
                       ) -> Iterator[Tuple[str, object]]:
    """(path, sketch) for the UNIQUE paths, in path order. The store
    (memory, then its disk cache) is probed once a path before any read
    starts, in stage `cache-read` when the disk cache is on, so a cached
    genome is never read; the rest are computed (``store.sketch_group``:
    MinHash sketches for a ``SketchStore``, HLL registers for an
    ``HLLStore``) and inserted on this thread."""
    unique = list(dict.fromkeys(paths))
    with (store.clock.stage("cache-read") if store.cache.enabled
          else contextlib.nullcontext()):
        held = {p: store.get_cached(p) for p in unique}
    computed = _iter_computed([p for p in unique if held[p] is None],
                              store, threads)
    for p in unique:
        s = held[p]
        if s is None:
            cp, s = next(computed)
            if cp != p:
                raise RuntimeError(f"sketch stream out of order: {cp} "
                                   f"!= {p}")
            s = store.insert(p, s)
        yield p, s


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
            yield r0, sketch_matrix(buf, store.sketch_size, store.device)
            r0 += len(buf)
            buf = []
    if buf:
        yield r0, sketch_matrix(buf, store.sketch_size, store.device)
