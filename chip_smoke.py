#!/usr/bin/env python3
"""Drive galah_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--genomes 512] [--finch-genomes 1024]
                          [--genome-length 2000000]

(--finch-genomes also sizes the dashing run of phase 4d.)

Phases, each of which exits nonzero when it fails:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel with nvcc for sm_90a, in parallel, and
   the native FASTA parser with gcc;
3. kernel parity: each kernel against its plain torch version, exact
   integer equality, on edge-case inputs (the two sketch kernels read
   codes on the card, their plain versions the same codes on the host),
   and pairlist also on a dense-similarity list: one planted family of
   2,048 sketches at ~98% ANI and all 2,096,128 pairs i < j, through the
   survivor pass, at sketch sizes 1000 and 333; positional_hashes (the
   k=15 profile hash, murmur3 and tpufast) on edge groups (genome and
   contig starts on its runs, tiles and 14-base halo, N runs, genomes
   shorter than k and of exactly k, a 3 Mbp genome); and, once the
   corpus is written, positional_hashes on phase 4's first profile
   group (8 x 2 Mbp) and that group's profiles built on the card
   against the CPU plain build, and the C FASTA parser against its
   plain numpy version on 64 corpus files and one gzip file (codes,
   offsets and stats identical); fused_sketch also with murmur3 at
   k = 1, 7, 8, 9, 15, 16, 17, 24, 31 and 32 on the edge groups (the
   kernel's general key: k / 16 blocks and a tail of k mod 16 bytes);
4. end to end, skani: a MAG-like corpus made from the seed (512 genomes
   of ~2 Mbp in 128 planted families of 4 at ~99% ANI to the family
   base) through the ``cluster`` entry point on cuda; the clusters must
   equal the planted families, and the path's kernels must have been
   launched;
4b. end to end, finch at scale: 1024 genomes (256 families, the first
   512 are phase 4's) through ``cluster --precluster-method finch
   --cluster-method skani``, above the sparse-screen crossover, so the
   fused sketch and pairlist kernels carry the precluster;
4c. end to end, finch dense: the first 256 genomes through the same
   command, below the crossover, so the streamed pair pass runs (one
   stripe of tile_stats' full form);
4d. end to end, dashing with quality ranking: all genomes through
   ``cluster --precluster-method dashing --cluster-method skani
   --checkm2-quality-report <report>``, the report made from the seed;
   the clusters must be the planted families, each represented by the
   member that this script itself ranks first under Parks2020_reduced,
   and the hll_union, murmur3_k21 and window_hits kernels must have
   been launched;
4e. end to end, finch streamed: the first 1,000 genomes (250
   families, just under the crossover) through ``cluster
   --precluster-method finch``: the streamed pair pass in four stripes
   of tile_stats' full form; the stripe count must show the route, and
   the same command with --threads 4 must write the same TSV byte for
   byte (its walls and stages are printed beside the 8-thread run's);
4f. end to end, the fastani clusterer: phase 4's genomes through
   ``cluster --cluster-method fastani``; the clusters must be the
   planted families, and window_hits and positional_hashes must have
   been launched;
4m. the library API as CoverM embeds it: an argparse parser gets
   ``add_cluster_arguments`` under CoverM's flag names
   (``--dereplication-ani`` and the like), and
   ``generate_galah_clusterer(..., device="cuda").cluster()`` runs over
   phase 4's genomes (default values), phase 4b's (finch) and phase
   4d's (dashing with the CheckM2 report): each must return the CLI
   run's clusters in its genome order and launch that route's kernels;
   each wall is printed beside the CLI run's; ``--dereplication-ani
   101`` must raise a ValueError naming that flag;
4n. ``--ani-subsample``: phase 4's genomes through ``cluster`` at c =
   125 (skani's own compression) and c = 16: the planted families, and
   the sorted-query elements that window_hits tests must fall by a
   factor within [0.8 c, 1.25 c] of phase 4's (the exact-ANI stage and
   the launches printed beside phase 4's); ``cluster-validate
   --ani-subsample 125`` on phase 4's TSV must find 0 violations, and
   the API at c = 125 must return the CLI run's clusters;
4g. galah's command line: phase 4's genomes through ``main`` as a user
   runs it, ``cluster --genome-fasta-list L -q --threads 8`` with all
   three representative outputs: the TSV must equal phase 4's byte for
   byte, the list must name the 128 representatives, the symlinks must
   resolve to their files and the copies equal them; then
   ``cluster-validate --ani 95 --min-aligned-fraction 15`` on that TSV
   must find 0 violations, and at least 1 with the first family split
   in two (each launching positional_hashes and window_hits; the wall of
   the 8,128 representative pairs is printed);
4h. dist: all 1024 genomes (from the crossover up: the collision screen
   and pairlist) and the first 256 (the streamed pass: tile_stats' full
   form) through ``dist``: every line equal to the plain pair dict's at
   ``%.6f`` (min ANI 0: every pair with any sketch overlap), all
   within-family pairs present (1,536 and 384), fused_sketch launched;
   the same at ``--kmer-length 16`` and ``31`` with murmur3 (the fused
   kernel's general key), the first two genomes' sketches equal to the
   plain path's;
4i. the persistent cache: the first 64 genomes through the skani, finch
   and dashing (with the CheckM2 report) routes with ``--sketch-cache``
   in a directory of its own, cold then warm (and once without it): the
   TSVs equal, the warm runs launch no fused_sketch, murmur3_k21 or
   positional_hashes and miss nothing; on the skani route one profile
   entry with a flipped byte is repaired (the same TSV), and a warm
   profile load, split into its parts, is timed against a read plus a
   group build (each route's ~2 GB of cache is removed after it);
4j. checkpoint and resume over finch 1024's genomes with
   ``--rep-rounds 256`` (four greedy rounds): the run without a
   checkpoint, then (a) an uninterrupted run with ``--checkpoint-dir``,
   must each write phase 4b's TSV, and (a) must leave one
   ``clusters.jsonl`` record a precluster and no round log; (b) ``main``
   in this process, sent SIGTERM by a watcher thread once the round log
   holds a record, must return 75 at ``greedy-round-saved`` with one
   interruption record, and its run report and trace (phase 4o's
   checks) must say so; (c) ``--resume`` on (b)'s directory must write
   (a)'s TSV launching no fused_sketch or pairlist and fewer window_hits
   than (a); (d) ``python -m galah_tpu_torch cluster`` with ``GALAH_FI``
   killing it at the second round's append must exit 137 with one round
   record and no ``.tmp`` file; half a record is then appended, as a
   kill inside the write would leave it, and the resume in this process
   must log the dropped record and write (a)'s TSV; (e) skani 512, sent
   SIGTERM once ``fingerprint.json`` exists (written before the distance
   pass), must stop at ``distances-saved``, and its resume must launch
   no kernel and write phase 4's TSV;
4k. quarantine: phase 4's genomes listed with an empty ``.fna``, a
   truncated ``.fna.gz``, a binary file named ``.fna`` and a missing
   path, through ``--on-bad-genome skip``: the TSV must equal phase 4's
   and ``quarantine.json`` beside it must hold the four with
   galah_tpu's reasons (empty, corrupt, empty, missing); without skip
   the same list, and a short list holding the empty file, exit 1;
4l. the persistent sketch index over the finch corpus in quality order
   (the CheckM2 report of 4d): ``index build`` over the first 768
   genomes (the streamed pass: fused_sketch, tile_stats), ``insert`` of
   the other 256 with ``--batch 64`` (one pairlist launch a batch), and
   ``build`` of all 1024 from scratch (fused_sketch, pairlist): the
   grown index's committed bytes must equal the from-scratch build's
   and its clusters the planted families; ``query`` of 32 inserted
   genomes and 32 fresh random ones must answer member (of their
   family's cluster) and novel; ``remove`` of a representative must
   re-elect its lowest-index member and ``fsck`` pass. Then an insert
   batch's pair pass at catalogue scale: 20,000 synthetic indexed
   bottom-1000 sketches in planted families and 256 inserted rows
   (near duplicates, fresh families, empty and short rows), every
   (u, g) u < g, 5,152,640 pairs, in one pass; the kernel's integers
   equal the plain version's on 200,000 sampled pairs and the host
   merge_stats on 2,000, timed beside the host loop;
4o. observability: the runs of phases 4 (skani 512), 4b (finch 1024)
   and 4d (dashing 1024) again, each as ``python -m galah_tpu_torch
   cluster`` in a process of its own with ``--run-report``,
   ``--trace-events`` and ``GALAH_OBS_HEARTBEAT_S=0.25``: each TSV must
   equal its phase's byte for byte; each report must pass the port's
   ``obs.report.validate``, its ``dispatch`` section must be the
   phase's launch counts and its funnel the phase's clock counts
   (possible, screened and kept pairs, exact ANIs computed and
   wasted), with exact ANIs computed on the finch and dashing routes;
   each trace must load as JSON with one stage span for each stage the
   clock timed and no nvcc span (the kernels were built in phase 2);
   each heartbeat must hold at least two beats, the last the final
   one; all seven kernels must appear in the three reports; each wall
   is printed beside its phase's wall without observability (and
   finch's beside the same process without them), and each part's cost
   timed alone; a kernel built anew under a trace in this process must
   give one nvcc span. Phase
   4j's stopped run (b) also writes a report and a trace: the report
   must say stop requested by SIGTERM at ``greedy-round-saved``;
(phases 4-4f build profiles, so each requires positional_hashes
launches; they run with --threads 8: reads go 8 ahead on 8 threads; each
prints the consumer's wait for reads, stage `read`, and the reading
seconds of the worker threads summed, `read work`)
5. the kernels timed at the shapes the end-to-end runs gave them,
   beside their plain versions and their bound on this card (for
   window_hits, tile_stats, pairlist and hll_union the whole call and
   the kernel alone, and for window_hits one torch.isin call a pair,
   summed), pairlist's whole survivor pass at the finch run's list and
   at the dense-similarity list,
   hll_union at each of the 16 launches of phase 4d's pair pass with
   its planned slices and blocks, tile_stats' full form at each stripe
   of phase 4e's streamed pass, tile_stats'
   intersect form on synthetic rows at the widths that corpora of 6
   and 10 Mbp genomes give (K = 6080, 10048), and the whole sketch of
   the first finch and dashing launch groups split into the group load
   (pinned write and copy), kernel and certificate or HLL fold;
   positional_hashes at phase 4's first profile group, and that group's
   whole profile build split into load, kernel and distinct sets, with
   the distinct sets also by a two-key sort over the group; the
   sorted queries of phase 4's 512 profiles beside its exact-ANI stage;
   fused_sketch with murmur3 at k = 16 and 31 on the finch group of k =
   21, each with its bound (the key words and blocks of that k);
6. kernel path against plain torch path on the card: identical
   bidirectional ANI floats for 16 genomes, and for the same 16 at
   ``--ani-subsample 125``, identical finch sketches
   and pair-dict ANI floats for 64 genomes (the streamed pass in blocks
   of 256 and of 16 rows, and the pairlist pass), the streamed pass
   over phase 4e's 1,000 sketches (last stripe 232 rows) against the
   plain pair statistics of all 499,500 pairs, and identical HLL
   registers and dashing pair dicts for 64 genomes.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit, and the line before that the
per-kernel JSON record. Every line holding a number names the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import gc
import json
import logging
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit
# operations/s outside the tensor cores (the float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# 32-bit operations per valid window of the fused sketch kernel, from
# the codes (kernels/fused_sketch.cu's source note): the roll of the
# canonical packs, the canonical select and ASCII key words, the hash
# (a 64-bit multiply is ~3, a 64-bit add, xor or rotate ~2) and the
# register compare
FUSED_OPS_PER_WINDOW = {"murmur3": 180, "tpufast": 70}



def fused_murmur3_ops(k: int) -> int:
    """32-bit operations a valid window of the fused sketch kernel with
    murmur3 at k (kernels/fused_sketch.cu's source note): the roll,
    select and compare (~94), ~12 a key word, ~35 a 16-byte block and
    ~15 a tail word; 180 at k = 21."""
    rem = k % 16
    return (94 + 12 * -(-k // 8) + 35 * (k // 16) + 15 * (rem > 0)
            + 15 * (rem > 8))


# murmur3 k-mer lengths phase 3 holds the fused sketch kernel at against
# its plain version (the tail in one word, none or two; no block below
# 16, two at 32), and those dist runs in phase 4h and phase 5 time
ANY_K = (1, 7, 8, 9, 15, 16, 17, 24, 31, 32)
DIST_K = (16, 31)

# --ani-subsample values of phase 4n: skani's own compression and a
# light one
SUBSAMPLE_C = (125, 16)

# CoverM's names for the dereplication flags it embeds (phase 4m)
COVERM_FLAGS = {
    "ani": "dereplication-ani",
    "precluster_ani": "dereplication-prethreshold-ani",
    "min_aligned_fraction": "dereplication-aligned-fraction",
    "fragment_length": "dereplication-fragment-length",
    "precluster_method": "dereplication-precluster-method",
    "cluster_method": "dereplication-cluster-method",
    "quality_formula": "dereplication-quality-formula",
    "ani_subsample": "dereplication-ani-subsample",
    "threads": "dereplication-threads",
}

# 32-bit operations of one k=21 window of the murmur3_k21 kernel, from
# the codes (kernels/murmur3_k21.cu's source note), and of one register
# pair of the HLL union statistics (kernels/hll_union.cu's)
MURMUR3_OPS_PER_WINDOW = 170

# 32-bit operations of one k=15 window of the positional_hashes kernel
# (kernels/positional_hashes.cu's source note)
K15_OPS_PER_WINDOW = {"murmur3": 150, "tpufast": 45}
HLL_UNION_OPS_PER_REGISTER = 4

# the sparse-screen crossover of galah_tpu_torch.ops.collision, which
# phase 4b must reach and phase 4c must stay below
FINCH_MIN_GENOMES = 1024

# phase 4e's corpus: just under the crossover, so the streamed pair pass
# runs, in four stripes
STREAM_GENOMES = 1000

# phase 4i's corpus: the first genomes, with a profile cache entry of
# ~32 MB a genome, so about 2 GB of cache a route
CACHE_GENOMES = 64

# phase 4o's heartbeat period, seconds
OBS_HEARTBEAT_S = 0.25

# phase 4j's --rep-rounds: four greedy rounds over finch 1024's genomes,
# so a stop after the first leaves rounds to replay and rounds to run
RESUME_ROUND_WIDTH = 256

# phase 4l: the insert batch (--batch), the genomes queried from the
# index and fresh, and the catalogue-scale pair pass: indexed rows,
# inserted rows (one batch), and the pairs held against the plain version
# and against the host merge_stats
INDEX_BATCH = 64
QUERY_GENOMES = 32
CATALOGUE_ROWS = 20_000
INDEX_PASS_ROWS = 256
PASS_SAMPLE = 200_000
HOST_SAMPLE = 2_000

# host threads of every end-to-end run (--threads): the card's host has 8
# cores; phase 4e also runs with TWIN_THREADS
THREADS = 8
TWIN_THREADS = 4

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def _fasta_bytes(name: str, seq: np.ndarray, rng):
    """(FASTA bytes, contig count) of a genome: contigs of 5-50 kb at
    random cut points, 80-column lines."""
    cuts = [0]
    while cuts[-1] < seq.shape[0]:
        cuts.append(cuts[-1] + int(rng.integers(5_000, 50_001)))
    cuts[-1] = seq.shape[0]
    parts = []
    for c, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        parts.append(np.frombuffer(f">{name}_c{c}\n".encode(),
                                   dtype=np.uint8))
        body = seq[s:e]
        full = body.shape[0] // 80
        rows = np.concatenate(
            [body[:full * 80].reshape(full, 80),
             np.full((full, 1), ord("\n"), dtype=np.uint8)], axis=1)
        parts.append(rows.reshape(-1))
        if body.shape[0] > full * 80:
            parts.append(body[full * 80:])
            parts.append(np.array([ord("\n")], dtype=np.uint8))
    return np.concatenate(parts).tobytes(), len(cuts) - 1


def make_corpus(root: str, n_genomes: int, length: int, family: int,
                seed: int):
    """Planted families: each member is its family base with 1% of
    sites substituted; families are independent random sequences;
    each genome gets a few short N runs. Returns (paths, labels,
    stats), stats[path] the genome's (contig count, N count)."""
    rng = np.random.default_rng(seed)
    paths, labels, stats = [], [], {}
    for fam in range(n_genomes // family):
        base = rng.integers(0, 4, size=length).astype(np.uint8)
        for m in range(family):
            codes = base.copy()
            sites = np.flatnonzero(rng.random(length) < 0.01)
            codes[sites] = (codes[sites] + rng.integers(
                1, 4, size=sites.shape[0]).astype(np.uint8)) % 4
            seq = _ACGT[codes]
            for _ in range(int(rng.integers(2, 6))):
                s = int(rng.integers(0, length - 100))
                seq[s:s + int(rng.integers(5, 100))] = ord("N")
            p = os.path.join(root, f"fam{fam:03d}_m{m}.fna")
            body, n_contigs = _fasta_bytes(f"fam{fam}_m{m}", seq, rng)
            with open(p, "wb") as fh:
                fh.write(body)
            paths.append(p)
            labels.append(fam)
            stats[p] = (n_contigs, int((seq == ord("N")).sum()))
    return paths, labels, stats


def write_quality_report(path: str, paths, labels, seed: int):
    """A CheckM2 quality report for the corpus, made from the seed:
    within a family every member's completeness is distinct and at
    least 5 points from the others', contamination 0-2%. Returns
    {genome path: (completeness, contamination)} as written."""
    rng = np.random.default_rng(seed + 1)
    quality = {}
    for fam in sorted(set(labels)):
        members = [p for p, f in zip(paths, labels) if f == fam]
        grid = rng.choice(np.arange(50.0, 96.0, 5.0), size=len(members),
                          replace=False) + rng.uniform(0.0, 4.0)
        for p, c in zip(members, grid):
            quality[p] = (f"{c:.2f}", f"{rng.uniform(0.0, 2.0):.2f}")
    with open(path, "w") as fh:
        fh.write("Name\tCompleteness\tContamination\n")
        for p in paths:
            c, x = quality[p]
            fh.write(f"{os.path.basename(p)[:-4]}\t{c}\t{x}\n")
    return quality


def parks2020_best(members, quality, stats, order):
    """The member a Parks2020_reduced ranking puts first (the formula of
    galah's quality ranking, computed here from the report and the
    corpus' own contig and N counts; ties to the earlier input)."""
    def score(p):
        comp = float(quality[p][0]) / 100.0
        cont = float(quality[p][1]) / 100.0
        contigs, n_amb = stats[p]
        return (comp * 100.0 - 5.0 * cont * 100.0 - 5.0 * contigs / 100.0
                - 5.0 * n_amb / 100000.0)

    return min(members, key=lambda p: (-score(p), order[p]))


# ---------------------------------------------------------------------------
# kernel parity inputs
# ---------------------------------------------------------------------------


def _rand_hashes(rng, n):
    # biased int64 hashes, never the sentinel (INT64_MAX)
    return rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)


def window_hits_cases(rng, torch, device):
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)
                                ).to(device)

    items = []
    for n_ref, n_q in ((200_000, 150_000), (50_000, 80_000), (100, 5_000),
                       (1_000, 0), (0, 300), (1024, 1024), (1, 1)):
        ref = np.unique(_rand_hashes(rng, n_ref))
        take = rng.integers(0, max(ref.shape[0], 1), size=n_q // 2)
        q = np.concatenate([ref[take] if ref.size else
                            _rand_hashes(rng, n_q // 2),
                            _rand_hashes(rng, n_q - n_q // 2)])
        # duplicate values, as the same k-mer in several windows
        q = np.sort(np.concatenate([q, q[: n_q // 10]]))
        if n_q:
            q = np.concatenate([q, np.full(3, SENTINEL_BIASED)])
        items.append((t(q), t(ref)))
    return items + [(t(q), t(r)) for q, r in window_hits_edges(rng)]


def window_hits_edges(rng):
    """(query, reference) pairs aimed at the kernel's merge-path split
    into segments of SEGMENT merged items (r first on equal values)."""
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED
    from galah_tpu_torch.ops.window_hits import SEGMENT

    seg = SEGMENT
    ref = np.unique(_rand_hashes(rng, 2 * seg))
    run = 2 * seg + 100
    # r[0..m] merge first, then the run: it covers merged items
    # [m + 1, m + 1 + run), across the boundaries at seg and 2 seg
    m = seg - 200
    hit_run = np.full(run, ref[m])
    edges = [(hit_run, ref), (hit_run, np.delete(ref, m))]
    for n_ref, n_q in ((5, 5_000), (5_000, 5)):  # 1000x either way
        r = np.unique(_rand_hashes(rng, n_ref))
        q = np.sort(np.concatenate([
            r[rng.integers(0, r.shape[0], size=n_q // 2)],
            _rand_hashes(rng, n_q - n_q // 2)]))
        edges.append((q, r))
    one = _rand_hashes(rng, 1)
    edges.append((one, one))                    # a single-item pair
    edges.append((np.full(1000, SENTINEL_BIASED), ref))  # all sentinel
    # nq + nr an exact multiple of the segment
    r = np.unique(_rand_hashes(rng, seg + 16))[:seg]
    q = np.sort(np.concatenate([r[rng.integers(0, seg, size=seg // 2)],
                                _rand_hashes(rng, seg - seg // 2)]))
    edges.append((q, r))
    return edges


def tile_stats_cases(rng, torch, device):
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED

    cases = []
    for k, br, bc in ((1000, 37, 301), (2048, 45, 259), (2112, 64, 512)):
        pool = np.unique(_rand_hashes(rng, 4 * k))

        def rows(n):
            m = np.full((n, k), SENTINEL_BIASED, dtype=np.int64)
            for i in range(n):
                cnt = int(rng.integers(0, k + 1)) if i % 7 else k
                v = np.sort(rng.choice(pool, size=cnt, replace=False))
                m[i, :cnt] = v
            return torch.from_numpy(m).to(device)

        cases.append((rows(br), rows(bc), k))
    return cases + tile_stats_edges(rng, torch, device)


def tile_stats_edges(rng, torch, device):
    """(rows, cols, K) with empty, full, identical, disjoint and tiny
    (na << nb) rows at the screen's width K = 2176, at K = 1, at the
    widest K the kernel stages on an H100 (2419, odd, so copied by
    cp.async) and at widths it reads in place (2420, 16000)."""
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED

    cases = []
    for k, br, bc in ((2176, 64, 512), (1, 9, 13), (2419, 6, 11),
                      (2420, 6, 11), (16000, 5, 7)):
        pool = np.unique(_rand_hashes(rng, 3 * k))
        other = np.setdiff1d(np.unique(_rand_hashes(rng, k)), pool)

        def rows(n):
            m = np.full((n, k), SENTINEL_BIASED, dtype=np.int64)
            for i in range(n):
                cnt = (k, 0, int(rng.integers(0, k + 1)), min(k, 3))[i % 4]
                m[i, :cnt] = np.sort(rng.choice(pool, size=cnt,
                                                replace=False))
            return m

        r, c = rows(br), rows(bc)
        c[0] = r[0]                              # identical full rows
        c[1] = r[2]                              # identical ragged rows
        c[2] = SENTINEL_BIASED                   # disjoint from all
        c[2, :other.shape[0]] = other
        cases.append((torch.from_numpy(r).to(device),
                      torch.from_numpy(c).to(device), k))
    return cases


def _genome(name, codes, contig_starts=()):
    from galah_tpu_torch.io.fasta import Genome, GenomeStats

    n = codes.shape[0]
    offsets = np.array([0, *contig_starts, n], dtype=np.int64)
    return Genome(path=name, codes=codes, contig_offsets=offsets,
                  stats=GenomeStats(len(offsets) - 1,
                                    int((codes == 255).sum()), n))


def fused_sketch_genomes(rng):
    """Seven jobs (not a power of two): 2 Mbp in contigs with N runs
    (31 spans of 65,536 windows), all-ambiguous, shorter than k, far
    fewer distinct k-mers than 8 per class, a repeated 50 kb unit, a
    genome just over one span, and 3 Mbp."""
    def rand(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    big = rand(2_000_000)
    for s in rng.integers(0, 2_000_000 - 200, size=20):
        big[s:s + int(rng.integers(1, 200))] = 255
    return [
        _genome("contigs", big, np.unique(rng.integers(1, 2_000_000, 60))),
        _genome("all-n", np.full(5000, 255, dtype=np.uint8)),
        _genome("short", rand(10)),
        _genome("sparse", rand(3000)),
        _genome("repeat", np.tile(rand(50_000), 20)),
        _genome("one-span", rand(65_600)),
        _genome("long", rand(3_000_000), [1_000_000]),
    ]


def sketch_edge_groups(rng):
    """Launch groups aimed at the sketch kernels' codes input: runs of
    16 windows, 128-class slices of 2048-window rows (fused_sketch),
    4096-window tiles (murmur3_k21) and the 20-base halo; the same
    cases as tests/test_torch_sketch_codes.py."""
    def rand(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    k = 21
    edge = rand(3 * 2048 + 700)
    for s, e in ((2040, 2075), (127, 131), (15, 17), (4076, 4077)):
        edge[s:e] = 255
    return [
        [_genome("tile-edge", edge)],
        [_genome("starts", rand(9000), [2048, 4097, 6143, 9000 - k]),
         _genome("last-base", rand(5000), [4999])],
        [_genome("short-contigs", rand(7000), [3000, 3010, 5000, 5000 + k])],
        [_genome("k", rand(k)), _genome("all-n", np.full(3000, 255, np.uint8)),
         _genome("mid", rand(2500), [1200]), _genome("k-1", rand(k - 1))],
        [_genome("a", rand(2048 + k)), _genome("b", rand(4095)),
         _genome("long", rand(25_000), [11_111]),
         _genome("repeat", np.tile(rand(300), 40)), _genome("c", rand(31))],
    ]


def k15_edge_group(rng):
    """A launch group aimed at positional_hashes' codes input: ambiguous
    bases and contig starts on its runs of 16 windows, its 4096-window
    tiles and the 14-base halo; genomes of k - 1, k and k + 1 bases."""
    def rand(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    k = 15
    edge = rand(3 * 4096 + 300)
    for s, e in ((4090, 4100), (4096 + k - 1, 4096 + k), (15, 16),
                 (8191, 8192), (3 * 4096 + 299, 3 * 4096 + 300)):
        edge[s:e] = 255
    return [_genome("k15-tile-edge", edge, [4096, 4096 + k, 8192 - k + 1]),
            _genome("k15-short", rand(k - 1)), _genome("k15-exact", rand(k)),
            _genome("k15-plus-1", rand(k + 1), [k]),
            _genome("k15-contigs", rand(9000),
                    [1, 2, 2 + k, 4095, 4097, 9000 - k])]


def two_key_distinct(torch, hashes, jobs, cut, sentinel):
    """The other route to a group's distinct sets: one two-key sort of
    the group's hashes (by hash, then stably by genome), first
    occurrences within each genome, the counts by genome in one copy,
    one scatter; (ref_set, markers) a genome. Timed beside
    ops/fragment_ani's per-genome sorts."""
    n = hashes.shape[0]
    first = torch.tensor([w0 for w0, _ in jobs], device=hashes.device)
    gid = torch.bucketize(torch.arange(n, device=hashes.device), first,
                          right=True) - 1
    s1, p1 = torch.sort(hashes, stable=True)
    g, p2 = torch.sort(gid[p1], stable=True)
    s = s1[p2]
    keep = s != sentinel
    keep[1:] &= (s[1:] != s[:-1]) | (g[1:] != g[:-1])
    rank = torch.cumsum(keep, 0)
    sizes = torch.zeros(2, len(jobs), dtype=torch.int64, device=s.device)
    sizes[0].index_add_(0, g, keep.long())
    sizes[1].index_add_(0, g, (keep & (s < cut)).long())
    counts, marks = sizes.cpu().tolist()
    total = sum(counts)
    ref = torch.empty(total + 1, dtype=torch.int64, device=s.device)
    ref.scatter_(0, torch.where(keep, rank - 1, total), s)
    out, a = [], 0
    for c, m in zip(counts, marks):
        r = ref[a:a + c].clone()
        out.append((r, r[:m]))
        a += c
    return out


def plain_k21_hook(murmur3_k21_plain):
    """The k21_hash hook of the plain path on the card: the plain
    version takes CPU tensors, so the codes go to the host and the
    hashes back."""
    def hook(codes, starts, win0, n_win):
        return murmur3_k21_plain(codes.cpu(), starts.cpu(), win0,
                                 n_win).to(codes.device)
    return hook


def pairlist_cases(rng, torch, device, k=1000, n=400,
                   sizes=(1, 7, 8192, 8193)):
    """A family-structured (n, k) sketch matrix with empty, identical,
    disjoint and ragged rows, pair lists of `sizes` pairs (the special
    rows paired first), and two of 20,000 pairs, long enough for the
    kernel's staged plan: one in random order, one sorted by (pi, pj)
    as the collision screen emits pairs."""
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED

    base = np.unique(_rand_hashes(rng, 40 * k)).reshape(-1)
    mat = np.full((n, k), SENTINEL_BIASED, dtype=np.int64)
    for i in range(n):
        fam = base[(i % 40) * k:(i % 40 + 1) * k].copy()
        swap = rng.random(k) < rng.random() * 0.5
        fam[swap] = _rand_hashes(rng, int(swap.sum()))
        row = np.unique(fam)[:k if i % 3 else int(rng.integers(0, k + 1))]
        mat[i, :row.shape[0]] = row
    mat[1] = SENTINEL_BIASED                    # empty
    mat[2] = mat[3]                             # identical
    mat[4] = np.sort(_rand_hashes(rng, k))      # disjoint
    special = [(1, 5), (2, 3), (4, 6), (1, 1), (6, 6), (7, 4), (3, 2)]
    tmat = torch.from_numpy(mat).to(device)
    lists = []
    for b in (*sizes, 20_000, 20_000):
        pairs = np.array(special[:b] + [
            tuple(rng.integers(0, n, size=2))
            for _ in range(max(b - len(special), 0))], dtype=np.int64)
        if len(lists) == len(sizes) + 1:
            pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
        lists.append((torch.from_numpy(np.ascontiguousarray(pairs[:, 0]))
                      .to(device),
                      torch.from_numpy(np.ascontiguousarray(pairs[:, 1]))
                      .to(device)))
    return tmat, lists


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Median host-clock ms of `fn`, which ends synchronised with the
    card (a pass that returns host arrays), after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def valid_windows(codes, starts, k: int) -> int:
    """Windows of width k of a launch group's codes (host arrays) that
    hold no ambiguous base and cross no contig start: what the sketch
    kernels hash."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        return 0
    amb = np.concatenate([[0], np.cumsum(codes == 255)])
    contig = np.searchsorted(starts, np.arange(codes.shape[0]),
                             side="right")
    ok = (amb[k:k + n] == amb[:n]) & (contig[:n] == contig[k - 1:k - 1 + n])
    return int(ok.sum())


def first_group(paths, read_genome, budget):
    """The genomes of a run's first launch group, its largest."""
    group, size = [], 0
    for p in paths:
        g = read_genome(p)
        if group and size + g.codes.shape[0] > budget:
            break
        group.append(g)
        size += g.codes.shape[0]
    return group


def time_group(torch, device, group, k=21):
    """Host clock of a launch group's load onto the card: written into
    the shared pinned group buffer and copied (io/group.load_group,
    median of 5, synchronised), and of its host layout alone into fresh
    arrays; the tensors (host codes, host starts, device codes, device
    starts, jobs)."""
    from galah_tpu_torch.io.group import host_layout, load_group

    load_ms = host_ms(torch, lambda: (load_group(group, k, device),
                                      torch.cuda.synchronize()), 5)
    loaded = load_group(group, k, device)
    t0 = time.perf_counter()
    codes, offsets, jobs = host_layout(group, k)
    layout_ms = (time.perf_counter() - t0) * 1e3
    return {"load_ms": load_ms, "layout_ms": layout_ms,
            "tensors": (torch.from_numpy(codes), torch.from_numpy(offsets),
                        loaded.codes, loaded.starts, jobs)}


def run_path(torch, cli, reset_launches, launches_now, argv):
    """One `cluster` run through the CLI entry point, with every launch
    count set to 0 just before it and read just after."""
    reset_launches()
    t0 = time.perf_counter()
    res = cli.run_cluster(cli.parse_args(argv))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(launches_now)


def run_call(torch, reset_launches, launches_now, fn):
    """fn() with every launch count set to 0 just before it and read
    just after; (its result, wall seconds, launches)."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(launches_now)


def run_main(torch, cli, reset_launches, launches_now, argv, want_rc=0):
    """One command line through cli.main, as a user runs it, launch
    counts as in run_call, which must exit `want_rc`; the root logger,
    which main's -q/-v replace, is put back after."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        rc, wall, launches = run_call(torch, reset_launches, launches_now,
                                      lambda: cli.main(argv))
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    if rc != want_rc:
        raise PhaseError(f"`{' '.join(argv[:3])} ...` exited {rc}, not "
                         f"{want_rc}")
    return wall, launches


def check_rep_outputs(tsv: bytes, reps_list, links, copies):
    """The representative list, symlink directory and copy directory
    against the cluster TSV's representatives; returns their count."""
    reps = [ln.split("\t")[0] for ln in tsv.decode().splitlines()
            if ln.split("\t")[0] == ln.split("\t")[1]]
    with open(reps_list) as fh:
        if fh.read().splitlines() != reps:
            raise PhaseError("the representative list differs from the "
                             "TSV's representatives")
    names = sorted(os.path.basename(r) for r in reps)
    if sorted(os.listdir(links)) != names or \
            sorted(os.listdir(copies)) != names:
        raise PhaseError("the representative directories do not hold one "
                         "file a representative")
    for r in reps:
        link = os.path.join(links, os.path.basename(r))
        if not (os.path.islink(link)
                and os.path.realpath(link) == os.path.realpath(r)):
            raise PhaseError(f"{link} does not resolve to {r}")
        if not filecmp.cmp(os.path.join(copies, os.path.basename(r)), r,
                           shallow=False):
            raise PhaseError(f"the copy of {r} differs from it")
    return len(reps)


def split_first_family(tsv: bytes) -> bytes:
    """The TSV with its first cluster split in two: the third member
    becomes the representative of the rest."""
    lines = tsv.decode().splitlines()
    first = [ln.split("\t")[1] for ln in lines
             if ln.split("\t")[0] == lines[0].split("\t")[0]]
    if len(first) < 3:
        raise PhaseError("the first cluster has fewer than 3 members")
    rest = lines[len(first):]
    out = [f"{first[0]}\t{m}" for m in first[:2]]
    out += [f"{first[2]}\t{m}" for m in first[2:]]
    return ("\n".join(out + rest) + "\n").encode()


def check_dist(tsv_path, genomes, plain):
    """The dist TSV equals the lines of the plain pair dict, in sorted
    pair order with ANIs %.6f."""
    want = "".join(f"{genomes[i]}\t{genomes[j]}\t{plain[(i, j)]:.6f}\n"
                   for i, j in sorted(plain))
    with open(tsv_path) as fh:
        if fh.read() != want:
            raise PhaseError(f"the dist TSV of {len(genomes)} genomes "
                             f"differs from the plain pair dict's lines")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def check_families(res, label_of, n_genomes, family, tsv, what):
    got = sorted(sorted(label_of[res.genomes[i]] for i in c)
                 for c in res.clusters)
    fams = sorted({label_of[p] for p in res.genomes})
    if got != sorted([f] * family for f in fams):
        raise PhaseError(f"{what}: clusters differ from the planted "
                         f"families: {len(res.clusters)} clusters")
    with open(tsv) as fh:
        n_lines = sum(1 for _ in fh)
    if n_lines != n_genomes:
        raise PhaseError(f"{what}: cluster TSV has {n_lines} lines")
    return len(fams)


def require_counts(counts, want, what):
    for name, n in want.items():
        if counts[name] != n:
            raise PhaseError(f"{what}: count {name} is {counts[name]}, "
                             f"not {n}")


def stripe_shapes(n: int, block: int):
    """(padded rows, (first column, end of columns)) of each stripe of
    the streamed pair pass over n rows (ops/pairwise's padding: the rows
    seen so far, to a power of two of at least 64)."""
    out = []
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        rows = 64
        while rows < r1:
            rows <<= 1
        out.append((rows, (r0, r1)))
    return out


def plain_pair_dict(torch, mat, k, min_ani, sketch_size, chunk=50_000):
    """{(i, j): ani} of every pair i < j of the biased sketch matrix
    `mat` through the plain pair statistics (``pair_stats_pairs_plain``,
    in chunks of `chunk` pairs), thresholded in float64 as the passes
    do: the reference for the finch pair passes."""
    from galah_tpu_torch.ops.pairlist import pair_stats_pairs_plain
    from galah_tpu_torch.ops.pairwise import ani_to_jaccard, stats_to_ani_f64

    ii, jj = np.triu_indices(mat.shape[0], 1)
    cs, ts = [], []
    for a in range(0, ii.shape[0], chunk):
        c, t = pair_stats_pairs_plain(
            mat, torch.from_numpy(ii[a:a + chunk]).to(mat.device),
            torch.from_numpy(jj[a:a + chunk]).to(mat.device), sketch_size)
        cs.append(c.cpu().numpy().astype(np.int64))
        ts.append(t.cpu().numpy().astype(np.int64))
    c, t = np.concatenate(cs), np.concatenate(ts)
    keep = (c > 0) & (c.astype(np.float64)
                      >= ani_to_jaccard(min_ani, k) * t)
    return dict(zip(zip(ii[keep].tolist(), jj[keep].tolist()),
                    stats_to_ani_f64(c[keep], t[keep], k).tolist()))


def row_blocks(mat, block):
    """(r0, rows) blocks of `block` rows of `mat`, as the sketch stream
    yields them."""
    return ((r0, mat[r0:r0 + block]) for r0 in range(0, mat.shape[0], block))


def print_run(what, r, launches, kernels, tag):
    """Every stage, the summed read work, count and launch of a run."""
    for stage, sec in sorted(r.clock.seconds.items()):
        print(f"{what} stage {stage}: {sec:.3f} s {tag}")
    for name, sec in sorted(r.clock.work_seconds.items()):
        print(f"{what} {name} work (summed over threads): {sec:.3f} s {tag}")
    for name, n in sorted(r.clock.counts.items()):
        print(f"{what} count {name}: {n} {tag}")
    for name in kernels:
        print(f"{what} launches {name}: {launches[name]} {tag}")


def check_parser(paths, root, read_genome, read_genome_plain,
                 read_genome_stats, read_genome_stats_plain):
    """The C parser against the numpy plain version on `paths` and on a
    gzip copy of the first; raises PhaseError on any difference.
    Returns the file count and the median ms a genome of each."""
    import gzip
    import shutil

    gz = os.path.join(root, "first.fna.gz")
    with open(paths[0], "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    c_ms, plain_ms = [], []
    for p in [*paths, gz]:
        t0 = time.perf_counter()
        got = read_genome(p)
        t1 = time.perf_counter()
        want = read_genome_plain(p)
        t2 = time.perf_counter()
        c_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
        if not (np.array_equal(got.codes, want.codes)
                and np.array_equal(got.contig_offsets, want.contig_offsets)
                and got.stats == want.stats
                and read_genome_stats(p) == read_genome_stats_plain(p)
                == want.stats):
            raise PhaseError(f"the C FASTA parser disagrees with the numpy "
                             f"plain version on {p}")
    return {"files": len(paths), "c_ms": float(np.median(c_ms)),
            "plain_ms": float(np.median(plain_ms))}


def require_launched(launches, names, what):
    for name in names:
        if launches[name] == 0:
            raise PhaseError(f"kernel {name} was never launched on the "
                             f"{what} path")


def phases_cli(torch, cli, reset_launches, launches_now, kernels, root,
               genomes4, tsv4, paths, label_of, n_dense, report, threads,
               family, device, tag):
    """Phases 4g-4i: galah's command line over phase 4's genomes
    (`genomes4`, whose TSV is `tsv4`), dist, and the persistent cache.
    Returns what the kernel record keeps of them."""
    from galah_tpu_torch.backends import ProfileStore
    from galah_tpu_torch.io import diskcache
    from galah_tpu_torch.io.diskcache import CacheDir
    from galah_tpu_torch.io.fasta import read_genome
    from galah_tpu_torch.ops import fragment_ani
    from galah_tpu_torch.ops.minhash import (sketch_genome_device,
                                             sketch_matrix)
    from galah_tpu_torch.ops.u64 import to_biased

    dev = device.type

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    # -- phase 4g: galah's command line -------------------------------
    n_reps = len(genomes4) // family
    g_dir = os.path.join(root, "cli")
    os.makedirs(g_dir)
    g_list = os.path.join(g_dir, "genomes.txt")
    with open(g_list, "w") as fh:
        fh.write("".join(p + "\n" for p in genomes4))
    g_tsv, g_reps, g_links, g_copies = (
        os.path.join(g_dir, n) for n in ("clusters.tsv", "reps.txt",
                                         "links", "copies"))
    wall_g, launches_g = run_main(
        torch, cli, reset_launches, launches_now,
        ["cluster", "--genome-fasta-list", g_list, "-q", *threads,
         "--ani", "95", "--device", dev,
         "--output-cluster-definition", g_tsv,
         "--output-representative-list", g_reps,
         "--output-representative-fasta-directory", g_links,
         "--output-representative-fasta-directory-copy", g_copies])
    with open(g_tsv, "rb") as fh:
        if fh.read() != tsv4:
            raise PhaseError("galah cli: the TSV of the "
                             "--genome-fasta-list run differs from "
                             "phase 4's")
    if check_rep_outputs(tsv4, g_reps, g_links, g_copies) != n_reps:
        raise PhaseError(f"galah cli: not {n_reps} representatives")
    require_launched(launches_g, ("window_hits", "tile_stats",
                                  "positional_hashes"), "galah cli")
    print(f"galah cli: cluster --genome-fasta-list -q over phase 4's "
          f"{len(genomes4)} genomes: TSV byte-identical to phase 4's; "
          f"{n_reps} representatives listed, symlinked (each resolves "
          f"to its file) and copied (bytes equal); wall {wall_g:.2f} s "
          f"{tag}")
    for name in kernels:
        print(f"galah cli launches {name}: {launches_g[name]} {tag}")
    split_tsv = os.path.join(g_dir, "split.tsv")
    with open(split_tsv, "wb") as fh:
        fh.write(split_first_family(tsv4))
    validations = {}
    for what, tsv in (("validate", g_tsv), ("validate split", split_tsv)):
        v_args = cli.parse_args(
            ["cluster-validate", "--cluster-file", tsv, "--ani", "95",
             "--min-aligned-fraction", "15", "--device", dev,
             *threads])
        val, wall_v, launches_v = run_call(
            torch, reset_launches, launches_now,
            lambda: cli.run_cluster_validate(v_args))
        require_launched(launches_v, ("positional_hashes",
                                      "window_hits"), f"galah cli {what}")
        validations[what] = (val, wall_v, launches_v)
        print(f"galah cli {what}: {val.clusters} clusters, "
              f"{val.member_pairs} member pairs in "
              f"{val.member_seconds:.2f} s, {val.rep_pairs} "
              f"representative pairs in {val.rep_seconds:.2f} s, "
              f"{val.violations} violation(s); wall {wall_v:.2f} s "
              f"{tag}")
        for name in kernels:
            print(f"galah cli {what} launches {name}: "
                  f"{launches_v[name]} {tag}")
    if validations["validate"][0].violations != 0:
        raise PhaseError("cluster-validate finds violations in phase "
                         "4's clusters")
    if validations["validate split"][0].violations < 1:
        raise PhaseError("cluster-validate finds no violation in a "
                         "split family")
    shutil.rmtree(g_dir)

    # -- phase 4h: dist --------------------------------------------------
    # murmur3 at k = 21, then at the DIST_K (the fused kernel's general
    # key), each from the crossover up and below it; at another k the
    # first two genomes' sketches are also held against the plain path
    dist_runs = {}
    for what, sub, route, dk in (
            ("dist sparse", paths, "pairlist", 21),
            ("dist dense", paths[:n_dense], "tile_stats", 21),
            *((f"dist k{kk} {w}", sub_k, r, kk) for kk in DIST_K
              for w, sub_k, r in (("sparse", paths, "pairlist"),
                                  ("dense", paths[:n_dense],
                                   "tile_stats")))):
        if len(sub) < FINCH_MIN_GENOMES and route == "pairlist":
            print(f"dist cut: {len(sub)} genomes stay below the "
                  f"crossover {tag}")
            route = "tile_stats"
        d_tsv = os.path.join(root, "dist.tsv")
        d_argv = cli.parse_args(["dist", "-f", *sub, "--device", dev,
                                 *threads, "--kmer-length", str(dk),
                                 "--output", d_tsv])
        dres, wall_x, launches_x = run_call(
            torch, reset_launches, launches_now, lambda: cli.run_dist(d_argv))
        require_launched(launches_x, ("fused_sketch", route), what)
        if dk != 21:
            for p in sub[:2]:
                want = sketch_genome_device(read_genome(p), 1000, dk,
                                            "murmur3", "cpu")
                if not np.array_equal(dres.store.get_cached(p).hashes,
                                      want.hashes):
                    raise PhaseError(f"{what}: the sketch of {p} differs "
                                     f"from the plain path's")
        dmat = sketch_matrix([dres.store.get_cached(p) for p in sub],
                             1000, device)
        plain_x = plain_pair_dict(torch, dmat, dk, 0.0, 1000)
        check_dist(d_tsv, sub, plain_x)
        lab = [label_of[p] for p in sub]
        within = sum(lab[i] == lab[j] for i, j in dres.pairs)
        want_within = len(sub) // family * family * (family - 1) // 2
        if within != want_within:
            raise PhaseError(f"{what}: {within} within-family pairs, "
                             f"not {want_within}")
        del dmat
        dist_runs[what] = launches_x
        print(f"{what}: {len(sub)} genomes, {len(dres.pairs)} pairs with "
              f"any sketch overlap ({within} within families, all), "
              f"every line equal to the plain pair dict's at %.6f; "
              f"wall {wall_x:.2f} s {tag}")
        print_run(what, dres, launches_x, kernels, tag)
    os.remove(d_tsv)

    # -- phase 4i: the persistent sketch/profile cache -------------------
    from galah_tpu_torch.backends import ProfileStore
    from galah_tpu_torch.io.diskcache import CacheDir
    from galah_tpu_torch.ops import fragment_ani

    c_paths = paths[:CACHE_GENOMES]
    cache_runs = {}
    for route, flags in (
            ("skani", []),
            ("finch", ["--precluster-method", "finch"]),
            ("dashing", ["--precluster-method", "dashing",
                         "--checkm2-quality-report", report])):
        cdir = os.path.join(root, f"cache_{route}")
        tsvs = {}
        # "uncached": the same run without the cache, for its wall
        for run in ("uncached", "cold", "warm", "repaired"):
            if run == "repaired":
                if route != "skani":
                    continue
                entry = os.path.join(cdir, sorted(
                    n for n in os.listdir(cdir)
                    if n.startswith("profile-"))[0])
                with open(entry, "r+b") as fh:
                    fh.seek(os.path.getsize(entry) // 2)
                    byte = fh.read(1)
                    fh.seek(-1, 1)
                    fh.write(bytes([byte[0] ^ 0xFF]))
            tsvs[run] = os.path.join(root, f"cache_{route}_{run}.tsv")
            r, wall_c, launches_c = run_path(
                torch, cli, reset_launches, launches_now,
                ["cluster", "-f", *c_paths, *flags, "--ani", "95",
                 "--device", dev, *threads,
                 *([] if run == "uncached" else ["--sketch-cache", cdir]),
                 "--output-cluster-definition", tsvs[run]])
            check_families(r, label_of, len(c_paths), family, tsvs[run],
                           f"cache {route} {run}")
            cache_runs[f"{route} {run}"] = launches_c
            counts = r.clock.counts
            print(f"cache {route} {run}: wall {wall_c:.2f} s, "
                  f"cache-hits {counts['cache-hits']}, cache-misses "
                  f"{counts['cache-misses']}, cache-repaired "
                  f"{counts['cache-repaired']}, cache-bytes-read "
                  f"{counts['cache-bytes-read']}, cache-bytes-written "
                  f"{counts['cache-bytes-written']} {tag}")
            print_run(f"cache {route} {run}", r, launches_c, kernels, tag)
            with open(tsvs[run], "rb") as fa, \
                    open(tsvs["uncached"], "rb") as fb:
                if fa.read() != fb.read():
                    raise PhaseError(f"cache {route}: the {run} TSV "
                                     f"differs from the uncached one")
            if run == "warm":
                for name in ("fused_sketch", "murmur3_k21",
                             "positional_hashes"):
                    if launches_c[name]:
                        raise PhaseError(
                            f"cache {route} warm: {name} launched "
                            f"{launches_c[name]} times")
                require_counts(counts, {"cache-misses": 0,
                                        "genomes-read": 0},
                               f"cache {route} warm")
            if run == "repaired":
                require_counts(counts, {"cache-repaired": 1,
                                        "cache-misses": 1},
                               f"cache {route} repaired")
                require_launched(launches_c, ("positional_hashes",),
                                 f"cache {route} repaired")
        print(f"cache {route}: {len(c_paths)} genomes, TSVs uncached = "
              f"cold = warm"
              f"{' = repaired' if route == 'skani' else ''}, cache "
              f"{dir_bytes(cdir)} bytes in {len(os.listdir(cdir))} "
              f"entries {tag}")
        if route == "skani":
            # a warm profile load (read, checksum, upload) against a
            # read plus a group build, per genome
            warm_cache = CacheDir(cdir)
            few = c_paths[:8]
            load_ms = host_ms(torch, lambda: (
                ProfileStore(device, cache=warm_cache).get_many(few),
                sync()), 3) / len(few)
            entry_mb = dir_bytes(cdir) / len(os.listdir(cdir)) / 1e6
            read_ms = host_ms(torch, lambda: [read_genome(p)
                                              for p in few], 3) / len(few)
            fgroup = [read_genome(p) for p in few]
            build_ms = host_ms(
                torch, lambda: (fragment_ani.build_profiles_batch(
                    fgroup, 15, 3000, device),
                    sync()), 5) / len(few)
            # the warm load's parts: the npz read (zipfile checks its
            # CRC-32), the entry's content crc32, the bias and upload
            ents = [warm_cache.entry_path(p, "profile",
                                          {"k": 15, "fraglen": 3000})
                    for p in few]

            def load_arrays():
                out = []
                for f in ents:
                    with np.load(f) as z:
                        out.append({n: z[n] for n in z.files})
                return out

            npz_ms = host_ms(torch, load_arrays, 3) / len(few)
            arrays = load_arrays()
            crc_ms = host_ms(torch, lambda: [diskcache._content_crc(
                {n: a for n, a in e.items() if n != "__check__"})
                for e in arrays], 3) / len(few)
            up_ms = host_ms(torch, lambda: (
                [to_biased(e[n], device) for e in arrays
                 for n in ("flat_hashes", "ref_set", "markers")],
                sync()), 3) / len(few)
            del arrays
            print(f"cache profile load split: npz read {npz_ms:.3f} ms, "
                  f"content crc32 {crc_ms:.3f} ms, bias and upload "
                  f"{up_ms:.3f} ms a genome {tag}")
            print(f"cache profile entry: {entry_mb:.1f} MB a genome; "
                  f"warm load {load_ms:.3f} ms a genome (read, "
                  f"checksum, upload; host clock, median of 3 over "
                  f"{len(few)} genomes); cold read {read_ms:.3f} ms + "
                  f"group build {build_ms:.3f} ms a genome (a group of "
                  f"{len(few)}) {tag}")
            cache_profile = {"entry_mb": entry_mb, "load_ms": load_ms,
                             "read_ms": read_ms, "build_ms": build_ms,
                             "load_split_ms": {"npz_read": npz_ms,
                                               "content_crc": crc_ms,
                                               "bias_upload": up_ms}}
            del warm_cache, fgroup
        shutil.rmtree(cdir)

    return {"launches_g": launches_g, "validations": validations,
            "dist_runs": dist_runs, "cache_runs": cache_runs,
            "cache_profile": cache_profile}


def alloc_retries(torch) -> int:
    """cudaMalloc retries of the caching allocator so far: each one
    freed the cached blocks and synchronised the card."""
    return int(torch.cuda.memory_stats().get("num_alloc_retries", 0))


def api_values(argv):
    """The flag values of `argv` under the CoverM definition, as an
    embedding tool parses them: (definition, vars(args))."""
    from galah_tpu_torch.api import (ClustererCommandDefinition,
                                     add_cluster_arguments)

    defn = ClustererCommandDefinition(**COVERM_FLAGS)
    parser = argparse.ArgumentParser(prog="coverm-like")
    add_cluster_arguments(parser, defn)
    return defn, vars(parser.parse_args(argv))


def run_api(torch, reset_launches, launches_now, genome_paths, argv):
    """generate_galah_clusterer(...).cluster() on cuda under the CoverM
    definition, launch counts as in run_call; (clusterer, clusters,
    wall seconds, launches)."""
    from galah_tpu_torch.api import generate_galah_clusterer

    defn, values = api_values(argv)

    def go():
        c = generate_galah_clusterer(genome_paths, values, defn,
                                     device="cuda")
        return c, c.cluster()

    (clusterer, clusters), wall, launches = run_call(
        torch, reset_launches, launches_now, go)
    return clusterer, clusters, wall, launches


def phases_api(torch, reset_launches, launches_now, kernels, runs,
               report, tag):
    """Phase 4m: the library API as CoverM embeds it, with CoverM's flag
    names, over the corpora of phases 4, 4b and 4d. `runs` maps each of
    "skani", "finch", "dashing" to (the CLI run's genome inputs, its
    RunResult, its wall). Returns the walls and launches."""
    t = str(THREADS)
    api_runs = {}
    for route, argv, need in (
            ("skani", ["--dereplication-ani", "95",
                       "--dereplication-threads", t],
             ("positional_hashes", "window_hits")),
            ("finch", ["--dereplication-precluster-method", "finch",
                       "--dereplication-ani", "95",
                       "--dereplication-threads", t],
             ("fused_sketch", "pairlist", "positional_hashes",
              "window_hits")),
            ("dashing", ["--dereplication-precluster-method", "dashing",
                         "--checkm2-quality-report", report,
                         "--dereplication-ani", "95",
                         "--dereplication-threads", t],
             ("hll_union", "murmur3_k21", "positional_hashes",
              "window_hits"))):
        inputs, res_cli, wall_cli = runs[route]
        if route == "finch" and len(inputs) < FINCH_MIN_GENOMES:
            need = tuple(n for n in need if n != "pairlist")
        clusterer, clusters, wall, launches = run_api(
            torch, reset_launches, launches_now, inputs, argv)
        if clusterer.genome_paths != res_cli.genomes:
            raise PhaseError(f"api {route}: the genome order differs from "
                             f"the CLI run's")
        if clusters != res_cli.clusters:
            raise PhaseError(f"api {route}: the clusters differ from the "
                             f"CLI run's")
        require_launched(launches, need, f"api {route}")
        api_runs[route] = {"wall": wall, "cli_wall": wall_cli,
                           "launches": launches}
        print(f"api {route}: generate_galah_clusterer(...).cluster() "
              f"under CoverM's flag names, {len(inputs)} genomes, "
              f"{len(clusters)} clusters equal to the CLI run's, same "
              f"genome order; wall {wall:.2f} s (CLI {wall_cli:.2f} s) "
              f"{tag}")
        print_run(f"api {route}", clusterer, launches, kernels, tag)
        del clusterer
        gc.collect()
        torch.cuda.empty_cache()
    from galah_tpu_torch.api import generate_galah_clusterer

    defn, values = api_values(["--dereplication-ani", "101"])
    try:
        generate_galah_clusterer(runs["skani"][0], values, defn,
                                 device="cuda")
    except ValueError as e:
        if "--dereplication-ani" not in str(e):
            raise PhaseError(f"api: the out-of-range error names no "
                             f"renamed flag: {e}")
        print(f"api: --dereplication-ani 101 raises ValueError({e}) {tag}")
    else:
        raise PhaseError("api: --dereplication-ani 101 was accepted")
    return api_runs


def phases_subsample(torch, cli, reset_launches, launches_now, kernels,
                     root, skani_dir, res4, launches4, tsv4, label_of,
                     threads, family, tag):
    """Phase 4n: --ani-subsample over phase 4's genomes (`res4`, whose
    launches are `launches4` and TSV `tsv4`) through `cluster` at each
    SUBSAMPLE_C, the elements
    window_hits tests against phase 4's, cluster-validate at c = 125,
    and the library API at c = 125. Returns the walls and launches."""
    n = len(res4.genomes)
    elems1 = res4.clock.counts["query-elements"]
    out = {}
    for c in SUBSAMPLE_C:
        tsv = os.path.join(root, f"clusters_c{c}.tsv")
        # the caching allocator starts each run empty, as in a process of
        # its own; its retries (cudaMalloc after freeing the cache) are
        # counted across the run
        gc.collect()
        torch.cuda.empty_cache()
        retries0 = alloc_retries(torch)
        r, wall, launches = run_path(
            torch, cli, reset_launches, launches_now,
            ["cluster", "-d", skani_dir, "--ani", "95", "--device", "cuda",
             *threads, "--ani-subsample", str(c),
             "--output-cluster-definition", tsv])
        retries = alloc_retries(torch) - retries0
        check_families(r, label_of, n, family, tsv, f"subsample c={c}")
        require_launched(launches, ("positional_hashes", "window_hits"),
                         f"subsample c={c}")
        elems = r.clock.counts["query-elements"]
        fall = elems1 / max(elems, 1)
        if not 0.8 * c <= fall <= 1.25 * c:
            raise PhaseError(f"subsample c={c}: window_hits tested "
                             f"{elems} elements against {elems1} at c=1, "
                             f"{fall:.1f}x fewer, outside [{0.8 * c:.1f}, "
                             f"{1.25 * c:.1f}]")
        # the exact-ANI stage's sorted queries, built anew over the run's
        # profiles, as phase 5 times them at c = 1
        with r.store.reserve(n):
            profs = r.store.get_many(r.genomes)
        fresh = [dataclasses.replace(p, _sorted_query=None,
                                     _totals_host=None) for p in profs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in fresh:
            p.sorted_query()
            p.totals_host()
        torch.cuda.synchronize()
        sq_s = time.perf_counter() - t0
        del profs, fresh
        out[c] = {"wall": wall, "exact_ani_s": r.clock.seconds["exact-ani"],
                  "profile_s": r.clock.seconds["profile"],
                  "sorted_query_s": sq_s, "alloc_retries": retries,
                  "window_hits": launches["window_hits"],
                  "query_elements": elems, "launches": launches,
                  "clusters": r.clusters, "genomes": r.genomes}
        print(f"subsample c={c}: {n} genomes, {len(r.clusters)} clusters "
              f"== the planted families; exact-ani stage "
              f"{r.clock.seconds['exact-ani']:.3f} s (c=1: "
              f"{res4.clock.seconds['exact-ani']:.3f} s), window_hits "
              f"launches {launches['window_hits']} (c=1: "
              f"{launches4['window_hits']}), query elements {elems} "
              f"(c=1: {elems1}, {fall:.1f}x "
              f"fewer); wall {wall:.2f} s {tag}")
        print(f"subsample c={c} split: the run's {n} sorted queries built "
              f"anew {sq_s:.3f} s (host clock); allocator retries in the "
              f"run {retries} {tag}")
        print_run(f"subsample c={c}", r, launches, kernels, tag)
        del r
        gc.collect()
    v_args = cli.parse_args(
        ["cluster-validate", "--cluster-file", tsv4, "--ani", "95",
         "--min-aligned-fraction", "15", "--device", "cuda", *threads,
         "--ani-subsample", "125"])
    val, wall_v, launches_v = run_call(
        torch, reset_launches, launches_now,
        lambda: cli.run_cluster_validate(v_args))
    require_launched(launches_v, ("positional_hashes", "window_hits"),
                     "validate --ani-subsample 125")
    if val.violations != 0:
        raise PhaseError(f"cluster-validate --ani-subsample 125 finds "
                         f"{val.violations} violations in phase 4's "
                         f"clusters")
    print(f"subsample validate c=125: phase 4's TSV, {val.member_pairs} "
          f"member and {val.rep_pairs} representative pairs, 0 "
          f"violations; wall {wall_v:.2f} s {tag}")
    clusterer, clusters, wall_a, launches_a = run_api(
        torch, reset_launches, launches_now, res4.genomes,
        ["--dereplication-ani", "95", "--dereplication-ani-subsample",
         "125", "--dereplication-threads", str(THREADS)])
    if (clusterer.genome_paths, clusters) != (out[125]["genomes"],
                                              out[125]["clusters"]):
        raise PhaseError("api at --dereplication-ani-subsample 125: the "
                         "clusters differ from the CLI run's")
    require_launched(launches_a, ("positional_hashes", "window_hits"),
                     "api subsample")
    print(f"subsample api c=125: clusters equal to the CLI run's; wall "
          f"{wall_a:.2f} s {tag}")
    del clusterer
    gc.collect()
    for c in SUBSAMPLE_C:
        del out[c]["clusters"], out[c]["genomes"]
    return {"runs": out, "validate": {"wall": wall_v,
                                      "launches": launches_v},
            "api": {"wall": wall_a, "launches": launches_a}}


class SigtermWhen:
    """Send SIGTERM to this process from a watcher thread once
    `ready()` holds (polled every 2 ms). While armed, a signal that
    lands after the run has put its handlers back is recorded in
    `late` instead of ending the script."""

    def __init__(self, ready):
        self.ready = ready
        self.sent = False
        self.late = []

    def __enter__(self):
        self.prev = signal.signal(signal.SIGTERM,
                                  lambda s, f: self.late.append(s))
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()
        return self

    def _watch(self):
        while not self.done.is_set():
            if self.ready():
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.002)

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join(timeout=10)
        signal.signal(signal.SIGTERM, self.prev)


class LogLines(logging.Handler):
    """The messages a logger emits while attached."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.logger = logging.getLogger(name)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def read_log(path):
    from galah_tpu_torch.io.atomic import read_jsonl

    return read_jsonl(path)


def tmp_debris(directory):
    return [n for n in os.listdir(directory) if n.endswith(".tmp")]


def phases_resilience(torch, cli, reset_launches, launches_now, kernels,
                      root, paths, genomes4, skani_dir, tsv4, tsv4b, threads,
                      tag):
    """Phases 4j (checkpoint and resume) and 4k (quarantine); returns
    what the kernel record keeps of them."""
    from galah_tpu_torch.io.atomic import frame_line
    from galah_tpu_torch.resilience import faults, interrupt

    out = {"walls": {}, "launches": {}, "stages": {}}

    def keep(what, wall, launches, r=None):
        out["walls"][what] = wall
        out["launches"][what] = launches
        if r is not None:
            out["stages"][what] = dict(r.clock.seconds)
            print_run(what, r, launches, kernels, tag)
            r.store = r.preclusterer = None
        print(f"{what}: wall {wall:.2f} s {tag}")

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    # -- phase 4j: checkpoint and resume, finch 1024 with --rep-rounds ----
    j_dir = os.path.join(root, "resume")
    os.makedirs(j_dir)
    finch_j = ["cluster", "-f", *paths, "--precluster-method", "finch",
               "--cluster-method", "skani", "--ani", "95", *threads,
               "--rep-rounds", str(RESUME_ROUND_WIDTH)]
    ck = {r: os.path.join(j_dir, f"ck_{r}") for r in "abde"}
    tsv = {r: os.path.join(j_dir, f"{r}.tsv") for r in "abcdeE"}

    # (a0) the same run without a checkpoint, for the checkpoint's cost
    # beside it (phase 4b ran before phase 4i's cache writes)
    res_0, wall_0, launches_0 = run_path(
        torch, cli, reset_launches, launches_now,
        [*finch_j, "--device", "cuda", "--output-cluster-definition",
         tsv["b"]])
    if read(tsv["b"]) != tsv4b:
        raise PhaseError(f"resume (a0): the --rep-rounds "
                         f"{RESUME_ROUND_WIDTH} TSV differs from phase 4b's")
    keep("resume (a0) without checkpoint", wall_0, launches_0, res_0)
    del res_0

    # (a) uninterrupted, checkpointed
    res_a, wall, launches_a = run_path(
        torch, cli, reset_launches, launches_now,
        [*finch_j, "--device", "cuda", "--checkpoint-dir", ck["a"],
         "--output-cluster-definition", tsv["a"]])
    if read(tsv["a"]) != tsv4b:
        raise PhaseError("resume (a): the checkpointed --rep-rounds "
                         f"{RESUME_ROUND_WIDTH} TSV differs from phase 4b's")
    records, bad = read_log(os.path.join(ck["a"], "clusters.jsonl"))
    got = sorted(sorted(c) for rec in records for c in rec["clusters"])
    if bad or got != sorted(sorted(c) for c in res_a.clusters) or \
            sorted(r["precluster"] for r in records) != \
            list(range(len(records))):
        raise PhaseError("resume (a): clusters.jsonl does not hold one "
                         "record a precluster with the run's clusters")
    if os.path.exists(os.path.join(ck["a"], "greedy_rounds.jsonl")):
        raise PhaseError("resume (a): greedy_rounds.jsonl outlived the run")
    rounds_a = res_a.clock.counts["greedy-rounds"]
    print(f"resume (a): finch {len(paths)} genomes, --rep-rounds "
          f"{RESUME_ROUND_WIDTH}, {rounds_a} greedy rounds, checkpointed: "
          f"TSV byte-identical to phase 4b's; clusters.jsonl {len(records)} "
          f"records, one a precluster; no round log left; checkpoint-write "
          f"{res_a.clock.seconds.get('checkpoint-write', 0.0):.4f} s; wall "
          f"{wall:.2f} s against {wall_0:.2f} s without the checkpoint "
          f"just before {tag}")
    keep("resume (a)", wall, launches_a, res_a)
    del res_a

    # (b) stopped by SIGTERM once the round log holds its first record,
    # with a run report and a trace
    log_b = os.path.join(ck["b"], "greedy_rounds.jsonl")
    rep_b = os.path.join(j_dir, "b_report.json")
    trace_b = os.path.join(j_dir, "b_trace.json")
    with SigtermWhen(lambda: os.path.exists(log_b)
                     and os.path.getsize(log_b) > 0) as term:
        wall, launches_b = run_main(
            torch, cli, reset_launches, launches_now,
            [*finch_j, "--device", "cuda", "--checkpoint-dir", ck["b"],
             "--output-cluster-definition", tsv["b"],
             "--run-report", rep_b, "--trace-events", trace_b],
            want_rc=interrupt.EXIT_PREEMPTED)
    stops, bad = read_log(os.path.join(ck["b"], "interruptions.jsonl"))
    if not term.sent or term.late or bad or \
            [(s["signal"], s["boundary"]) for s in stops] != \
            [("SIGTERM", "greedy-round-saved")]:
        raise PhaseError(f"resume (b): not one SIGTERM stop at "
                         f"greedy-round-saved: {stops}, late {term.late}")
    rounds_b = len(read_log(log_b)[0])
    rep, _, _ = check_obs_artifacts("resume (b)", rep_b, trace_b, None,
                                    launches_b, tag, stopped=True)
    kinds = [ev["kind"] for ev in rep["events"]]
    if rep["preemption"]["boundary"] != "greedy-round-saved" or \
            rep["preemption"]["signals"] != ["SIGTERM"] or \
            "preempted" not in kinds:
        raise PhaseError(f"resume (b): the report's preemption "
                         f"{rep['preemption']}, events {kinds}")
    print(f"resume (b): SIGTERM once the round log held a record: main "
          f"returned {interrupt.EXIT_PREEMPTED} at greedy-round-saved "
          f"after {rounds_b} of {rounds_a} rounds; one interruption "
          f"record; the run report says stop requested by SIGTERM at "
          f"greedy-round-saved with a `preempted` event, the trace "
          f"parses {tag}")
    keep("resume (b)", wall, launches_b)

    # (c) --resume on (b)'s checkpoint
    res_c, wall, launches_c = run_path(
        torch, cli, reset_launches, launches_now,
        [*finch_j, "--device", "cuda", "--checkpoint-dir", ck["b"],
         "--resume", "--output-cluster-definition", tsv["c"]])
    if read(tsv["c"]) != read(tsv["a"]):
        raise PhaseError("resume (c): the resumed TSV differs from (a)'s")
    if launches_c["fused_sketch"] or launches_c["pairlist"] or \
            launches_c["window_hits"] >= launches_a["window_hits"]:
        raise PhaseError(
            f"resume (c): fused_sketch {launches_c['fused_sketch']}, "
            f"pairlist {launches_c['pairlist']} (want 0, 0), window_hits "
            f"{launches_c['window_hits']} (want fewer than (a)'s "
            f"{launches_a['window_hits']})")
    print(f"resume (c): --resume after the stop: TSV byte-identical to "
          f"(a)'s; launches fused_sketch 0, pairlist 0, window_hits "
          f"{launches_c['window_hits']} against (a)'s "
          f"{launches_a['window_hits']}; "
          f"{res_c.clock.counts['greedy-replayed-pairs']} replayed pairs; "
          f"checkpoint-read "
          f"{res_c.clock.seconds.get('checkpoint-read', 0.0):.4f} s {tag}")
    keep("resume (c)", wall, launches_c, res_c)
    del res_c

    # (d) a subprocess killed at the second round's append
    site = "site=io.atomic.append[ckpt.greedy]"
    env = dict(os.environ, GALAH_FI=f"{site};kind=slow-io;hang=0;max=1|"
                                    f"{site};kind=kill")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "galah_tpu_torch", *finch_j, "-q",
         "--device", "cuda", "--checkpoint-dir", ck["d"],
         "--output-cluster-definition", tsv["d"]],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    wall_d = time.perf_counter() - t0
    log_d = os.path.join(ck["d"], "greedy_rounds.jsonl")
    if proc.returncode != faults.KILL_EXIT_CODE:
        raise PhaseError(f"resume (d): the subprocess exited "
                         f"{proc.returncode}, not {faults.KILL_EXIT_CODE}:"
                         f"\n{proc.stderr[-3000:]}")
    if len(read_log(log_d)[0]) != 1 or tmp_debris(ck["d"]):
        raise PhaseError("resume (d): after the kill the round log does "
                         "not hold one record, or .tmp files remain")
    # a kill inside the append's write would leave half a record
    torn = frame_line({"digest": "torn", "pairs": [[0, 1, 0.99]]})
    with open(log_d, "a") as fh:
        fh.write(torn[:len(torn) // 2])
    with LogLines("galah_tpu_torch.cluster.checkpoint") as lines:
        res_d, wall, launches_d = run_path(
            torch, cli, reset_launches, launches_now,
            [*finch_j, "--device", "cuda", "--checkpoint-dir", ck["d"],
             "--resume", "--output-cluster-definition", tsv["d"]])
    dropped = [m for m in lines.lines if m.startswith("Dropped 1 torn")]
    if read(tsv["d"]) != read(tsv["a"]) or not dropped or \
            tmp_debris(ck["d"]):
        raise PhaseError(f"resume (d): the resume after the kill gave "
                         f"another TSV, logged no dropped record "
                         f"({lines.lines}) or left .tmp files")
    print(f"resume (d): python -m galah_tpu_torch with GALAH_FI kill at "
          f"the second round's append exited {proc.returncode} after "
          f"{wall_d:.2f} s (process start included); the resume dropped "
          f"the torn record ({dropped[0]!r}) and wrote (a)'s TSV; no .tmp "
          f"left {tag}")
    keep("resume (d)", wall, launches_d, res_d)
    del res_d

    # (e) skani 512, stopped during the distance pass
    skani_e = ["cluster", "-d", skani_dir, "--ani", "95", "--device",
               "cuda", *threads, "--checkpoint-dir", ck["e"]]
    fp_e = os.path.join(ck["e"], "fingerprint.json")
    with SigtermWhen(lambda: os.path.exists(fp_e)) as term:
        wall, launches_e = run_main(
            torch, cli, reset_launches, launches_now,
            [*skani_e, "--output-cluster-definition", tsv["e"]],
            want_rc=interrupt.EXIT_PREEMPTED)
    stops, _ = read_log(os.path.join(ck["e"], "interruptions.jsonl"))
    if term.late or [s["boundary"] for s in stops] != ["distances-saved"]:
        raise PhaseError(f"resume (e): not one stop at distances-saved: "
                         f"{stops}, late {term.late}")
    keep("resume (e) stopped", wall, launches_e)
    res_e, wall, launches_E = run_path(
        torch, cli, reset_launches, launches_now,
        [*skani_e, "--resume", "--output-cluster-definition", tsv["E"]])
    if read(tsv["E"]) != tsv4 or any(launches_E.values()):
        raise PhaseError(f"resume (e): the resumed skani TSV differs from "
                         f"phase 4's, or kernels were launched: "
                         f"{launches_E}")
    print(f"resume (e): skani {len(genomes4)} genomes, SIGTERM once "
          f"fingerprint.json existed: stopped at distances-saved; the "
          f"resume launched no kernel and wrote phase 4's TSV; wall "
          f"{wall:.3f} s {tag}")
    keep("resume (e)", wall, launches_E, res_e)
    del res_e
    shutil.rmtree(j_dir)

    # -- phase 4k: quarantine ------------------------------------------
    q_dir = os.path.join(root, "quarantine")
    os.makedirs(q_dir)
    bad = {"empty": os.path.join(q_dir, "empty.fna"),
           "trunc": os.path.join(q_dir, "trunc.fna.gz"),
           "binary": os.path.join(q_dir, "binary.fna"),
           "missing": os.path.join(q_dir, "missing.fna")}
    with open(bad["empty"], "wb"):
        pass
    import gzip

    whole = gzip.compress(read(genomes4[0]))
    with open(bad["trunc"], "wb") as fh:
        fh.write(whole[:len(whole) // 2])
    with open(bad["binary"], "wb") as fh:
        fh.write(bytes(range(256)) * 4096)
    # the reasons galah_tpu's validate_genome gives these files
    # (tests/test_torch_quarantine.py holds the port to them)
    want = {bad["empty"]: "empty", bad["trunc"]: "corrupt",
            bad["binary"]: "empty", bad["missing"]: "missing"}
    listing = [genomes4[0], bad["empty"], *genomes4[1:100], bad["trunc"],
               *genomes4[100:300], bad["binary"], *genomes4[300:],
               bad["missing"]]
    q_list = os.path.join(q_dir, "genomes.txt")
    with open(q_list, "w") as fh:
        fh.write("".join(p + "\n" for p in listing))
    q_tsv = os.path.join(q_dir, "clusters.tsv")
    res_q, wall, launches_q = run_path(
        torch, cli, reset_launches, launches_now,
        ["cluster", "--genome-fasta-list", q_list, "--on-bad-genome",
         "skip", "--ani", "95", "--device", "cuda", *threads,
         "--output-cluster-definition", q_tsv])
    with open(os.path.join(q_dir, "quarantine.json")) as fh:
        manifest = json.load(fh)["quarantined"]
    got = {r["path"]: r["reason"] for r in manifest}
    if read(q_tsv) != tsv4 or got != want or len(manifest) != 4:
        raise PhaseError(f"quarantine: the skip run's TSV differs from "
                         f"phase 4's, or the manifest is not the four bad "
                         f"inputs with galah_tpu's reasons: {got}")
    require_launched(launches_q, ("window_hits", "tile_stats",
                                  "positional_hashes"), "quarantine")
    print(f"quarantine: {len(genomes4)} genomes and 4 bad inputs with "
          f"--on-bad-genome skip: TSV byte-identical to phase 4's; "
          f"quarantine.json beside it: "
          f"{sorted(set(got.values()))} for empty, truncated gzip, "
          f"binary and missing; preflight "
          f"{res_q.clock.seconds['preflight-genomes']:.3f} s {tag}")
    keep("quarantine", wall, launches_q, res_q)
    del res_q
    # without skip the same input fails, and so do the bad files alone
    no_skip = [["--genome-fasta-list", q_list],
               ["-f", genomes4[0], bad["empty"], *genomes4[1:8]]]
    for spec in no_skip:
        wall, _ = run_main(torch, cli, reset_launches, launches_now,
                           ["cluster", *spec, "--ani", "95", "-q",
                            "--device", "cuda", *threads,
                            "--output-cluster-definition",
                            os.path.join(q_dir, "x.tsv")], want_rc=1)
        print(f"quarantine without skip: `cluster {spec[0]} ...` exited 1 "
              f"in {wall:.2f} s {tag}")
    shutil.rmtree(q_dir)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def index_bytes(path):
    """The committed bytes of an index directory by file name (every file
    but interruptions.jsonl)."""
    out = {}
    for name in sorted(os.listdir(path)):
        if name != "interruptions.jsonl":
            with open(os.path.join(path, name), "rb") as fh:
                out[name] = fh.read()
    return out


def phases_index(torch, cli, reset_launches, launches_now, kernels, root,
                 paths, label_of, report, threads, family, seed, length,
                 tag):
    """Phase 4l: the persistent sketch index over the finch corpus,
    through ``index`` as a user runs it. Returns the walls and launches
    of each action."""
    from galah_tpu_torch.index import incremental
    from galah_tpu_torch.index.store import IndexStore
    from galah_tpu_torch.quality import quality_order_genomes

    out = {"walls": {}, "launches": {}, "stages": {}}

    def keep(what, wall, launches, res=None):
        out["walls"][what] = wall
        out["launches"][what] = launches
        if res is not None and res.clock is not None:
            out["stages"][what] = dict(res.clock.seconds)
            print_run(f"index {what}", res, launches, kernels, tag)
        else:
            for name in kernels:
                print(f"index {what} launches {name}: {launches[name]} "
                      f"{tag}")
        print(f"index {what}: wall {wall:.2f} s {tag}")

    def index_run(argv):
        return run_call(torch, reset_launches, launches_now,
                        lambda: cli.run_index(cli.parse_args(argv)))

    i_dir = os.path.join(root, "index")
    os.makedirs(i_dir)
    grown, scratch = (os.path.join(i_dir, n) for n in ("grown", "scratch"))
    ordered, _ = quality_order_genomes(paths, checkm2_quality_report=report,
                                       threads=THREADS)
    n_base = 3 * len(ordered) // 4
    base, new = ordered[:n_base], ordered[n_base:]
    quality = ["--checkm2-quality-report", report, *threads]
    on = ["--device", "cuda"]

    # build the first three quarters in quality order, insert the rest
    res, wall, launches = index_run(
        ["index", "--index-dir", grown, *on, "build", "-f", *base,
         *quality])
    keep("build", wall, launches, res)
    require_launched(launches, ("fused_sketch", "tile_stats"),
                     "index build")
    res, wall, launches = index_run(
        ["index", "--index-dir", grown, *on, "insert", "-f", *new,
         *quality, "--batch", str(INDEX_BATCH)])
    keep("insert", wall, launches, res)
    batches = -(-len(new) // INDEX_BATCH)
    require_launched(launches, ("fused_sketch", "pairlist"), "index insert")
    if launches["pairlist"] != batches or res.info["inserted"] != len(new):
        raise PhaseError(f"index insert: {launches['pairlist']} pairlist "
                         f"launches for {batches} batches, "
                         f"{res.info['inserted']} genomes inserted")
    # the grown index against a from-scratch build over all genomes
    res, wall, launches = index_run(
        ["index", "--index-dir", scratch, *on, "build", "-f", *ordered,
         *quality])
    keep("build from scratch", wall, launches, res)
    if len(ordered) >= FINCH_MIN_GENOMES:
        require_launched(launches, ("fused_sketch", "pairlist"),
                         "index build from scratch")
    got, want = index_bytes(grown), index_bytes(scratch)
    gen2 = json.loads(got.pop("gen-000002.json"))
    got.pop("gen-000001.json")
    gen1 = json.loads(want.pop("gen-000001.json"))
    got.pop("MANIFEST.json")
    want.pop("MANIFEST.json")
    gen2.pop("generation")
    gen1.pop("generation")
    if got != want or gen2 != gen1:
        raise PhaseError("index: the grown index's committed bytes differ "
                         "from the from-scratch build's: " + ", ".join(
                             n for n in want if got.get(n) != want[n]))
    state = IndexStore(grown).load()
    clusters = incremental.clusters_from_state(state)
    fams = sorted(sorted(label_of[state.genomes[g]] for g in c)
                  for c in clusters)
    if fams != sorted([f] * family for f in {label_of[p] for p in paths}):
        raise PhaseError(f"index: {len(clusters)} clusters differ from the "
                         f"planted families")
    print(f"index: build {len(base)} + insert {len(new)} (--batch "
          f"{INDEX_BATCH}) byte-identical to a from-scratch build of "
          f"{len(ordered)} (logs {', '.join(sorted(want))}; generation "
          f"manifests equal but for the number); {len(clusters)} clusters "
          f"== the planted families, {len(state.pairs)} pairs {tag}")

    # query: inserted members and fresh random genomes
    q_dir = os.path.join(i_dir, "novel")
    os.makedirs(q_dir)
    novel, _, _ = make_corpus(q_dir, QUERY_GENOMES, length, 1, seed + 7)
    members = new[:QUERY_GENOMES]
    q_tsv = os.path.join(i_dir, "query.tsv")
    wall, launches = run_main(
        torch, cli, reset_launches, launches_now,
        ["index", "--index-dir", grown, *on, "-q", "query", "-f", *members,
         *novel, *threads, "--output", q_tsv])
    keep("query", wall, launches)
    require_launched(launches, ("fused_sketch", "pairlist"), "index query")
    with open(q_tsv) as fh:
        rows = [ln.split("\t") for ln in fh.read().splitlines()[1:]]
    want_rows = len(members) + len(novel)
    if len(rows) != want_rows or any(
            r[1] != "member" or label_of[r[2]] != label_of[r[0]]
            for r in rows[:len(members)]) or any(
            r[1:] != ["novel", "NA", "NA"] for r in rows[len(members):]):
        raise PhaseError(f"index query: {len(rows)} rows; members must join "
                         f"their family's representative, fresh genomes be "
                         f"novel")
    print(f"index query: {len(members)} inserted genomes member of their "
          f"family's cluster, {len(novel)} fresh genomes novel {tag}")

    # remove a representative with members, then fsck
    has_members = set(state.membership.values())
    rep = next(r for r in state.reps if r in has_members)
    orphans = sorted(g for g, r in state.membership.items() if r == rep)
    wall, launches = run_main(
        torch, cli, reset_launches, launches_now,
        ["index", "--index-dir", grown, *on, "-q", "remove", "-f",
         state.genomes[rep]])
    keep("remove", wall, launches)
    after = IndexStore(grown).load()
    if (rep not in after.tombstones or orphans[0] not in after.reps
            or any(after.membership[g] != orphans[0]
                   for g in orphans[1:])):
        raise PhaseError("index remove: the representative's cluster did "
                         "not re-elect its lowest-index member")
    wall, launches = run_main(
        torch, cli, reset_launches, launches_now,
        ["index", "--index-dir", grown, *on, "-q", "fsck"])
    keep("fsck", wall, launches)
    print(f"index remove: representative {rep} tombstoned, {orphans[0]} "
          f"re-elected for {len(orphans) - 1} member(s); generation "
          f"{after.generation}; fsck OK {tag}")
    shutil.rmtree(i_dir)
    return out


def index_pair_pass(torch, device, seed, tag):
    """Phase 4l, catalogue scale: an insert batch's pair pass over a
    seeded synthetic index of CATALOGUE_ROWS bottom-1000 sketches in
    planted families of 4, and INDEX_PASS_ROWS inserted rows (near
    duplicates of indexed rows, fresh families, two empty and two short
    rows): every (u, g), u < g, in one pass, as ``index insert --batch
    INDEX_PASS_ROWS`` gives it. The kernel's integers against the plain
    version on a sample and against the host ``merge_stats`` on a
    smaller one; timed whole, kernel alone and host loop."""
    from galah_tpu_torch.index import incremental
    from galah_tpu_torch.kernels.rehearse_pairlist import (SUBSTITUTED,
                                                           family_rows)
    from galah_tpu_torch.kernels.rehearse_pairlist import work as pl_work
    from galah_tpu_torch.ops.pairlist import (pair_stats_pairs_plain,
                                              run_launch, valid_lengths)
    from galah_tpu_torch.ops.pairwise import ani_to_jaccard
    from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs
    from galah_tpu_torch.ops.u64 import from_biased
    from galah_tpu_torch.timing import StageClock

    rng = np.random.default_rng(seed + 11)
    k = 1000
    t0 = time.perf_counter()
    indexed = np.concatenate([family_rows(rng, 4)
                              for _ in range(CATALOGUE_ROWS // 4)])
    sentinel = np.iinfo(np.int64).max
    near = []
    for r in rng.choice(CATALOGUE_ROWS, size=INDEX_PASS_ROWS // 4,
                        replace=False):
        row = indexed[r][indexed[r] != sentinel].copy()
        swap = rng.random(row.shape[0]) < SUBSTITUTED
        row[swap] = rng.integers(-(1 << 63), sentinel,
                                 size=int(swap.sum()), dtype=np.int64)
        row = np.unique(row)
        near.append(np.concatenate(
            [row, np.full(k - row.shape[0], sentinel, dtype=np.int64)]))
    fresh = np.concatenate([family_rows(rng, 4) for _ in range(
        (INDEX_PASS_ROWS - len(near) - 4) // 4)])
    edge = np.full((4, k), sentinel, dtype=np.int64)
    for i, n in ((2, 300), (3, 1)):
        edge[i, :n] = np.sort(fresh[i, :n])
    host = np.concatenate([indexed, np.stack(near), fresh, edge])
    n_rows = host.shape[0]
    gen_s = time.perf_counter() - t0
    mat = torch.from_numpy(host).to(device)
    # pi: the inserted row g, pj: every u < g, as insert lists them
    pi, pj = incremental.pairs_below(np.arange(n_rows, dtype=np.int64),
                                     CATALOGUE_ROWS, n_rows)
    common, total = pair_stats_for_pairs(mat, pi, pj, k)
    # the plain version on a seeded sample of the list, on the card
    sample = np.sort(rng.choice(pi.shape[0], size=PASS_SAMPLE,
                                replace=False))
    ti = torch.from_numpy(pi[sample]).to(device)
    tj = torch.from_numpy(pj[sample]).to(device)
    pcs, pts = [], []
    for s0 in range(0, PASS_SAMPLE, 1 << 16):
        pc, pt = pair_stats_pairs_plain(mat, ti[s0:s0 + (1 << 16)],
                                        tj[s0:s0 + (1 << 16)], k)
        pcs.append(pc.cpu().numpy())
        pts.append(pt.cpu().numpy())
    err = int(max(np.abs(np.concatenate(pcs) - common[sample]).max(),
                  np.abs(np.concatenate(pts) - total[sample]).max()))
    if err:
        raise PhaseError(f"pairlist disagrees with its plain version on "
                         f"the index pass's sample: max error {err}")
    # the host merge_stats on a smaller sample, timed
    few = sample[rng.choice(PASS_SAMPLE, size=HOST_SAMPLE, replace=False)]
    rows_u64 = from_biased(torch.from_numpy(host))
    hosted = []
    t0 = time.perf_counter()
    for p in few:
        a, b = rows_u64[pi[p]], rows_u64[pj[p]]
        hosted.append(incremental.merge_stats(
            a[a != np.uint64(2 ** 64 - 1)], b[b != np.uint64(2 ** 64 - 1)],
            k))
    host_pair_us = (time.perf_counter() - t0) * 1e6 / HOST_SAMPLE
    if hosted != list(zip(common[few].tolist(), total[few].tolist())):
        raise PhaseError("pairlist disagrees with the host merge_stats on "
                         "the index pass's sample")
    # timing: the kernel alone, the pass (host lists in, host ints out),
    # and the pass with the keep rule and float64 ANI of the insert
    lens = valid_lengths(mat)
    tpi, tpj = (torch.from_numpy(a).to(device) for a in (pi, pj))
    outs = (torch.empty(pi.shape[0], dtype=torch.int32, device=device),
            torch.empty(pi.shape[0], dtype=torch.int32, device=device))
    kernel_ms = time_ms(torch, lambda: run_launch(mat, lens, tpi, tpj, k,
                                                  *outs), 5)
    pass_ms = host_ms(torch, lambda: pair_stats_for_pairs(mat, pi, pj, k),
                      3)
    j_thr = ani_to_jaccard(0.90, 21)
    kept_ms = host_ms(torch, lambda: incremental.kept_pairs(
        mat, pi, pj, k, 21, j_thr, StageClock(device)), 3)
    ki, _, _ = incremental.kept_pairs(mat, pi, pj, k, 21, j_thr,
                                      StageClock(device))
    p_bound, p_by = bound(*pl_work(pi, pj, k, common, total))
    host_s = host_pair_us * pi.shape[0] / 1e6
    print(f"index pair pass: {CATALOGUE_ROWS} indexed + {INDEX_PASS_ROWS} "
          f"inserted rows, K={k} ({mat.numel() * 8 / 1e6:.1f} MB on the "
          f"card; made in {gen_s:.2f} s), {pi.shape[0]} pairs, "
          f"{ki.shape[0]} kept at 90%: kernel alone {kernel_ms:.4f} ms, "
          f"pass (host lists in, ints out) {pass_ms:.4f} ms, with the keep "
          f"rule and ANI {kept_ms:.4f} ms, bound {p_bound:.4f} ms ({p_by}); "
          f"plain version equal on {PASS_SAMPLE} sampled pairs, host "
          f"merge_stats equal on {HOST_SAMPLE} at {host_pair_us:.2f} us a "
          f"pair, {host_s:.1f} s for the list {tag}")
    return {"rows": int(n_rows), "pairs": int(pi.shape[0]),
            "kept": int(ki.shape[0]), "kernel_only_ms": kernel_ms,
            "pass_ms": pass_ms, "kept_pass_ms": kept_ms,
            "bound_ms": p_bound, "bound_by": p_by, "max_abs_err": err,
            "plain_sample": PASS_SAMPLE, "host_sample": HOST_SAMPLE,
            "host_us_per_pair": host_pair_us, "host_list_s": host_s}


def stage_names(tree):
    """(name, count) of every node of a report's stage tree."""
    for node in tree:
        yield node["name"], node["count"]
        yield from stage_names(node.get("children", []))


def check_obs_artifacts(what, rep_path, trace_path, hb_dir, want_launches,
                        tag, stopped=False):
    """A run's report, trace and heartbeat, from the port's own readers:
    the report valid, its dispatch section the launch deltas of
    `want_launches`, its preemption section as `stopped` says, the
    trace plain JSON with one stage span for each stage the clock
    timed and no nvcc span (every kernel was built before), the
    heartbeat (when `hb_dir`) at least 2 beats, its last the final one.
    Returns (report, the trace's events, the beats)."""
    from galah_tpu_torch.obs import heartbeat as obs_heartbeat
    from galah_tpu_torch.obs import report as report_mod

    rep = report_mod.load(rep_path)
    problems = report_mod.validate(rep)
    if problems:
        raise PhaseError(f"{what}: the run report is not valid: "
                         f"{problems[:3]}")
    want = {k: v for k, v in want_launches.items() if v}
    if rep["dispatch"]["dispatches"] != want:
        raise PhaseError(f"{what}: the report's dispatches "
                         f"{rep['dispatch']['dispatches']} are not the "
                         f"launch deltas {want}")
    pre = rep.get("preemption") or {}
    if bool(pre.get("stop_requested")) != stopped:
        raise PhaseError(f"{what}: preemption section {pre}, stop "
                         f"requested should be {stopped}")
    with open(trace_path) as fh:
        events = json.load(fh)
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "stage":
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    timed = {}
    for name, count in stage_names(rep["stages"]["tree"]):
        timed[name] = timed.get(name, 0) + count
    if spans != timed:
        raise PhaseError(f"{what}: the trace's stage spans {spans} are "
                         f"not the stages the clock timed {timed}")
    nvcc = [ev for ev in events if ev.get("cat") == "nvcc"]
    if nvcc:
        raise PhaseError(f"{what}: {len(nvcc)} nvcc spans, but every "
                         "kernel was built before this run")
    beats = []
    if hb_dir is not None:
        beats, torn = obs_heartbeat.load(hb_dir)
        hb = (rep.get("flow") or {}).get("heartbeat") or {}
        if len(beats) < 2 or torn or beats[-1]["beat"] != hb.get("beats"):
            raise PhaseError(f"{what}: heartbeat {len(beats)} beats "
                             f"({torn} torn), the last "
                             f"{beats[-1]['beat'] if beats else None}, "
                             f"the report's final beat {hb.get('beats')}")
    import importlib.util

    checker = ("jsonschema" if importlib.util.find_spec("jsonschema")
               else "required sections only: no jsonschema")
    print(f"{what}: report valid ({checker}), "
          f"dispatches {rep['dispatch']['dispatches']} == the launch "
          f"deltas; trace {len(events)} events, "
          f"{sum(spans.values())} stage spans == the clock's "
          f"{sum(timed.values())} stages, no nvcc span; heartbeat "
          f"{len(beats)} beats {tag}")
    return rep, events, beats


def run_cli_process(argv, log, env):
    """``python -m galah_tpu_torch`` with `argv` in a process of its own,
    its output to `log`; (exit code, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(log, "wb") as fh:
        rc = subprocess.run([sys.executable, "-m", "galah_tpu_torch", *argv],
                            cwd=here, env=env, stdout=fh,
                            stderr=subprocess.STDOUT, check=False).returncode
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log, "rb") as fh:
            tail = fh.read()[-3000:].decode(errors="replace")
        raise PhaseError(f"`{' '.join(argv[:3])} ...` exited {rc}:\n{tail}")
    return wall


def obs_costs(rep_path, n_events, n_beats, root, tag):
    """The host seconds observability adds to a run, each part timed on
    its own in this process: assembling, validating and writing the
    report of `rep_path`'s size, emitting `n_events` trace events, and
    `n_beats` heartbeat beats (on their own thread in a run)."""
    from galah_tpu_torch import obs
    from galah_tpu_torch.obs import report as report_mod

    rep = report_mod.load(rep_path)
    t0 = time.perf_counter()
    problems = report_mod.validate(rep)
    report_mod.write(os.path.join(root, "cost_report.json"), rep)
    report_s = time.perf_counter() - t0
    rec = obs.trace.TraceRecorder(os.path.join(root, "cost_trace.json"))
    t0 = time.perf_counter()
    for _ in range(n_events):
        rec.complete("profile", t0, 0.001)
    trace_s = time.perf_counter() - t0
    rec.close()
    hb = obs.heartbeat.Heartbeat(os.path.join(root, "cost_hb"), 3600.0)
    t0 = time.perf_counter()
    for _ in range(8):
        hb.beat()
    beat_s = (time.perf_counter() - t0) / 8
    print(f"obs costs: validating and writing a {os.path.getsize(rep_path)}"
          f" B report {report_s * 1e3:.1f} ms; {n_events} trace events "
          f"{trace_s * 1e3:.1f} ms; a beat {beat_s * 1e3:.2f} ms, "
          f"{n_beats} beats {n_beats * beat_s * 1e3:.1f} ms (on the beat "
          f"thread) {tag}")
    if problems:
        raise PhaseError(f"obs costs: the report is not valid: {problems}")
    return {"report_ms": report_s * 1e3, "trace_ms": trace_s * 1e3,
            "beat_ms": beat_s * 1e3}


def nvcc_span(root, tag):
    """A kernel built anew (window_hits, into a directory of its own)
    with a trace open in this process: the trace must hold one nvcc
    span, for that build."""
    from galah_tpu_torch.kernels import build
    from galah_tpu_torch.obs import trace

    out_dir = os.path.join(root, "nvcc_span")
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "trace.json")
    lib_path = build._lib_path
    build._lib_path = lambda name: os.path.join(
        out_dir, os.path.basename(lib_path(name)))
    try:
        trace.start(path)
        seconds = build.build(["window_hits"])
    finally:
        trace.stop()
        build._lib_path = lib_path
    with open(path) as fh:
        spans = [ev for ev in json.load(fh) if ev.get("cat") == "nvcc"]
    if [(ev["ph"], ev["name"]) for ev in spans] != [
            ("X", "nvcc window_hits.cu")]:
        raise PhaseError(f"obs: a traced build of window_hits gave the "
                         f"nvcc spans {spans}")
    print(f"obs: window_hits.cu built anew under a trace: one nvcc span "
          f"of {spans[0]['dur'] / 1e6:.2f} s (build {seconds:.2f} s) {tag}")
    return spans[0]["dur"] / 1e3


def phase_obs(root, runs, threads, tag):
    """Phase 4o: each of `runs`, {what: (argv, phase TSV bytes, phase
    launches, phase clock, phase wall)}, through ``python -m
    galah_tpu_torch cluster`` with --run-report, --trace-events and
    GALAH_OBS_HEARTBEAT_S=0.25, and finch's also without them (the
    control: the same process start, CUDA context and first-run
    allocations); returns the record's entries."""
    env = dict(os.environ, GALAH_OBS_HEARTBEAT_S=str(OBS_HEARTBEAT_S))
    out = {}
    # a report's schema check imports jsonschema once a process
    probe = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         "import jsonschema; print(time.perf_counter() - t)"],
        capture_output=True, text=True, check=False)
    if probe.returncode == 0:
        out["jsonschema_import_ms"] = float(probe.stdout) * 1e3
        print(f"obs costs: importing jsonschema in a fresh process "
              f"{out['jsonschema_import_ms']:.1f} ms {tag}")
    for what, (argv, tsv_want, launches, clock, wall) in runs.items():
        d = os.path.join(root, f"obs_{what}")
        os.makedirs(d)
        tsv = os.path.join(d, "clusters.tsv")
        rep_path = os.path.join(d, "run_report.json")
        trace_path = os.path.join(d, "trace.json")
        wall_obs = run_cli_process(
            [*argv, *threads, "--output-cluster-definition", tsv,
             "--run-report", rep_path, "--trace-events", trace_path],
            os.path.join(d, "log.txt"), env)
        with open(tsv, "rb") as fh:
            if fh.read() != tsv_want:
                raise PhaseError(f"obs {what}: the TSV differs from the "
                                 "phase's without observability")
        rep, events, beats = check_obs_artifacts(
            f"obs {what}", rep_path, trace_path, d, launches, tag)
        funnel = rep["funnel"]
        counters = rep["counters"]
        for key, count in (("possible_pairs", "screen-possible-pairs"),
                           ("screened_candidates", "screen-candidates"),
                           ("kept_pairs", "screen-kept-pairs"),
                           ("exact_ani_computed", "exact-ani-computed"),
                           ("exact_ani_wasted", "exact-ani-wasted")):
            if not (funnel[key] == counters.get(count, 0)
                    == clock.counts.get(count, 0)):
                raise PhaseError(
                    f"obs {what}: funnel {key} {funnel[key]}, the "
                    f"report's {count} {counters.get(count, 0)}, the "
                    f"phase's {clock.counts.get(count, 0)}")
        if argv[argv.index("--precluster-method") + 1] != "skani" \
                and funnel["exact_ani_computed"] <= 0:
            raise PhaseError(f"obs {what}: no exact ANI computed")
        drift = {k: (v, clock.counts.get(k)) for k, v in counters.items()
                 if not k.startswith("disp[")
                 and v != clock.counts.get(k)}
        print(f"obs {what}: TSV byte-identical to the phase's; funnel "
              f"possible {funnel['possible_pairs']}, candidates "
              f"{funnel['screened_candidates']}, kept "
              f"{funnel['kept_pairs']}, exact ANI computed "
              f"{funnel['exact_ani_computed']} ({funnel['exact_ani_wasted']}"
              f" wasted) == the phase's counts; other counts that differ "
              f"from the phase's: {drift or 'none'} {tag}")
        entry = {"wall_s": wall_obs, "run_s": rep["run"]["duration_s"],
                 "phase_wall_s": wall,
                 "dispatches": rep["dispatch"]["dispatches"],
                 "funnel": {k: v for k, v in funnel.items()
                            if k != "cache"},
                 "trace_events": len(events), "beats": len(beats),
                 "report_bytes": os.path.getsize(rep_path),
                 "trace_bytes": os.path.getsize(trace_path),
                 "stages_s": {n["name"]: n["total_s"]
                              for n in rep["stages"]["tree"]},
                 "phase_stages_s": {n["name"]: n["total_s"]
                                    for n in clock.tree()}}
        control = ""
        if what == "finch":
            c_dir = os.path.join(d, "control")
            os.makedirs(c_dir)
            c_tsv = os.path.join(c_dir, "clusters.tsv")
            entry["control_wall_s"] = run_cli_process(
                [*argv, *threads, "--output-cluster-definition", c_tsv],
                os.path.join(c_dir, "log.txt"),
                {k: v for k, v in os.environ.items()
                 if not k.startswith("GALAH_OBS_")})
            with open(c_tsv, "rb") as fh:
                if fh.read() != tsv_want:
                    raise PhaseError("obs control: the TSV differs")
            control = (f", {entry['control_wall_s']:.2f} s for the same "
                       f"process without them")
        print(f"obs {what}: wall {wall_obs:.2f} s as a process with "
              f"report, trace and heartbeat{control} (the run "
              f"{rep['run']['duration_s']:.2f} s of it) against "
              f"{wall:.2f} s for the phase's run in this process without "
              f"them; report {entry['report_bytes']} B, trace "
              f"{entry['trace_bytes']} B, {len(beats)} beats {tag}")
        print(f"obs {what}: stages with observability, in its process / "
              f"the phase's, inclusive seconds: " + ", ".join(
                  f"{n} {v:.3f}/{entry['phase_stages_s'].get(n, 0.0):.3f}"
                  for n, v in entry["stages_s"].items()) + f" {tag}")
        entry["costs"] = obs_costs(rep_path, len(events), len(beats), d, tag)
        out[what] = entry
    seen = set()
    for what in runs:
        seen.update(out[what]["dispatches"])
    from galah_tpu_torch.kernels import KERNELS

    missing = [k for k in KERNELS if k not in seen]
    if missing:
        raise PhaseError(f"obs: kernels {missing} launched in none of the "
                         f"three observed runs")
    print(f"obs: all {len(KERNELS)} kernels launched across the observed "
          f"runs {tag}")
    out["nvcc_span_ms"] = nvcc_span(root, tag)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=512,
                    help="skani corpus size, a multiple of 4 (default 512)")
    ap.add_argument("--finch-genomes", type=int, default=FINCH_MIN_GENOMES,
                    help="finch corpus size, a multiple of 4, at least "
                         "--genomes (default 1024)")
    ap.add_argument("--genome-length", type=int, default=2_000_000)
    args = ap.parse_args(argv)
    family = 4
    if args.genomes % family or args.genomes < 16:
        ap.error("--genomes must be a multiple of 4, at least 16")
    if args.finch_genomes % family or args.finch_genomes < args.genomes:
        ap.error("--finch-genomes must be a multiple of 4, at least "
                 "--genomes")

    # -- phase 1: device --------------------------------------------------
    try:
        import torch

        from galah_tpu_torch import cli
        from galah_tpu_torch.kernels import LAUNCHES, KERNELS, reset_launches
    except ImportError as e:
        print(f"chip_smoke: the galah_tpu_torch package is missing "
              f"({e}); run from the repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} {tag}")
    t_script = time.perf_counter()

    # -- phase 2: build ---------------------------------------------------
    from galah_tpu_torch.kernels import build

    build_s = build.build(KERNELS)
    print(f"build: {build_s:.2f} s for {len(KERNELS)} kernels (nvcc, "
          f"sm_90a) {tag}")
    from galah_tpu_torch.io import _cingest

    t0 = time.perf_counter()
    _cingest.load()
    print(f"build: {time.perf_counter() - t0:.2f} s for the C FASTA "
          f"parser (gcc) {tag}")

    # -- phase 3: kernel parity ------------------------------------------
    from galah_tpu_torch.io.fasta import (read_genome, read_genome_plain,
                                          read_genome_stats,
                                          read_genome_stats_plain)
    from galah_tpu_torch.io.group import host_layout, load_group
    from galah_tpu_torch.ops import sketch_stream
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED
    from galah_tpu_torch.ops.fused_sketch import (fused_candidates_plain,
                                                  fused_sketch_candidates)
    from galah_tpu_torch.ops.hashing import positional_hashes
    from galah_tpu_torch.ops.hll import COL_TILE as hll_col_tile
    from galah_tpu_torch.ops.hll import ROW_TILE as hll_row_tile
    from galah_tpu_torch.ops.hll import (fold_group, hll_sketch_genomes,
                                         hll_threshold_pairs)
    from galah_tpu_torch.ops.hll_union import (hll_union_stats,
                                               hll_union_stats_plain)
    from galah_tpu_torch.ops.hll_union import plan_launch as hll_union_plan
    from galah_tpu_torch.ops.hll_union import prepare_launch as hll_prepare
    from galah_tpu_torch.ops.hll_union import run_launch as hll_run
    from galah_tpu_torch.ops.minhash import (sketch_genome_device,
                                             sketch_matrix)
    from galah_tpu_torch.ops.murmur3_k21 import (murmur3_k21,
                                                 murmur3_k21_plain)
    from galah_tpu_torch.ops.positional_hashes import (
        positional_hashes as k15_hashes)
    from galah_tpu_torch.ops.positional_hashes import (
        positional_hashes_plain as k15_plain)
    from galah_tpu_torch.kernels.rehearse_pairlist import dense_list
    from galah_tpu_torch.kernels.rehearse_pairlist import work as pl_work
    from galah_tpu_torch.ops.pairlist import (pair_stats_pairs,
                                              pair_stats_pairs_plain,
                                              valid_lengths)
    from galah_tpu_torch.ops.pairlist import run_launch as run_pairlist
    from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs
    from galah_tpu_torch.ops.tile_stats import run_launch as run_tile_stats
    from galah_tpu_torch.ops.tile_stats import (tile_intersect_plain,
                                                tile_stats, tile_stats_plain)
    from galah_tpu_torch.ops.window_hits import plan_launch as plan_window_hits
    from galah_tpu_torch.ops.window_hits import run_launch as run_window_hits
    from galah_tpu_torch.ops.window_hits import (window_element_hits,
                                                 window_element_hits_plain)
    from galah_tpu_torch.timing import StageClock

    rng = np.random.default_rng(args.seed)
    items = window_hits_cases(rng, torch, device)
    got = window_element_hits(items, device)
    want = window_element_hits_plain(items, device)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise PhaseError("window_hits disagrees with its plain version "
                         f"at {int((got != want).sum())} elements")
    for n, item in enumerate(items):
        if not torch.equal(window_element_hits([item], device),
                           window_element_hits_plain([item], device)):
            raise PhaseError(f"window_hits disagrees with its plain "
                             f"version on pair {n} alone")
    torch.cuda.synchronize()
    print(f"parity window_hits: {len(items)} pairs in one launch and "
          f"each alone, {got.numel()} elements, {int(want.sum())} hits "
          f"(segment-straddling runs, 1000x ratios, single item, all "
          f"sentinel, exact segment multiple), exact {tag}")
    for rows, cols, k in tile_stats_cases(rng, torch, device):
        c, t = tile_stats(rows, cols, k, intersect=True)
        if not torch.equal(c, tile_intersect_plain(rows, cols)):
            raise PhaseError(f"tile_stats intersect disagrees at K={k}")
        if not torch.equal(t, (rows != SENTINEL_BIASED).sum(
                dim=1, dtype=torch.int32)[:, None].expand_as(t)):
            raise PhaseError(f"tile_stats intersect totals disagree at "
                             f"K={k}")
        for sketch_size in (k, max(k // 3, 1)):
            c, t = tile_stats(rows, cols, sketch_size)
            pc, pt = tile_stats_plain(rows, cols, sketch_size)
            if not (torch.equal(c, pc) and torch.equal(t, pt)):
                raise PhaseError(
                    f"tile_stats disagrees at K={k} S={sketch_size}")
        torch.cuda.synchronize()
        print(f"parity tile_stats: K={k} Br={rows.shape[0]} "
              f"Bc={cols.shape[0]} intersect+full exact {tag}")
    plain_hook = plain_k21_hook(murmur3_k21_plain)
    genomes = fused_sketch_genomes(rng)
    sketch_groups = [genomes, *sketch_edge_groups(rng)]
    n_windows = 0
    for group in sketch_groups:
        codes, offsets, jobs = host_layout(group, 21)
        hc, hs = torch.from_numpy(codes), torch.from_numpy(offsets)
        loaded = load_group(group, 21, device)
        dc, ds = loaded.codes, loaded.starts
        n_windows += max(codes.shape[0] - 20, 0)
        for algo in ("murmur3", "tpufast"):
            got = fused_sketch_candidates(dc, ds, jobs, 21, algo).cpu()
            want = fused_candidates_plain(hc, hs, jobs, 21, algo)
            if not torch.equal(got, want):
                raise PhaseError(
                    f"fused_sketch ({algo}) disagrees with its plain "
                    f"version at {int((got != want).sum())} candidates "
                    f"of the group of {group[0].path}")
    for algo in ("murmur3", "tpufast"):
        fused = sketch_stream.sketch_genomes_fused(genomes, 1000, 21, algo,
                                                   device)
        for g, f in zip(genomes, fused):
            e = sketch_genome_device(g, 1000, 21, algo, "cpu")
            if not np.array_equal(f.hashes, e.hashes):
                raise PhaseError(f"fused sketch of {g.path} ({algo}) "
                                 "differs from the exact sketch")
    torch.cuda.synchronize()
    print(f"parity fused_sketch: murmur3 and tpufast, "
          f"{len(sketch_groups)} groups ({len(genomes)} jobs of up to 3 "
          f"Mbp; ambiguous runs across run, slice, row and halo edges; "
          f"contig starts at 0, 1, 2047 mod 2048 and the last window; "
          f"short contigs; k, k-1 and all-ambiguous genomes; ragged "
          f"jobs), {n_windows} windows, candidates and certified "
          f"sketches exact {tag}")
    # murmur3 at the other k (dist --kmer-length): the kernel's general
    # key, k / 16 blocks and a tail of k mod 16 bytes, on the edge groups
    any_windows = 0
    for kk in ANY_K:
        for group in sketch_groups[1:]:
            codes, offsets, jobs = host_layout(group, kk)
            loaded = load_group(group, kk, device)
            got = fused_sketch_candidates(loaded.codes, loaded.starts, jobs,
                                          kk, "murmur3").cpu()
            want = fused_candidates_plain(torch.from_numpy(codes),
                                          torch.from_numpy(offsets), jobs,
                                          kk, "murmur3")
            if not torch.equal(got, want):
                raise PhaseError(
                    f"fused_sketch (murmur3, k={kk}) disagrees with its "
                    f"plain version at {int((got != want).sum())} "
                    f"candidates of the group of {group[0].path}")
            any_windows += max(codes.shape[0] - kk + 1, 0)
    torch.cuda.synchronize()
    print(f"parity fused_sketch: murmur3 at k = "
          f"{', '.join(map(str, ANY_K))} on the {len(sketch_groups) - 1} "
          f"edge groups (N runs, contig starts inside runs, genomes "
          f"shorter than k), {any_windows} windows, candidates exact "
          f"{tag}")
    # K = 1000, and the widest K the kernel stages (1536) and the next
    # (read in place), and K = 1; the 20,000-pair lists take the staged
    # plan where K allows
    for k in (1000, 1, 1536, 1537):
        tmat, lists = pairlist_cases(
            rng, torch, device, k=k,
            sizes=(1, 7, 8192, 8193) if k == 1000 else (7,))
        sizes = (k, max(k // 3, 1))
        for n_list, (pi, pj) in enumerate(lists):
            for sketch_size in sizes:
                c, t = pair_stats_pairs(tmat, pi, pj, sketch_size)
                pc, pt = pair_stats_pairs_plain(tmat, pi, pj, sketch_size)
                if not (torch.equal(c, pc) and torch.equal(t, pt)):
                    raise PhaseError(f"pairlist disagrees at K={k} "
                                     f"B={pi.numel()} S={sketch_size}")
            torch.cuda.synchronize()
            order = "sorted" if n_list == len(lists) - 1 else "random"
            print(f"parity pairlist: K={k} B={pi.numel()} ({order}) "
                  f"S={sizes[0]},{sizes[1]} exact {tag}")
        del tmat, lists
    # the dense-similarity list: one planted family of 2,048 rows at ~98%
    # ANI, every pair i < j (nothing screens out), through the pass;
    # the plain version gathers both rows, so it goes 65,536 pairs a call
    dn_np, dn_pi, dn_pj = dense_list(np.random.default_rng(args.seed))
    dn_mat = torch.from_numpy(dn_np).to(device)
    dn_ti = torch.from_numpy(dn_pi).to(device)
    dn_tj = torch.from_numpy(dn_pj).to(device)
    for sketch_size in (1000, 333):
        c, t = pair_stats_for_pairs(dn_mat, dn_pi, dn_pj, sketch_size)
        c, t = torch.from_numpy(c).to(device), torch.from_numpy(t).to(device)
        for s0 in range(0, dn_pi.shape[0], 1 << 16):
            pc, pt = pair_stats_pairs_plain(dn_mat, dn_ti[s0:s0 + (1 << 16)],
                                            dn_tj[s0:s0 + (1 << 16)],
                                            sketch_size)
            if not (torch.equal(c[s0:s0 + (1 << 16)], pc)
                    and torch.equal(t[s0:s0 + (1 << 16)], pt)):
                raise PhaseError(f"pairlist disagrees on the dense list at "
                                 f"pairs [{s0}, {s0 + (1 << 16)}) "
                                 f"S={sketch_size}")
        torch.cuda.synchronize()
        print(f"parity pairlist dense: {dn_np.shape[0]} rows, "
              f"{dn_pi.shape[0]} pairs, K=1000 S={sketch_size}, "
              f"{int((c > 0).sum())} pairs sharing values, exact {tag}")
    # the pair pass's tail launch (64 x 256), a ragged register axis cut
    # into slices (m = 1040: 17 slices of 4 words, the last of 1), and
    # registers up to 255, beside the first cases
    for br, bc, m, hi in ((64, 1000, 4096, 41), (13, 77, 1024, 41),
                          (64, 1000, 4096, 53), (9, 3, 16, 53),
                          (64, 256, 4096, 41), (13, 77, 1040, 41),
                          (13, 77, 1040, 53), (64, 256, 4096, 255),
                          (13, 77, 1040, 255)):
        rr = torch.from_numpy(rng.integers(0, hi + 1, size=(br, m))
                              .astype(np.uint8)).to(device)
        cc = torch.from_numpy(rng.integers(0, hi + 1, size=(bc, m))
                              .astype(np.uint8)).to(device)
        rr[0] = 0              # all-zero rows
        cc[min(1, bc - 1)] = 0
        top = max(hi, 53)      # all-max rows (64 - p + 1 at p = 12)
        rr[-1] = top
        cc[-1] = top
        hplan = hll_union_plan(br, bc, m)
        ps, z = hll_union_stats(rr, cc)
        pps, pz = hll_union_stats_plain(rr, cc)
        torch.cuda.synchronize()
        ulps = int((ps.view(torch.int32) - pps.view(torch.int32)).abs()
                   .max())
        if not torch.equal(z, pz) or ulps > (0 if hi <= 41 else 1):
            raise PhaseError(f"hll_union disagrees with its plain version "
                             f"at Br={br} Bc={bc} m={m} registers <= {hi}:"
                             f" {ulps} ulps")
        print(f"parity hll_union: Br={br} Bc={bc} m={m} registers <= "
              f"{hi}, zero and max rows, {hplan.slices} slices of "
              f"{hplan.chunk} words: zeros exact, powsum within {ulps} "
              f"f32 ulp {tag}")
    mm_cases = 0
    for group in sketch_groups + [[_genome("random", rng.integers(
            0, 4, size=3 * 2 ** 20 + 25).astype(np.uint8))]]:
        codes, offsets, _ = host_layout(group, 21)
        hc, hs = torch.from_numpy(codes), torch.from_numpy(offsets)
        loaded = load_group(group, 21, device)
        dc, ds = loaded.codes, loaded.starts
        n_win = max(codes.shape[0] - 20, 0)
        ranges = [(0, n_win), (min(1, n_win), max(n_win - 1, 0)),
                  (min(4095, n_win), max(min(8193, n_win - 4095), 0))]
        for w0, n in ranges:
            got = murmur3_k21(dc, ds, w0, n).cpu()
            if not torch.equal(got, murmur3_k21_plain(hc, hs, w0, n)):
                raise PhaseError(f"murmur3_k21 disagrees with its plain "
                                 f"version at windows [{w0}, {w0 + n}) of "
                                 f"the group of {group[0].path}")
            mm_cases += 1
    long_g = genomes[-1]
    got = positional_hashes(long_g, 21, device, chunk=1 << 20).cpu()
    if not torch.equal(got, positional_hashes(long_g, 21, "cpu")):
        raise PhaseError("murmur3_k21 in 1 Mi-window chunks of a 3 Mbp "
                         "genome disagrees with the plain version")
    torch.cuda.synchronize()
    print(f"parity murmur3_k21: {mm_cases} window ranges of the fused "
          f"groups and a random 3 Mi-window sequence, and a 3 Mbp genome "
          f"in 1 Mi-window chunks, exact {tag}")
    # positional_hashes: the sketch groups, the k=15 edge group and the
    # 3 Mbp genome alone, both hashes, whole and over window ranges (the
    # range that starts at window 1 only on the small groups)
    ph_cases = ph_windows = 0
    for group in [*sketch_groups, k15_edge_group(rng), [genomes[-1]]]:
        codes, offsets, _ = host_layout(group, 15)
        hc, hs = torch.from_numpy(codes), torch.from_numpy(offsets)
        loaded = load_group(group, 15, device)
        n_win = max(codes.shape[0] - 14, 0)
        ph_windows += n_win
        ranges = [(0, n_win),
                  (min(4095, n_win), max(min(8193, n_win - 4095), 0))]
        if n_win < 100_000:
            ranges.append((min(1, n_win), max(n_win - 1, 0)))
        for algo in ("murmur3", "tpufast"):
            for w0, n in ranges:
                got = k15_hashes(loaded.codes, loaded.starts, w0, n,
                                 algo).cpu()
                if not torch.equal(got, k15_plain(hc, hs, w0, n, algo)):
                    raise PhaseError(
                        f"positional_hashes ({algo}) disagrees with its "
                        f"plain version at windows [{w0}, {w0 + n}) of "
                        f"the group of {group[0].path}")
                ph_cases += 1
    got = positional_hashes(genomes[-1], 15, device, chunk=1 << 20).cpu()
    if not torch.equal(got, positional_hashes(genomes[-1], 15, "cpu")):
        raise PhaseError("positional_hashes in 1 Mi-window chunks of a "
                         "3 Mbp genome disagrees with the plain version")
    torch.cuda.synchronize()
    print(f"parity positional_hashes: murmur3 and tpufast, {ph_cases} "
          f"window ranges of {len(sketch_groups) + 2} groups ({ph_windows} "
          f"windows; the sketch groups, a k=15 edge group, a 3 Mbp "
          f"genome) and the 3 Mbp genome in 1 Mi-window chunks, exact "
          f"{tag}")
    # the per-kernel record near the end is the one {"kernels": ...}
    # object the output holds; this line only lists what passed parity
    print(f"parity kernels: {json.dumps(list(KERNELS))} {tag}")

    with tempfile.TemporaryDirectory(prefix="galah_smoke_") as root:
        # -- corpus: the skani corpus is the finch corpus's first part ----
        t0 = time.perf_counter()
        all_dir = os.path.join(root, "all")
        skani_dir = os.path.join(root, "skani")
        os.makedirs(all_dir)
        os.makedirs(skani_dir)
        paths, labels, gstats = make_corpus(
            all_dir, args.finch_genomes, args.genome_length, family,
            args.seed)
        for p in paths[:args.genomes]:
            os.symlink(p, os.path.join(skani_dir, os.path.basename(p)))
        label_of = dict(zip(paths, labels))
        label_of.update((os.path.join(skani_dir, os.path.basename(p)), f)
                        for p, f in zip(paths, labels))
        gbp = args.finch_genomes * args.genome_length / 1e9
        print(f"corpus: {args.finch_genomes} genomes x "
              f"{args.genome_length} bp ({gbp:.3f} Gbp), "
              f"{args.finch_genomes // family} families, written in "
              f"{time.perf_counter() - t0:.1f} s {tag}")
        if (args.genomes, args.finch_genomes, args.genome_length) != \
                (512, FINCH_MIN_GENOMES, 2_000_000):
            print(f"corpus cut: {args.genomes} skani and "
                  f"{args.finch_genomes} finch genomes of "
                  f"{args.genome_length} bp instead of 512 and "
                  f"{FINCH_MIN_GENOMES} of 2000000 {tag}")

        # -- phase 3, continued: the C FASTA parser against numpy ---------
        parser = check_parser(paths[:64], root, read_genome,
                              read_genome_plain, read_genome_stats,
                              read_genome_stats_plain)
        print(f"parity fasta parser: {parser['files']} corpus files and 1 "
              f"gzip file, codes, offsets and stats identical; a genome "
              f"{parser['c_ms']:.2f} ms in C, {parser['plain_ms']:.2f} ms "
              f"in numpy (median, host clock) {tag}")
        # phase 4's first profile group: positional_hashes and the
        # group's profiles on the card against the CPU plain build
        from galah_tpu_torch.ops.fragment_ani import (PROFILE_BATCH_BUDGET,
                                                      build_profiles_batch)

        pgroup = first_group(paths[:args.genomes], read_genome,
                             PROFILE_BATCH_BUDGET)
        codes, offsets, _ = host_layout(pgroup, 15)
        hc, hs = torch.from_numpy(codes), torch.from_numpy(offsets)
        loaded = load_group(pgroup, 15, device)
        for algo in ("murmur3", "tpufast"):
            got = k15_hashes(loaded.codes, loaded.starts, algo=algo).cpu()
            if not torch.equal(got, k15_plain(hc, hs, algo=algo)):
                raise PhaseError(f"positional_hashes ({algo}) disagrees "
                                 f"with its plain version at phase 4's "
                                 f"first profile group")
            on_card = build_profiles_batch(pgroup, 15, 3000, device,
                                           hash_algorithm=algo)
            on_cpu = build_profiles_batch(pgroup, 15, 3000, "cpu",
                                          hash_algorithm=algo)
            for a, b in zip(on_card, on_cpu):
                for name in ("flat_hashes", "ref_set", "markers"):
                    if not torch.equal(getattr(a, name).cpu(),
                                       getattr(b, name)):
                        raise PhaseError(
                            f"the {name} of {a.path} ({algo}) differs "
                            f"between the card's group build and the CPU "
                            f"plain build")
        torch.cuda.synchronize()
        print(f"parity positional_hashes: phase 4's first profile group, "
              f"{len(pgroup)} genomes, {hc.numel() - 14} windows, murmur3 "
              f"and tpufast, exact; its profiles (flat hashes, distinct "
              f"sets, markers) from the card's group build equal the CPU "
              f"plain build {tag}")
        del pgroup, hc, hs, loaded, got, on_card, on_cpu

        # -- phase 4: end to end, skani ----------------------------------
        print(f"phase 4 starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        out_tsv = os.path.join(root, "clusters.tsv")
        threads = ["--threads", str(THREADS)]
        res, wall, launches = run_path(
            torch, cli, reset_launches, LAUNCHES,
            ["cluster", "-d", skani_dir, "--ani", "95", "--device", "cuda",
             *threads, "--output-cluster-definition", out_tsv])
        n_fam = check_families(res, label_of, args.genomes, family,
                               out_tsv, "skani")
        print(f"end to end: {len(res.clusters)} clusters == {n_fam} "
              f"planted families, wall {wall:.2f} s {tag}")
        for stage in ("read", "profile", "screen", "exact-ani", "greedy"):
            print(f"stage {stage}: {res.clock.seconds.get(stage, 0.0):.3f} "
                  f"s {tag}")
        print(f"read work (summed over threads): "
              f"{res.clock.work_seconds['read']:.3f} s {tag}")
        for name, n in sorted(res.clock.counts.items()):
            print(f"count {name}: {n} {tag}")
        for name in KERNELS:
            print(f"launches {name}: {launches[name]} {tag}")
        require_launched(launches, ("window_hits", "tile_stats",
                                    "positional_hashes"), "skani")
        with open(out_tsv, "rb") as fh:
            tsv4 = fh.read()

        # -- phase 4b: end to end, finch at scale -------------------------
        finch = ["--precluster-method", "finch", "--cluster-method",
                 "skani", "--ani", "95", "--device", "cuda", *threads,
                 "--output-cluster-definition", out_tsv]
        res_f, wall_f, launches_f = run_path(
            torch, cli, reset_launches, LAUNCHES,
            ["cluster", "-f", *paths, *finch])
        n_fam = check_families(res_f, label_of, args.finch_genomes,
                               family, out_tsv, "finch")
        print(f"finch end to end: {args.finch_genomes} genomes, "
              f"{len(res_f.clusters)} clusters == {n_fam} planted "
              f"families, wall {wall_f:.2f} s {tag}")
        for stage in ("read", "sketch", "collision-screen", "pair-stats",
                      "profile", "exact-ani", "greedy"):
            print(f"finch stage {stage}: "
                  f"{res_f.clock.seconds.get(stage, 0.0):.3f} s {tag}")
        print(f"finch read work (summed over threads): "
              f"{res_f.clock.work_seconds['read']:.3f} s {tag}")
        for name, n in sorted(res_f.clock.counts.items()):
            print(f"finch count {name}: {n} {tag}")
        for name in KERNELS:
            print(f"finch launches {name}: {launches_f[name]} {tag}")
        print(f"finch device state: sketch matrix "
              f"{args.finch_genomes} x 1000 x 8 B = "
              f"{args.finch_genomes * 8000 / 1e6:.1f} MB; codes 1 B a "
              f"base, {sketch_stream.FUSED_BUDGET / 1e6:.0f} MB per launch "
              f"group at most {tag}")
        need = ["fused_sketch", "window_hits", "positional_hashes"]
        if args.finch_genomes >= FINCH_MIN_GENOMES:
            need.append("pairlist")
        else:
            print(f"finch cut: {args.finch_genomes} genomes stay below "
                  f"the {FINCH_MIN_GENOMES}-genome crossover, so the "
                  f"pairlist kernel is not on this path {tag}")
        require_launched(launches_f, need, "finch")
        with open(out_tsv, "rb") as fh:
            tsv4b = fh.read()

        # -- phase 4c: end to end, finch dense ----------------------------
        n_dense = min(256, args.finch_genomes)
        res_d, wall_d, launches_d = run_path(
            torch, cli, reset_launches, LAUNCHES,
            ["cluster", "-f", *paths[:n_dense], *finch])
        n_fam = check_families(res_d, label_of, n_dense, family, out_tsv,
                               "finch dense")
        print(f"finch dense end to end: {n_dense} genomes, "
              f"{len(res_d.clusters)} clusters == {n_fam} planted "
              f"families, wall {wall_d:.2f} s {tag}")
        for stage in ("read", "sketch", "pair-stats", "profile",
                      "exact-ani", "greedy"):
            print(f"finch dense stage {stage}: "
                  f"{res_d.clock.seconds.get(stage, 0.0):.3f} s {tag}")
        print(f"finch dense read work (summed over threads): "
              f"{res_d.clock.work_seconds['read']:.3f} s {tag}")
        for name, n in sorted(res_d.clock.counts.items()):
            print(f"finch dense count {name}: {n} {tag}")
        for name in KERNELS:
            print(f"finch dense launches {name}: {launches_d[name]} {tag}")
        require_launched(launches_d, ("fused_sketch", "tile_stats",
                                      "positional_hashes"), "finch dense")
        require_counts(res_d.clock.counts, {
            "pairs-streamed-stripes": -(-n_dense // sketch_stream.ROW_BLOCK)},
            "finch dense")

        # -- phase 4d: end to end, dashing with quality ranking ------------
        report = os.path.join(root, "quality_report.tsv")
        quality = write_quality_report(report, paths, labels, args.seed)
        res_h, wall_h, launches_h = run_path(
            torch, cli, reset_launches, LAUNCHES,
            ["cluster", "-f", *paths, "--precluster-method", "dashing",
             "--cluster-method", "skani", "--ani", "95",
             "--checkm2-quality-report", report, "--device", "cuda",
             *threads, "--output-cluster-definition", out_tsv])
        n_fam = check_families(res_h, label_of, args.finch_genomes,
                               family, out_tsv, "dashing")
        order = {p: i for i, p in enumerate(paths)}
        for c in res_h.clusters:
            members = [res_h.genomes[i] for i in c]
            best = parks2020_best(members, quality, gstats, order)
            if members[0] != best:
                raise PhaseError(
                    f"dashing: cluster of {best} is represented by "
                    f"{members[0]}, not its Parks2020_reduced best")
        print(f"dashing end to end: {args.finch_genomes} genomes, "
              f"{len(res_h.clusters)} clusters == {n_fam} planted "
              f"families, each represented by its Parks2020_reduced "
              f"best member, wall {wall_h:.2f} s {tag}")
        for stage in ("quality", "read", "sketch", "pair-stats",
                      "profile", "exact-ani", "greedy"):
            print(f"dashing stage {stage}: "
                  f"{res_h.clock.seconds.get(stage, 0.0):.3f} s {tag}")
        print(f"dashing read work (summed over threads): "
              f"{res_h.clock.work_seconds['read']:.3f} s {tag}")
        for name, n in sorted(res_h.clock.counts.items()):
            print(f"dashing count {name}: {n} {tag}")
        within = (family * (family - 1) // 2) * n_fam
        print(f"dashing precluster pairs: "
              f"{res_h.clock.counts['precluster-pairs']} ({within} within "
              f"families) {tag}")
        for name in KERNELS:
            print(f"dashing launches {name}: {launches_h[name]} {tag}")
        print(f"dashing device state: register matrix "
              f"{args.finch_genomes} x 4096 x 1 B = "
              f"{args.finch_genomes * 4096 / 1e6:.1f} MB; codes and "
              f"hashes 9 B a window, "
              f"{9 * sketch_stream.FUSED_BUDGET / 1e6:.0f} MB per launch "
              f"group at most {tag}")
        require_launched(launches_h, ("hll_union", "murmur3_k21",
                                      "window_hits", "positional_hashes"),
                         "dashing")
        with open(out_tsv, "rb") as fh:
            tsv4d = fh.read()

        # -- phase 4e: end to end, finch streamed -------------------------
        n_e = min(STREAM_GENOMES, args.finch_genomes)
        stripes = -(-n_e // sketch_stream.ROW_BLOCK)
        tsv_e = os.path.join(root, "clusters_streamed.tsv")
        tsv_t = os.path.join(root, "clusters_twin.tsv")
        finch_e = ["cluster", "-f", *paths[:n_e], "--precluster-method",
                   "finch", "--cluster-method", "skani", "--ani", "95",
                   "--device", "cuda"]
        res_e, wall_e, launches_e = run_path(
            torch, cli, reset_launches, LAUNCHES,
            [*finch_e, *threads, "--output-cluster-definition", tsv_e])
        n_fam = check_families(res_e, label_of, n_e, family, tsv_e,
                               "finch streamed")
        require_counts(res_e.clock.counts, {"pairs-streamed-stripes": stripes},
                       "finch streamed")
        require_launched(launches_e, ("fused_sketch", "tile_stats",
                                      "window_hits", "positional_hashes"),
                         "finch streamed")
        res_t, wall_t, launches_t = run_path(
            torch, cli, reset_launches, LAUNCHES,
            [*finch_e, "--threads", str(TWIN_THREADS),
             "--output-cluster-definition", tsv_t])
        with open(tsv_e, "rb") as fa, open(tsv_t, "rb") as fb:
            if fa.read() != fb.read():
                raise PhaseError(f"finch streamed: the TSV differs from "
                                 f"the --threads {TWIN_THREADS} run's")
        print(f"finch streamed end to end: {n_e} genomes, "
              f"{len(res_e.clusters)} clusters == {n_fam} planted "
              f"families, {stripes} stripes, TSV byte-identical to "
              f"--threads {TWIN_THREADS}; wall {wall_e:.2f} s at "
              f"--threads {THREADS}, {wall_t:.2f} s at --threads "
              f"{TWIN_THREADS} {tag}")
        print_run(f"finch streamed t{THREADS}", res_e, launches_e, KERNELS,
                  tag)
        print_run(f"finch streamed t{TWIN_THREADS}", res_t, launches_t,
                  KERNELS, tag)
        require_launched(launches_t, ("positional_hashes",),
                         f"finch streamed --threads {TWIN_THREADS}")

        # -- phase 4f: end to end, the fastani clusterer ------------------
        tsv_a = os.path.join(root, "clusters_fastani.tsv")
        res_a, wall_a, launches_a = run_path(
            torch, cli, reset_launches, LAUNCHES,
            ["cluster", "-d", skani_dir, "--cluster-method", "fastani",
             "--ani", "95", "--device", "cuda", *threads,
             "--output-cluster-definition", tsv_a])
        n_fam = check_families(res_a, label_of, args.genomes, family, tsv_a,
                               "fastani")
        require_launched(launches_a, ("window_hits", "positional_hashes"),
                         "fastani")
        print(f"fastani end to end: {args.genomes} genomes, "
              f"{len(res_a.clusters)} clusters == {n_fam} planted "
              f"families, wall {wall_a:.2f} s {tag}")
        print_run("fastani", res_a, launches_a, KERNELS, tag)

        # -- phases 4g-4i: galah's command line, dist, the cache -----------
        # each run's profile store holds up to 128 profiles (~60 MB a
        # genome with its sorted queries); the later phases read only
        # phase 4's, so the others are let go before more runs start
        for r in (res_f, res_d, res_h, res_e, res_t, res_a):
            r.store = None
        res_a.preclusterer = None  # the skani precluster shares its store
        gc.collect()
        torch.cuda.empty_cache()
        print(f"device memory before phase 4g: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"{tag}")
        # -- phase 4m: the library API as CoverM embeds it ---------------
        print(f"phase 4m starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        api_out = phases_api(torch, reset_launches, LAUNCHES, KERNELS,
                             {"skani": (res.genomes, res, wall),
                              "finch": (paths, res_f, wall_f),
                              "dashing": (paths, res_h, wall_h)},
                             report, tag)

        # -- phase 4n: --ani-subsample -------------------------------------
        tsv4_path = os.path.join(root, "clusters4.tsv")
        with open(tsv4_path, "wb") as fh:
            fh.write(tsv4)
        sub_out = phases_subsample(torch, cli, reset_launches, LAUNCHES,
                                   KERNELS, root, skani_dir, res, launches,
                                   tsv4_path, label_of, threads, family,
                                   tag)
        gc.collect()
        torch.cuda.empty_cache()

        print(f"phase 4g starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        cli_out = phases_cli(torch, cli, reset_launches, LAUNCHES, KERNELS,
                             root, res.genomes, tsv4, paths, label_of,
                             n_dense, report, threads, family, device, tag)

        # -- phases 4j-4k: checkpoint and resume, quarantine ---------------
        print(f"phase 4j starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        resil_out = phases_resilience(
            torch, cli, reset_launches, LAUNCHES, KERNELS, root, paths,
            res.genomes, skani_dir, tsv4, tsv4b, threads, tag)

        # -- phase 4l: the persistent sketch index -------------------------
        print(f"phase 4l starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        index_out = phases_index(torch, cli, reset_launches, LAUNCHES,
                                 KERNELS, root, paths, label_of, report,
                                 threads, family, args.seed,
                                 args.genome_length, tag)
        index_out["pass"] = index_pair_pass(torch, device, args.seed, tag)
        gc.collect()
        torch.cuda.empty_cache()

        # -- phase 4o: observability on the card ---------------------------
        print(f"phase 4o starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        obs_out = phase_obs(root, {
            "skani": (["cluster", "-d", skani_dir, "--ani", "95",
                       "--device", "cuda", "--precluster-method", "skani"],
                      tsv4, launches, res.clock, wall),
            "finch": (["cluster", "-f", *paths, "--precluster-method",
                       "finch", "--cluster-method", "skani", "--ani", "95",
                       "--device", "cuda"],
                      tsv4b, launches_f, res_f.clock, wall_f),
            "dashing": (["cluster", "-f", *paths, "--precluster-method",
                         "dashing", "--cluster-method", "skani", "--ani",
                         "95", "--checkm2-quality-report", report,
                         "--device", "cuda"],
                        tsv4d, launches_h, res_h.clock, wall_h)},
            threads, tag)

        # -- phase 5: timing at the main paths' shapes ---------------------
        print(f"phase 5 starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        from galah_tpu_torch.ops import fragment_ani

        # the run's profiles (the store's LRU may have evicted some; they
        # are rebuilt identically) and its screened pairs
        store = res.store
        with store.reserve(len(res.genomes)):
            profiles = store.get_many(res.genomes)
        from galah_tpu_torch.backends import SkaniPreclusterer
        from galah_tpu_torch.ops.pairwise import screen_pairs

        pre = SkaniPreclusterer(0.95, 0.15, store)
        mat, counts = pre.marker_matrix(profiles)
        screened = screen_pairs(mat, counts, pre.SCREEN_IDENTITY ** store.k)
        # the screen's first row block is its largest tile_stats launch
        rows = mat[:64].contiguous()
        k = mat.shape[1]
        ts_ms = time_ms(torch, lambda: tile_stats(rows, mat, k,
                                                  intersect=True), 20)
        ts_out = (torch.empty(64, mat.shape[0], dtype=torch.int32,
                              device=device),
                  torch.empty(64, mat.shape[0], dtype=torch.int32,
                              device=device))
        ts_kernel = time_ms(torch, lambda: run_tile_stats(
            rows, mat, k, True, *ts_out), 20)
        ts_plain = time_ms(torch, lambda: tile_intersect_plain(rows, mat), 3)
        c_k, _ = tile_stats(rows, mat, k, intersect=True)
        ts_err = float((c_k - tile_intersect_plain(rows, mat)).abs().max())
        na = counts[:64].astype(np.float64)
        nb = counts.astype(np.float64)
        ts_bytes = (rows.numel() + mat.numel()) * 8 + 2 * 4 * 64 * len(counts)
        # each pair walks both valid prefixes once; an int64 compare is
        # two 32-bit operations
        ts_ops = 2 * float((na[:, None] + nb[None, :]).sum())
        ts_bound, ts_by = bound(ts_bytes, ts_ops)

        # window_hits: the first launch of the exact-ANI stage, packed
        # as bidirectional_ani_values packs the screened pairs
        directed = ([(profiles[i], profiles[j]) for i, j in screened]
                    + [(profiles[j], profiles[i]) for i, j in screened])
        chunk = next(fragment_ani.iter_launches(directed))
        wh_items = [(directed[i][0].sorted_query()[0], directed[i][1].ref_set)
                    for i in chunk]
        wh_ms = time_ms(
            torch, lambda: window_element_hits(wh_items, device), 5)
        planned = plan_window_hits(wh_items, device)
        wh_kernel = time_ms(torch, lambda: run_window_hits(planned), 5)
        del planned
        # the library yardstick: one torch.isin call a pair, summed
        wh_lib = time_ms(torch, lambda: [torch.isin(q, r)
                                         for q, r in wh_items], 2)
        if not torch.equal(window_element_hits(wh_items, device).bool(),
                           torch.cat([torch.isin(q, r) & (q != SENTINEL_BIASED)
                                      for q, r in wh_items])):
            raise PhaseError("window_hits disagrees with torch.isin at "
                             "the exact-ANI stage's shapes")
        wh_plain = time_ms(
            torch, lambda: window_element_hits_plain(wh_items, device), 2)
        wh_err = float(
            (window_element_hits(wh_items, device).to(torch.int64)
             - window_element_hits_plain(wh_items, device)).abs().max())
        uq = {q.data_ptr(): q.numel() for q, _ in wh_items}
        ur = {r.data_ptr(): r.numel() for _, r in wh_items}
        n_elem = sum(q.numel() for q, _ in wh_items)
        wh_bytes = 8 * (sum(uq.values()) + sum(ur.values())) + 4 * n_elem
        wh_ops = 2 * sum(q.numel() * math.ceil(math.log2(r.numel() + 1))
                         for q, r in wh_items)
        wh_bound, wh_by = bound(wh_bytes, wh_ops)
        n_ref = sum(r.numel() for _, r in wh_items)
        wh_pair_bound = (8 * (n_elem + n_ref) + 4 * n_elem) \
            / PEAK_BYTES_PER_S * 1e3
        print(f"timing window_hits: {len(wh_items)} directed pairs, "
              f"{n_elem} elements against {n_ref} reference values: "
              f"whole call {wh_ms:.3f} ms, kernel only {wh_kernel:.3f} ms,"
              f" plain {wh_plain:.3f} ms, torch.isin a pair summed "
              f"{wh_lib:.3f} ms, bound {wh_bound:.3f} ms ({wh_by}; each "
              f"pair's q and r read once: {wh_pair_bound:.3f} ms) {tag}")
        print(f"timing tile_stats: {rows.shape[0]}x{mat.shape[0]} pairs, "
              f"K={k}: whole call {ts_ms:.4f} ms, kernel only "
              f"{ts_kernel:.4f} ms, plain {ts_plain:.3f} ms, bound "
              f"{ts_bound:.4f} ms ({ts_by}) {tag}")
        # the sorted queries of phase 4's profiles (a torch.nonzero sync
        # each), built anew, beside phase 4's exact-ANI stage
        fresh = [dataclasses.replace(p, _sorted_query=None,
                                     _totals_host=None) for p in profiles]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in fresh:
            p.sorted_query()
            p.totals_host()
        torch.cuda.synchronize()
        sq_s = time.perf_counter() - t0
        print(f"timing sorted_query: {len(fresh)} profiles of phase 4, "
              f"{sq_s:.3f} s ({1e3 * sq_s / len(fresh):.3f} ms a genome, "
              f"host clock); phase 4's exact-ani stage "
              f"{res.clock.seconds['exact-ani']:.3f} s {tag}")
        del profiles, fresh, mat, directed, wh_items, rows, c_k, ts_out

        # positional_hashes: phase 4's first profile group (8 x 2 Mbp),
        # the kernel alone and the whole group build split into its
        # parts; the distinct sets also by a two-key sort over the group
        ph_group = first_group(res.genomes, read_genome,
                               fragment_ani.PROFILE_BATCH_BUDGET)
        ph = time_group(torch, device, ph_group, 15)
        hc, hs, dc, ds, ph_jobs = ph["tensors"]
        ph_ms = time_ms(torch, lambda: k15_hashes(dc, ds), 10)
        ph_fast = time_ms(torch, lambda: k15_hashes(dc, ds,
                                                    algo="tpufast"), 10)
        hashes = k15_hashes(dc, ds)
        t0 = time.perf_counter()
        want = k15_plain(hc, hs)
        ph_plain = (time.perf_counter() - t0) * 1e3
        if not torch.equal(hashes.cpu(), want):
            raise PhaseError("positional_hashes disagrees with its plain "
                             "version at phase 4's profile group")
        ph_err = 0.0
        n_win = hashes.numel()
        n_valid = int((hashes != SENTINEL_BIASED).sum())
        ph_bytes = hc.numel() + 8 * hs.numel() + 8 * n_win
        ph_bound, ph_by = bound(ph_bytes, n_valid * K15_OPS_PER_WINDOW[
            "murmur3"])
        ph_fast_bound, ph_fast_by = bound(
            ph_bytes, n_valid * K15_OPS_PER_WINDOW["tpufast"])
        flats = [hashes[w0:w0 + n].clone() for w0, n in ph_jobs]
        per_genome = fragment_ani._distinct_sets(flats)
        two_key = two_key_distinct(torch, hashes, ph_jobs,
                                   fragment_ani.MARKER_CUT_BIASED,
                                   SENTINEL_BIASED)
        for (ra, ma), (rb, mb) in zip(per_genome, two_key):
            if not (torch.equal(ra, rb) and torch.equal(ma, mb)):
                raise PhaseError("the two distinct-set routes disagree at "
                                 "phase 4's profile group")
        distinct_ms = host_ms(torch, lambda: fragment_ani._distinct_sets(
            flats), 5)
        two_key_ms = host_ms(torch, lambda: two_key_distinct(
            torch, hashes, ph_jobs, fragment_ani.MARKER_CUT_BIASED,
            SENTINEL_BIASED), 5)
        clone_ms = time_ms(torch, lambda: [hashes[w0:w0 + n].clone()
                                           for w0, n in ph_jobs], 5)
        build_ms = host_ms(torch, lambda: (fragment_ani.build_profiles_batch(
            ph_group, 15, 3000, device), torch.cuda.synchronize()), 5)
        ph_split = {"group load (pinned write and copy)": ph["load_ms"],
                    "kernel": ph_ms, "per-genome clones": clone_ms,
                    "distinct sets (per-genome sorts)": distinct_ms}
        p_stage = 1e3 * res.clock.seconds.get("profile", 0.0) / max(
            res.clock.counts.get("profile-groups", 0), 1)
        print(f"timing positional_hashes: {len(ph_group)} genomes, {n_win} "
              f"windows ({n_valid} valid) from {hc.numel()} codes, murmur3: "
              f"kernel {ph_ms:.4f} ms, plain (CPU tensors, host clock) "
              f"{ph_plain:.1f} ms, bound {ph_bound:.4f} ms ({ph_by}); "
              f"tpufast: kernel {ph_fast:.4f} ms, bound {ph_fast_bound:.4f} "
              f"ms ({ph_fast_by}) {tag}")
        print(f"timing profile group build: whole {build_ms:.2f} ms (host "
              f"clock, median of 5) = "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ph_split.items())
              + f" + the rest; host layout alone {ph['layout_ms']:.3f} ms; "
              f"distinct sets by one two-key sort over the group "
              f"{two_key_ms:.3f} ms; skani 512 profile stage per group "
              f"{p_stage:.2f} ms {tag}")
        del hashes, want, flats, per_genome, two_key, ph, hc, hs, dc, ds

        # the intersect form at the screen's widths for corpora whose
        # largest genome is about 6 and 10 Mbp (synthetic rows, 64 x 512
        # pairs), past the staged tile, where the kernel reads in place
        from galah_tpu_torch.kernels.rehearse_tile_stats import stripe

        ts_wide = []
        for wk in (6080, 10048):
            wr, wc = (torch.from_numpy(m).to(device) for m in
                      stripe(wk, np.random.default_rng(args.seed)))
            w_ms = time_ms(torch, lambda: tile_stats(
                wr, wc, wk, intersect=True), 10)
            w_plain = time_ms(torch, lambda: tile_intersect_plain(wr, wc), 2)
            if not torch.equal(tile_stats(wr, wc, wk, intersect=True)[0],
                               tile_intersect_plain(wr, wc)):
                raise PhaseError(f"tile_stats intersect disagrees at "
                                 f"K={wk} (64 x 512 pairs)")
            wn = (wc != SENTINEL_BIASED).sum(dim=1).cpu().numpy().astype(
                np.float64)
            w_bound, w_by = bound(
                (wr.numel() + wc.numel()) * 8 + 2 * 4 * 64 * wc.shape[0],
                2 * float((wn[:64, None] + wn[None, :]).sum()))
            ts_wide.append({"k": wk, "ms": w_ms, "plain_ms": w_plain,
                            "bound_ms": w_bound, "bound_by": w_by})
            print(f"timing tile_stats at K={wk}: 64x{wc.shape[0]} "
                  f"synthetic pairs, valid counts 0.97-1 K: whole call "
                  f"{w_ms:.4f} ms, plain {w_plain:.3f} ms, bound "
                  f"{w_bound:.4f} ms ({w_by}) {tag}")
            del wr, wc

        # tile_stats' full form: each stripe of phase 4e's streamed pass
        # (every row seen so far, padded to a power of two, against a
        # block of 256 columns); the last, all rows seen, is the headline
        e_store = res_e.preclusterer.store
        emat = sketch_matrix([e_store.get_cached(p) for p in res_e.genomes],
                             1000, device)
        tf_stripes = []
        for st_rows, (c0, c1) in stripe_shapes(n_e,
                                               sketch_stream.ROW_BLOCK):
            done = torch.full((st_rows, 1000), SENTINEL_BIASED,
                              dtype=torch.int64, device=device)
            done[:c1] = emat[:c1]
            cols = torch.full((sketch_stream.ROW_BLOCK, 1000),
                              SENTINEL_BIASED, dtype=torch.int64,
                              device=device)
            cols[:c1 - c0] = emat[c0:c1]
            st_out = (torch.empty(st_rows, cols.shape[0], dtype=torch.int32,
                                  device=device),
                      torch.empty(st_rows, cols.shape[0], dtype=torch.int32,
                                  device=device))
            st_ms = time_ms(torch, lambda: tile_stats(done, cols, 1000), 20)
            st_kernel = time_ms(torch, lambda: run_tile_stats(
                done, cols, 1000, False, *st_out), 20)
            st_plain = time_ms(torch, lambda: tile_stats_plain(done, cols,
                                                               1000), 2)
            if not all(torch.equal(x, y) for x, y in zip(
                    tile_stats(done, cols, 1000),
                    tile_stats_plain(done, cols, 1000))):
                raise PhaseError(f"tile_stats full form disagrees with its "
                                 f"plain version at the {st_rows} x "
                                 f"{cols.shape[0]} stripe")
            rn = (done != SENTINEL_BIASED).sum(dim=1).cpu().numpy() \
                .astype(np.float64)
            cn = (cols != SENTINEL_BIASED).sum(dim=1).cpu().numpy() \
                .astype(np.float64)
            # two walks of both valid prefixes per pair
            st_bound, st_by = bound(
                (done.numel() + cols.numel()) * 8
                + 2 * 4 * st_rows * cols.shape[0],
                4 * float((rn[:, None] + cn[None, :]).sum()))
            tf_stripes.append({
                "rows": st_rows, "cols": cols.shape[0], "rows_seen": c1,
                "valid_cols": c1 - c0, "ms": st_ms,
                "kernel_only_ms": st_kernel, "plain_ms": st_plain,
                "bound_ms": st_bound, "bound_by": st_by})
            print(f"timing tile_stats full form: {st_rows}x{cols.shape[0]}"
                  f" stripe ({c1} rows seen, {c1 - c0} columns), K=1000 "
                  f"(phase 4e): whole call {st_ms:.4f} ms, kernel only "
                  f"{st_kernel:.4f} ms, plain {st_plain:.3f} ms, bound "
                  f"{st_bound:.4f} ms ({st_by}) {tag}")
            del done, cols, st_out
        del emat
        tf = tf_stripes[-1]
        tf_ms, tf_kernel = tf["ms"], tf["kernel_only_ms"]
        tf_plain, tf_bound, tf_by = tf["plain_ms"], tf["bound_ms"], \
            tf["bound_by"]

        # fused_sketch: the finch run's first launch group, its largest,
        # and the group's whole sketch split into its parts
        group = first_group(res_f.genomes, read_genome,
                            sketch_stream.FUSED_BUDGET)
        fs = time_group(torch, device, group)
        hc, hs, dc, ds, jobs = fs["tensors"]
        fs_ms = time_ms(torch, lambda: fused_sketch_candidates(
            dc, ds, jobs, 21, "murmur3"), 10)
        cand = fused_sketch_candidates(dc, ds, jobs, 21, "murmur3")
        t0 = time.perf_counter()
        want = fused_candidates_plain(hc, hs, jobs, 21, "murmur3")
        fs_plain = (time.perf_counter() - t0) * 1e3
        if not torch.equal(cand.cpu(), want):
            raise PhaseError("fused_sketch disagrees with its plain "
                             "version at the finch run's launch")
        fs_err = 0.0
        cert_ms = time_ms(torch, lambda: [
            t.cpu() for t in sketch_stream.certify(cand, 1000)], 5)
        n_win = max(hc.numel() - 20, 0)
        n_valid = int((murmur3_k21(dc, ds) != SENTINEL_BIASED).sum())
        fs_bytes = hc.numel() + 8 * hs.numel() + len(jobs) * (
            16 + 8 * 2048 * 8)
        fs_ops = n_valid * FUSED_OPS_PER_WINDOW["murmur3"]
        fs_bound, fs_by = bound(fs_bytes, fs_ops)
        # the same launch with the multiply-free mixer: what the murmur3
        # hash and its ASCII key words cost beside the rest
        fast_ms = time_ms(torch, lambda: fused_sketch_candidates(
            dc, ds, jobs, 21, "tpufast"), 10)
        fast_bound, fast_by = bound(fs_bytes,
                                    n_valid * FUSED_OPS_PER_WINDOW["tpufast"])
        t0 = time.perf_counter()
        sketch_stream.sketch_genomes_fused(group, 1000, 21, "murmur3",
                                           device)
        torch.cuda.synchronize()
        group_ms = (time.perf_counter() - t0) * 1e3
        fs_split = {"group load (pinned write and copy)": fs["load_ms"],
                    "kernel": fs_ms, "certificate": cert_ms}
        stage_group = 1e3 * res_f.clock.seconds.get("sketch", 0.0) \
            / max(launches_f["fused_sketch"], 1)
        print(f"timing fused_sketch: {len(jobs)} jobs, {n_win} windows "
              f"({n_valid} valid) from {hc.numel()} codes, murmur3: kernel "
              f"{fs_ms:.4f} ms, plain (CPU tensors, host clock) "
              f"{fs_plain:.1f} ms, bound {fs_bound:.4f} ms ({fs_by}); "
              f"tpufast: kernel {fast_ms:.4f} ms, bound {fast_bound:.4f} "
              f"ms ({fast_by}) {tag}")
        print(f"timing finch group sketch: whole {group_ms:.2f} ms = "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in fs_split.items())
              + f" + the rest; largest part: {max(fs_split, key=fs_split.get)}"
              f"; host layout alone {fs['layout_ms']:.3f} ms; finch 1024 "
              f"sketch stage per launch group {stage_group:.2f} ms {tag}")
        # murmur3 at the dist k of phase 4h on the same group: the
        # kernel's general key; the first genome's candidates against the
        # plain version
        fs_other_k = {}
        for kk in DIST_K:
            _, _, jobs_k = host_layout(group, kk)
            k_ms = time_ms(torch, lambda: fused_sketch_candidates(
                dc, ds, jobs_k, kk, "murmur3"), 10)
            cand_k = fused_sketch_candidates(dc, ds, jobs_k, kk, "murmur3")
            one_c, one_s, one_jobs = host_layout(group[:1], kk)
            t0 = time.perf_counter()
            want_k = fused_candidates_plain(torch.from_numpy(one_c),
                                            torch.from_numpy(one_s),
                                            one_jobs, kk, "murmur3")
            k_plain = (time.perf_counter() - t0) * 1e3
            if not torch.equal(cand_k[:1].cpu(), want_k):
                raise PhaseError(f"fused_sketch (murmur3, k={kk}) disagrees "
                                 f"with its plain version at the finch "
                                 f"run's first genome")
            nv_k = valid_windows(hc.numpy(), hs.numpy(), kk)
            k_bound, k_by = bound(fs_bytes, nv_k * fused_murmur3_ops(kk))
            fs_other_k[kk] = {"ms": k_ms, "bound_ms": k_bound,
                              "bound_by": k_by, "valid_windows": nv_k,
                              "ops_per_window": fused_murmur3_ops(kk),
                              "plain_first_genome_ms": k_plain,
                              "max_abs_err": 0.0}
            print(f"timing fused_sketch murmur3 k={kk}: the same "
                  f"{len(jobs_k)} jobs, {nv_k} valid windows: kernel "
                  f"{k_ms:.4f} ms (k=21: {fs_ms:.4f} ms, "
                  f"{k_ms / fs_ms:.2f}x), bound {k_bound:.4f} ms ({k_by}, "
                  f"{fused_murmur3_ops(kk)} operations a window); plain "
                  f"on the first genome (CPU tensors, host clock) "
                  f"{k_plain:.1f} ms, candidates exact {tag}")
            del cand_k, want_k
        del cand, want, group, fs, hc, hs, dc, ds

        # pairlist: the finch run's collision survivors
        from galah_tpu_torch.ops.collision import candidate_pairs_minhash
        from galah_tpu_torch.ops.constants import SENTINEL_U64
        from galah_tpu_torch.ops.pairwise import (ani_to_jaccard,
                                                  stats_to_ani_f64)
        from galah_tpu_torch.ops.u64 import from_biased

        sk_store = res_f.preclusterer.store
        fmat = sketch_matrix([sk_store.get_cached(p) for p in res_f.genomes],
                             1000, device)
        host = from_biased(fmat)
        lens = (host != SENTINEL_U64).sum(axis=1)
        pi, pj = candidate_pairs_minhash(host, lens,
                                         ani_to_jaccard(0.90, 21), 1000)
        tpi = torch.from_numpy(pi).to(device)
        tpj = torch.from_numpy(pj).to(device)
        flens = valid_lengths(fmat)
        pl_out = (torch.empty(pi.shape[0], dtype=torch.int32, device=device),
                  torch.empty(pi.shape[0], dtype=torch.int32, device=device))
        pl_ms = time_ms(torch, lambda: pair_stats_pairs(fmat, tpi, tpj,
                                                        1000), 20)
        pl_kernel = time_ms(torch, lambda: run_pairlist(
            fmat, flens, tpi, tpj, 1000, *pl_out), 50)
        pl_pass = host_ms(torch, lambda: pair_stats_for_pairs(
            fmat, pi, pj, 1000), 20)
        pl_plain = time_ms(torch, lambda: pair_stats_pairs_plain(
            fmat, tpi, tpj, 1000), 3)
        c_k, t_k = pair_stats_pairs(fmat, tpi, tpj, 1000)
        c_p, t_p = pair_stats_pairs_plain(fmat, tpi, tpj, 1000)
        pl_err = float(max((c_k - c_p).abs().max(), (t_k - t_p).abs().max()))
        rows_used = np.union1d(pi, pj).shape[0]
        pl_bound, pl_by = bound(*pl_work(pi, pj, 1000, c_k.cpu().numpy(),
                                         t_k.cpu().numpy()))
        print(f"timing pairlist: {pi.shape[0]} survivor pairs of "
              f"{rows_used} rows, K=1000: whole call {pl_ms:.4f} ms, kernel "
              f"only {pl_kernel:.4f} ms, whole pass (host numpy in and out) "
              f"{pl_pass:.4f} ms, plain {pl_plain:.3f} ms, bound "
              f"{pl_bound:.5f} ms ({pl_by}) {tag}")
        # the dense-similarity list of phase 3: the kernel alone in one
        # launch, and the whole pass
        dn_lens = valid_lengths(dn_mat)
        dn_out = (torch.empty(dn_pi.shape[0], dtype=torch.int32,
                              device=device),
                  torch.empty(dn_pi.shape[0], dtype=torch.int32,
                              device=device))
        dn_kernel = time_ms(torch, lambda: run_pairlist(
            dn_mat, dn_lens, dn_ti, dn_tj, 1000, *dn_out), 5)
        dn_pass = host_ms(torch, lambda: pair_stats_for_pairs(
            dn_mat, dn_pi, dn_pj, 1000), 3)
        dn_bound, dn_by = bound(*pl_work(
            dn_pi, dn_pj, 1000, *(t.cpu().numpy() for t in dn_out)))
        print(f"timing pairlist dense: {dn_pi.shape[0]} pairs of "
              f"{dn_np.shape[0]} rows, K=1000: kernel only {dn_kernel:.4f} "
              f"ms, whole pass (host numpy in and out, one launch) "
              f"{dn_pass:.4f} ms, bound {dn_bound:.4f} ms ({dn_by}) {tag}")
        del dn_mat, dn_ti, dn_tj, dn_lens, dn_out, pl_out

        # hll_union: the first row block of phase 4d's pair pass
        h_store = res_h.preclusterer.store
        n_h = len(res_h.genomes)
        n_hpad = -(-n_h // 256) * 256  # lcm of its row and column tiles
        hmat = torch.zeros(n_hpad, 4096, dtype=torch.uint8, device=device)
        hmat[:n_h] = torch.stack([h_store.get_cached(p)
                                  for p in res_h.genomes])
        hrows = hmat[:64].contiguous()
        hu_ms = time_ms(torch, lambda: hll_union_stats(hrows, hmat), 20)
        hu_launch = hll_prepare(hrows, hmat)
        hu_kernel = time_ms(torch, lambda: hll_run(hu_launch), 20)
        hu_plain = time_ms(torch, lambda: hll_union_stats_plain(hrows,
                                                                hmat), 3)
        ps, z = hll_union_stats(hrows, hmat)
        pps, pz = hll_union_stats_plain(hrows, hmat)
        if not (torch.equal(ps, pps) and torch.equal(z, pz)):
            raise PhaseError("hll_union disagrees with its plain version "
                             "at phase 4d's shapes")
        hu_err = float(max((ps - pps).abs().max(), (z - pz).abs().max()))
        hu_bytes = (hrows.numel() + hmat.numel()) \
            + 2 * 4 * hrows.shape[0] * hmat.shape[0]
        hu_ops = HLL_UNION_OPS_PER_REGISTER * float(
            hrows.shape[0] * hmat.shape[0] * 4096)
        hu_bound, hu_by = bound(hu_bytes, hu_ops)
        print(f"timing hll_union: {hrows.shape[0]}x{hmat.shape[0]} pairs, "
              f"m=4096 (phase 4d's first row block; registers <= "
              f"{int(hmat.max())}): whole call {hu_ms:.4f} ms, kernel "
              f"only {hu_kernel:.4f} ms, plain {hu_plain:.3f} ms, bound "
              f"{hu_bound:.4f} ms ({hu_by}) {tag}")
        # the whole pass: each of its row blocks against mat[c0:], as
        # ops/hll.py launches them, with the planner's slices and blocks
        hu_pass = []
        for r0 in range(0, n_hpad, hll_row_tile):
            c0 = (r0 // hll_col_tile) * hll_col_tile
            rows_b = hmat[r0:r0 + hll_row_tile]
            cols_b = hmat[c0:]
            prepared = hll_prepare(rows_b, cols_b)
            hu_pass.append({
                "pairs": [rows_b.shape[0], cols_b.shape[0]],
                "slices": prepared.plan.slices,
                "blocks": prepared.plan.blocks,
                "ms": time_ms(torch, lambda: hll_union_stats(rows_b,
                                                             cols_b), 20),
                "kernel_only_ms": time_ms(torch, lambda: hll_run(prepared),
                                          20)})
        hu_pass_ms = sum(b["ms"] for b in hu_pass)
        hu_pass_kernel = sum(b["kernel_only_ms"] for b in hu_pass)
        hu_pass_bound = sum(bound(
            b["pairs"][0] * 4096 + b["pairs"][1] * 4096
            + 8 * b["pairs"][0] * b["pairs"][1],
            HLL_UNION_OPS_PER_REGISTER * 4096.0 * b["pairs"][0]
            * b["pairs"][1])[0] for b in hu_pass)
        shapes = sorted({(b["pairs"][1], b["slices"], b["blocks"])
                         for b in hu_pass}, reverse=True)
        print(f"timing hll_union pass: {len(hu_pass)} launches of phase "
              f"4d's pair pass at their own shapes: whole calls "
              f"{hu_pass_ms:.4f} ms in all, kernel only "
              f"{hu_pass_kernel:.4f} ms, bound {hu_pass_bound:.4f} ms; "
              f"(columns, slices, "
              f"blocks) {shapes} {tag}")
        del hmat, hrows, ps, z, pps, pz, rows_b, cols_b, prepared, hu_launch

        # murmur3_k21: phase 4d's first launch group, its largest, and
        # the group's whole HLL sketch split into its parts
        group = first_group(res_h.genomes, read_genome,
                            sketch_stream.FUSED_BUDGET)
        hh = time_group(torch, device, group)
        hc, hs, dc, ds, jobs = hh["tensors"]
        mm_ms = time_ms(torch, lambda: murmur3_k21(dc, ds), 10)
        hashes = murmur3_k21(dc, ds)
        t0 = time.perf_counter()
        want = murmur3_k21_plain(hc, hs)
        mm_plain = (time.perf_counter() - t0) * 1e3
        if not torch.equal(hashes.cpu(), want):
            raise PhaseError("murmur3_k21 disagrees with its plain "
                             "version at phase 4d's launch")
        mm_err = 0.0
        hregs = torch.zeros(len(group), 4096, dtype=torch.int32,
                            device=device)
        fold_ms = time_ms(torch, lambda: fold_group(
            hregs, hashes, jobs, range(len(group)), 12), 3)
        n_win = hashes.numel()
        n_valid = int((hashes != SENTINEL_BIASED).sum())
        mm_bytes = hc.numel() + 8 * hs.numel() + 8 * n_win
        mm_ops = n_valid * MURMUR3_OPS_PER_WINDOW
        mm_bound, mm_by = bound(mm_bytes, mm_ops)
        t0 = time.perf_counter()
        hll_sketch_genomes(group, device=device)
        torch.cuda.synchronize()
        hgroup_ms = (time.perf_counter() - t0) * 1e3
        mm_split = {"group load (pinned write and copy)": hh["load_ms"],
                    "kernel": mm_ms, "HLL fold": fold_ms}
        hstage_group = 1e3 * res_h.clock.seconds.get("sketch", 0.0) \
            / max(launches_h["murmur3_k21"], 1)
        print(f"timing murmur3_k21: {len(group)} genomes, {n_win} windows "
              f"({n_valid} valid) from {hc.numel()} codes: kernel "
              f"{mm_ms:.4f} ms, plain (CPU tensors, host clock) "
              f"{mm_plain:.1f} ms, bound {mm_bound:.4f} ms ({mm_by}) {tag}")
        print(f"timing dashing group sketch: whole {hgroup_ms:.2f} ms = "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in mm_split.items())
              + f" + the rest; largest part: {max(mm_split, key=mm_split.get)}"
              f"; host layout alone {hh['layout_ms']:.3f} ms; dashing 1024 "
              f"sketch stage per launch group {hstage_group:.2f} ms {tag}")
        del hashes, want, hregs, group, hh, hc, hs, dc, ds

        # -- phase 6: kernel path vs plain path on the card ---------------
        print(f"phase 6 starts {time.perf_counter() - t_script:.1f} s "
              f"after the device check {tag}")
        sub = [p for p in store.get_many(res.genomes[:16])]
        pairs = [(sub[i], sub[j]) for i in range(16)
                 for j in range(i + 1, 16)]
        a_k = fragment_ani.bidirectional_ani_values(pairs, 0.15)
        a_p = fragment_ani.bidirectional_ani_values(
            pairs, 0.15, hits=window_element_hits_plain)
        if a_k != a_p:
            raise PhaseError("bidirectional ANI differs between the "
                             "kernel and plain paths")
        n_val = sum(v is not None for v in a_k)
        print(f"kernel vs plain path: {len(pairs)} pairs of 16 genomes, "
              f"{n_val} gated values, identical floats {tag}")
        # the same 16 genomes' profiles at --ani-subsample 125
        sub125 = fragment_ani.build_profiles_batch(
            [read_genome(p) for p in res.genomes[:16]], 15, 3000, device,
            subsample_c=125)
        pairs125 = [(sub125[i], sub125[j]) for i in range(16)
                    for j in range(i + 1, 16)]
        a_k = fragment_ani.bidirectional_ani_values(pairs125, 0.15)
        a_p = fragment_ani.bidirectional_ani_values(
            pairs125, 0.15, hits=window_element_hits_plain)
        if a_k != a_p:
            raise PhaseError("bidirectional ANI at --ani-subsample 125 "
                             "differs between the kernel and plain paths")
        print(f"kernel vs plain path at --ani-subsample 125: "
              f"{len(pairs125)} pairs of 16 genomes, "
              f"{sum(v is not None for v in a_k)} gated values, identical "
              f"floats {tag}")
        del sub125, pairs125

        from galah_tpu_torch.ops.pairwise import (threshold_pairs,
                                                  threshold_pairs_streamed)
        from galah_tpu_torch.ops.sparse_device import threshold_pairs_sparse

        sub_paths = res_f.genomes[:64]
        n_sub = len(sub_paths)
        kern = [sk_store.get_cached(p) for p in sub_paths]
        for p, s in zip(sub_paths, kern):
            e = sketch_genome_device(read_genome(p), 1000, 21, "murmur3",
                                     device, k21_hash=plain_hook)
            if not np.array_equal(s.hashes, e.hashes):
                raise PhaseError(f"finch sketch of {p} differs between "
                                 "the kernel and plain paths")
        m64 = sketch_matrix(kern, 1000, device)
        plain = plain_pair_dict(torch, m64, 21, 0.90, 1000)
        passes = {
            "threshold_pairs": threshold_pairs(m64, 21, 0.90),
            "streamed, blocks of 16": threshold_pairs_streamed(
                row_blocks(m64, 16), n_sub, 21, 0.90, 1000, block=16),
            "pairlist": threshold_pairs_sparse(m64, 21, 0.90)}
        for name, got in passes.items():
            if not (got == plain and plain):
                raise PhaseError(f"finch pair dict of the {name} pass "
                                 f"differs from the plain path's")
        print(f"finch kernel vs plain path: {n_sub} genomes, sketches "
              f"equal, "
              f"{len(plain)} pairs, identical ANI floats (streamed "
              f"tile_stats pass in blocks of 256 and 16, pairlist pass) "
              f"{tag}")
        # the streamed pass at phase 4e's shapes: four stripes, the last
        # of 232 rows
        e_store = res_e.preclusterer.store
        emat = sketch_matrix([e_store.get_cached(p) for p in res_e.genomes],
                             1000, device)
        plain_e = plain_pair_dict(torch, emat, 21, 0.90, 1000)
        clock_e = StageClock(device)
        got_e = threshold_pairs_streamed(
            row_blocks(emat, sketch_stream.ROW_BLOCK), n_e, 21, 0.90, 1000,
            clock_e, block=sketch_stream.ROW_BLOCK)
        if got_e != plain_e or not plain_e:
            raise PhaseError(f"the streamed pass over phase 4e's {n_e} "
                             f"sketches differs from the plain pair "
                             f"statistics of all pairs")
        require_counts(clock_e.counts, {"pairs-streamed-stripes": stripes},
                       "phase 6 streamed")
        del emat
        print(f"finch streamed vs plain path: {n_e} sketches of phase 4e, "
              f"{stripes} stripes (last "
              f"{n_e - (stripes - 1) * sketch_stream.ROW_BLOCK} rows), "
              f"{n_e * (n_e - 1) // 2} pairs, {len(plain_e)} "
              f"passing, identical keys and ANI floats {tag}")

        # whole families: the corpus' first 64 genomes in input order
        sub_h = [read_genome(p) for p in paths[:64]]
        regs_k = hll_sketch_genomes(sub_h, device=device)
        regs_p = hll_sketch_genomes(sub_h, device=device,
                                    k21_hash=plain_hook)
        stored = torch.stack([h_store.get_cached(p) for p in paths[:64]])
        if not (torch.equal(regs_k, regs_p) and torch.equal(regs_k,
                                                             stored)):
            raise PhaseError("HLL registers differ between the kernel "
                             "and plain paths")
        pairs_k = hll_threshold_pairs(regs_k, 21, 0.90)
        pairs_p = hll_threshold_pairs(regs_p, 21, 0.90,
                                      union_stats=hll_union_stats_plain)
        if pairs_k != pairs_p:
            raise PhaseError("dashing pair dict differs between the kernel "
                             "and plain paths")
        within_h = {(i, j) for i in range(len(sub_h))
                    for j in range(i + 1, len(sub_h))
                    if labels[i] == labels[j]}
        if not within_h <= set(pairs_k):
            raise PhaseError(f"dashing pair dict of {len(sub_h)} genomes "
                             f"misses {len(within_h - set(pairs_k))} of its "
                             f"{len(within_h)} within-family pairs")
        print(f"dashing kernel vs plain path: {len(sub_h)} genomes, "
              f"registers equal, {len(pairs_k)} pairs ({len(within_h)} "
              f"within families, all found), identical ANI floats {tag}")

    no_library = ("no single PyTorch call computes this function (for "
                  "window_hits, torch.isin does for one pair: its "
                  "library_ms is one call a pair, summed)")
    record = {"kernels": [
        {"name": "window_hits", "route": "cuda",
         "source": "galah_tpu_torch/kernels/window_hits.cu",
         "replaces": "galah_tpu/ops/pallas_fragment.py:170",
         "launches": launches["window_hits"], "max_abs_err": wh_err,
         "ms": wh_ms, "plain_ms": wh_plain, "bound_ms": wh_bound,
         "bound_by": wh_by, "library_ms": wh_lib,
         "kernel_only_ms": wh_kernel,
         "library_call": "torch.isin(q, r), one call a pair, summed"},
        {"name": "tile_stats", "route": "cuda",
         "source": "galah_tpu_torch/kernels/tile_stats.cu",
         "replaces": "galah_tpu/ops/pallas_pairwise.py:308",
         "launches": launches["tile_stats"], "max_abs_err": ts_err,
         "ms": ts_ms, "plain_ms": ts_plain, "bound_ms": ts_bound,
         "bound_by": ts_by, "library_ms": None,
         "kernel_only_ms": ts_kernel,
         "full_form": {"launches": launches_e["tile_stats"],
                       "launches_finch_256": launches_d["tile_stats"],
                       "shape": [tf["rows"], tf["cols"]],
                       "ms": tf_ms, "kernel_only_ms": tf_kernel,
                       "plain_ms": tf_plain, "bound_ms": tf_bound,
                       "bound_by": tf_by, "stripes": tf_stripes},
         "intersect_wide_k": ts_wide},
        {"name": "fused_sketch", "route": "cuda",
         "source": "galah_tpu_torch/kernels/fused_sketch.cu",
         "replaces": "galah_tpu/ops/pallas_sketch.py:400",
         "launches": launches_f["fused_sketch"], "max_abs_err": fs_err,
         "ms": fs_ms, "plain_ms": fs_plain, "bound_ms": fs_bound,
         "bound_by": fs_by, "library_ms": None,
         "plain_on": "CPU tensors, host clock", "group_ms": group_ms,
         "group_split_ms": fs_split,
         "tpufast": {"ms": fast_ms, "bound_ms": fast_bound,
                     "bound_by": fast_by},
         "murmur3_other_k": {str(kk): v for kk, v in fs_other_k.items()},
         "launches_dist": {w: v["fused_sketch"] for w, v in
                           cli_out["dist_runs"].items()},
         "launches_api_finch": api_out["finch"]["launches"]["fused_sketch"]},
        {"name": "pairlist", "route": "cuda",
         "source": "galah_tpu_torch/kernels/pairlist.cu",
         "replaces": "galah_tpu/ops/pallas_pairlist.py:403",
         "launches": launches_f["pairlist"], "max_abs_err": pl_err,
         "ms": pl_ms, "plain_ms": pl_plain, "bound_ms": pl_bound,
         "bound_by": pl_by, "library_ms": None,
         "kernel_only_ms": pl_kernel, "pass_ms": pl_pass,
         "dense": {"pairs": int(dn_pi.shape[0]), "kernel_only_ms": dn_kernel,
                   "pass_ms": dn_pass, "bound_ms": dn_bound,
                   "bound_by": dn_by},
         "index": {"launches": {w: v["pairlist"] for w, v in
                                index_out["launches"].items()},
                   "insert_pass": index_out["pass"]}},
        {"name": "hll_union", "route": "cuda",
         "source": "galah_tpu_torch/kernels/hll_union.cu",
         "replaces": "galah_tpu/ops/pallas_hll.py:72",
         "launches": launches_h["hll_union"], "max_abs_err": hu_err,
         "ms": hu_ms, "plain_ms": hu_plain, "bound_ms": hu_bound,
         "bound_by": hu_by, "library_ms": None,
         "kernel_only_ms": hu_kernel,
         "pass": {"ms": hu_pass_ms, "kernel_only_ms": hu_pass_kernel,
                  "bound_ms": hu_pass_bound, "launches": hu_pass}},
        {"name": "murmur3_k21", "route": "cuda",
         "source": "galah_tpu_torch/kernels/murmur3_k21.cu",
         "replaces": "galah_tpu/ops/pallas_sketch.py:235",
         "launches": launches_h["murmur3_k21"], "max_abs_err": mm_err,
         "ms": mm_ms, "plain_ms": mm_plain, "bound_ms": mm_bound,
         "bound_by": mm_by, "library_ms": None,
         "plain_on": "CPU tensors, host clock", "group_ms": hgroup_ms,
         "group_split_ms": mm_split},
        {"name": "positional_hashes", "route": "cuda",
         "source": "galah_tpu_torch/kernels/positional_hashes.cu",
         "replaces": "galah_tpu/ops/hashing.py:308",
         "replaces_note": "no TPU kernel: galah_tpu hashes the k=15 "
                          "profile windows in XLA (_hash_core)",
         "launches": launches["positional_hashes"], "max_abs_err": ph_err,
         "ms": ph_ms, "plain_ms": ph_plain, "bound_ms": ph_bound,
         "bound_by": ph_by, "library_ms": None,
         "plain_on": "CPU tensors, host clock",
         "launches_by_path": {
             "skani": launches["positional_hashes"],
             "finch": launches_f["positional_hashes"],
             "finch_dense": launches_d["positional_hashes"],
             "dashing": launches_h["positional_hashes"],
             "finch_streamed": launches_e["positional_hashes"],
             "fastani": launches_a["positional_hashes"]},
         "tpufast": {"ms": ph_fast, "bound_ms": ph_fast_bound,
                     "bound_by": ph_fast_by},
         "group_build_ms": build_ms, "group_split_ms": ph_split,
         "distinct_two_key_ms": two_key_ms},
    ], "library_ms_null_because": no_library, "card": card,
        "fasta_parser": {"route": "c",
                         "source": "galah_tpu_torch/csrc/ingest.c",
                         "files": parser["files"], "c_ms": parser["c_ms"],
                         "plain_ms": parser["plain_ms"]},
        "launches_phases_4g_4i": {
            "cli cluster": cli_out["launches_g"],
            **{f"cli {w}": v[2] for w, v in cli_out["validations"].items()},
            **cli_out["dist_runs"],
            **{f"cache {w}": v for w, v in cli_out["cache_runs"].items()}},
        "cache_profile": cli_out["cache_profile"],
        "launches_phases_4j_4k": resil_out["launches"],
        "walls_phases_4j_4k": resil_out["walls"],
        "launches_phase_4l": index_out["launches"],
        "phase_4o_obs": obs_out,
        "walls_phase_4l": index_out["walls"],
        "phase_4m_api": {w: {"wall": v["wall"], "cli_wall": v["cli_wall"],
                             "launches": v["launches"]}
                         for w, v in api_out.items()},
        "phase_4n_subsample": {
            "runs": {str(c): v for c, v in sub_out["runs"].items()},
            "c1": {"exact_ani_s": res.clock.seconds["exact-ani"],
                   "window_hits": launches["window_hits"],
                   "query_elements": res.clock.counts["query-elements"]},
            "validate": sub_out["validate"], "api": sub_out["api"]},
        "validate_rep_pairs": {
            "pairs": cli_out["validations"]["validate"][0].rep_pairs,
            "seconds": cli_out["validations"]["validate"][0].rep_seconds}}
    print(f"script: {time.perf_counter() - t_script:.1f} s after the "
          f"device check {tag}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
