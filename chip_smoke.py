#!/usr/bin/env python3
"""Drive galah_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--genomes 512]

Phases, each of which exits nonzero when it fails:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the path with nvcc for sm_90a;
3. kernel parity: each kernel against its plain torch version on the
   card, exact integer equality, on edge-case inputs;
4. end to end: a MAG-like corpus made from the seed (512 genomes of
   ~2 Mbp in 128 planted families of 4 at ~99% ANI to the family base)
   through the ``cluster`` entry point on cuda; the clusters must equal
   the planted families, and every kernel must have been launched;
5. the kernels timed at the shapes the end-to-end run gave them, beside
   their plain versions and their bound on this card;
6. kernel path against plain torch path on the card for 16 genomes of
   the corpus: identical bidirectional ANI floats.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit, and the line before that the
per-kernel JSON record. Every line holding a number names the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit
# operations/s outside the tensor cores (the float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

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


def _fasta_bytes(name: str, seq: np.ndarray, rng) -> bytes:
    """A genome as FASTA: contigs of 5-50 kb at random cut points,
    80-column lines."""
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
    return np.concatenate(parts).tobytes()


def make_corpus(root: str, n_genomes: int, length: int, family: int,
                seed: int):
    """Planted families: each member is its family base with 1% of
    sites substituted; families are independent random sequences;
    each genome gets a few short N runs. Returns (paths, labels)."""
    rng = np.random.default_rng(seed)
    paths, labels = [], []
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
            with open(p, "wb") as fh:
                fh.write(_fasta_bytes(f"fam{fam}_m{m}", seq, rng))
            paths.append(p)
            labels.append(fam)
    return paths, labels


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
    return items


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
    return cases


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


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=512,
                    help="corpus size, a multiple of 4 (default 512)")
    ap.add_argument("--genome-length", type=int, default=2_000_000)
    args = ap.parse_args(argv)
    family = 4
    if args.genomes % family or args.genomes < 16:
        ap.error("--genomes must be a multiple of 4, at least 16")

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

    # -- phase 2: build ---------------------------------------------------
    from galah_tpu_torch.kernels import build

    build_s = build.build(KERNELS)
    print(f"build: {build_s:.2f} s for {len(KERNELS)} kernels (nvcc, "
          f"sm_90a) {tag}")

    # -- phase 3: kernel parity ------------------------------------------
    from galah_tpu_torch.ops.tile_stats import (tile_intersect_plain,
                                                tile_stats, tile_stats_plain)
    from galah_tpu_torch.ops.window_hits import (window_element_hits,
                                                 window_element_hits_plain)

    rng = np.random.default_rng(args.seed)
    items = window_hits_cases(rng, torch, device)
    got = window_element_hits(items, device)
    want = window_element_hits_plain(items, device)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise PhaseError("window_hits disagrees with its plain version "
                         f"at {int((got != want).sum())} elements")
    print(f"parity window_hits: {len(items)} pairs, {got.numel()} "
          f"elements, {int(want.sum())} hits, exact {tag}")
    for rows, cols, k in tile_stats_cases(rng, torch, device):
        c, t = tile_stats(rows, cols, k, intersect=True)
        if not torch.equal(c, tile_intersect_plain(rows, cols)):
            raise PhaseError(f"tile_stats intersect disagrees at K={k}")
        for sketch_size in (k, k // 3):
            c, t = tile_stats(rows, cols, sketch_size)
            pc, pt = tile_stats_plain(rows, cols, sketch_size)
            if not (torch.equal(c, pc) and torch.equal(t, pt)):
                raise PhaseError(
                    f"tile_stats disagrees at K={k} S={sketch_size}")
        torch.cuda.synchronize()
        print(f"parity tile_stats: K={k} Br={rows.shape[0]} "
              f"Bc={cols.shape[0]} intersect+full exact {tag}")
    # the per-kernel record near the end is the one {"kernels": ...}
    # object the output holds; this line only lists what passed parity
    print(f"parity kernels: {json.dumps(list(KERNELS))} {tag}")

    # -- phase 4: end to end ---------------------------------------------
    with tempfile.TemporaryDirectory(prefix="galah_smoke_") as root:
        t0 = time.perf_counter()
        paths, labels = make_corpus(root, args.genomes, args.genome_length,
                                    family, args.seed)
        gbp = args.genomes * args.genome_length / 1e9
        print(f"corpus: {args.genomes} genomes x {args.genome_length} bp "
              f"({gbp:.3f} Gbp), {args.genomes // family} families, "
              f"written in {time.perf_counter() - t0:.1f} s {tag}")
        if args.genomes != 512:
            print(f"corpus cut: {args.genomes} genomes instead of 512 "
                  f"(genome length {args.genome_length}) {tag}")
        out_tsv = os.path.join(root, "clusters.tsv")
        reset_launches()
        t0 = time.perf_counter()
        res = cli.run_cluster(cli.parse_args(
            ["cluster", "-d", root, "--ani", "95", "--device", "cuda",
             "--output-cluster-definition", out_tsv]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        label_of = dict(zip(paths, labels))
        got = sorted(sorted(label_of[res.genomes[i]] for i in c)
                     for c in res.clusters)
        want = sorted([f] * family for f in range(args.genomes // family))
        if got != want:
            raise PhaseError(f"clusters differ from the planted families: "
                             f"{len(res.clusters)} clusters")
        with open(out_tsv) as fh:
            n_lines = sum(1 for _ in fh)
        if n_lines != args.genomes:
            raise PhaseError(f"cluster TSV has {n_lines} lines")
        print(f"end to end: {len(res.clusters)} clusters == "
              f"{args.genomes // family} planted families, wall "
              f"{wall:.2f} s {tag}")
        for stage in ("read", "profile", "screen", "exact-ani", "greedy"):
            print(f"stage {stage}: {res.clock.seconds.get(stage, 0.0):.3f} "
                  f"s {tag}")
        for name, n in sorted(res.clock.counts.items()):
            print(f"count {name}: {n} {tag}")
        for name in KERNELS:
            print(f"launches {name}: {launches[name]} {tag}")
            if launches[name] == 0:
                raise PhaseError(f"kernel {name} was never launched on "
                                 "the main path")

        # -- phase 5: timing at the main path's shapes ---------------------
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
        print(f"timing window_hits: {len(wh_items)} directed pairs, "
              f"{n_elem} elements: kernel {wh_ms:.3f} ms, plain "
              f"{wh_plain:.3f} ms, bound {wh_bound:.3f} ms ({wh_by}) {tag}")
        print(f"timing tile_stats: {rows.shape[0]}x{mat.shape[0]} pairs, "
              f"K={k}: kernel {ts_ms:.3f} ms, plain {ts_plain:.3f} ms, "
              f"bound {ts_bound:.4f} ms ({ts_by}) {tag}")

        # -- phase 6: kernel path vs plain path on the card ---------------
        sub = profiles[:16]
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

    record = {"kernels": [
        {"name": "window_hits", "route": "cuda",
         "source": "galah_tpu_torch/kernels/window_hits.cu",
         "replaces": "galah_tpu/ops/pallas_fragment.py:170",
         "launches": launches["window_hits"], "max_abs_err": wh_err,
         "ms": wh_ms, "plain_ms": wh_plain, "bound_ms": wh_bound,
         "bound_by": wh_by, "library_ms": None},
        {"name": "tile_stats", "route": "cuda",
         "source": "galah_tpu_torch/kernels/tile_stats.cu",
         "replaces": "galah_tpu/ops/pallas_pairwise.py:308",
         "launches": launches["tile_stats"], "max_abs_err": ts_err,
         "ms": ts_ms, "plain_ms": ts_plain, "bound_ms": ts_bound,
         "bound_by": ts_by, "library_ms": None},
    ], "card": card}
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
