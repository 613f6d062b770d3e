"""Time the gathered-tile entry of ``tile_stats.cu`` against
``pairlist.cu`` on the same survivor lists, on one NVIDIA GPU, and
derive the two rates of ``ops/sparse_device.py``'s AUTO pick.

    python -m galah_tpu_torch.kernels.rehearse_gather \\
        [--seed 0] [--reps 5] [--segments 128] [--out FILE]

Lists (``sketch_size`` 1000, biased int64 rows made from the seed): a
matrix of ``64 x segments`` rows in planted families of 32 (``rehearse_pairlist.family_rows``, ~98% ANI within a
family), and for each tile fill f in FILLS one survivor list built to
plan into exactly ``segments`` segments of the gather planner: segment
s pairs its own 64 a rows with 128 distinct b rows of the a rows'
families and their neighbours, each of its 64 x 128 cells listed with
probability f (every row and column at least once), sorted by (i, j)
as the collision screen emits. ``fill_list`` is also the source of
``chip_smoke.py``'s phase-3 lists.

Each list is first held exactly: the gathered route
(``pair_stats_for_pairs(..., strategy="gather")``) and the blocked
route (``strategy="blocked"``) against ``pair_stats_pairs_plain`` on
the card. Then, per list: the gathered entry alone
(``tile_stats.run_gather_launch`` over a prepared plan, CUDA events),
its whole call (``tile_stats.gather_stats``: plan, upload, launch,
readback; host clock), the gathered route (the planner too), and
``pairlist.cu`` alone and as the blocked route. One JSON line a list,
with the entry's bound (``kernels/costs.tile_stats_gather`` over the
H100's 3.35e12 bytes/s and 67e12 32-bit operations/s; its bytes count
the distinct rows the pairs name). Last, the two rates of ``galah_tpu``'s
AUTO test, which ``ops/sparse_device.py`` cites: the gathered route's
cells a second at f = 1.0 and the blocked route's pairs a second (the
median over the lists), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from galah_tpu_torch.kernels import costs
from galah_tpu_torch.kernels.rehearse_pairlist import K, family_rows

FILLS = (0.1, 0.2, 0.3, 0.5, 0.75, 1.0)
FAMILY = 32
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def fill_list(rng: np.random.Generator, segments: int, fill: float,
              n_rows: int):
    """(pi, pj) int64 of a survivor list that the gather planner cuts
    into exactly `segments` segments at tile fill ~`fill` over a matrix
    of `n_rows` >= 64 x segments rows, sorted by (pi, pj)."""
    pis, pjs = [], []
    for s in range(segments):
        a = np.arange(s * 64, (s + 1) * 64)
        # b rows near the a rows' own families
        lo = max(0, min(s * 64 - 32, n_rows - 128))
        b = np.sort(rng.choice(np.arange(lo, min(n_rows, lo + 256)), 128,
                               replace=False))
        keep = rng.random((64, 128)) < fill
        keep[np.arange(64), rng.integers(0, 128, size=64)] = True
        keep[rng.integers(0, 64, size=128), np.arange(128)] = True
        ra, rb = np.nonzero(keep)
        pis.append(a[ra])
        pjs.append(b[rb])
    pi, pj = np.concatenate(pis), np.concatenate(pjs)
    order = np.lexsort((pj, pi))
    return pi[order].astype(np.int64), pj[order].astype(np.int64)


def family_matrix(rng: np.random.Generator, n_rows: int) -> np.ndarray:
    return np.concatenate([family_rows(rng, FAMILY, short_every=16)
                           for _ in range(-(-n_rows // FAMILY))])[:n_rows]


def bound_ms(n_rows: int, n_seg: int, n_pairs: int, k: int):
    nbytes, ops = costs.tile_stats_gather(n_rows, n_seg, n_pairs, k)
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def events_ms(torch, fn, reps: int) -> float:
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
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_list(torch, mat, pi, pj, sketch_size: int) -> None:
    """Both routes against the plain version on the card, exactly."""
    from galah_tpu_torch.ops.pairlist import pair_stats_pairs_plain
    from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs

    got = {s: pair_stats_for_pairs(mat, pi, pj, sketch_size, strategy=s)
           for s in ("gather", "blocked")}
    ti = torch.from_numpy(pi).to(mat.device)
    tj = torch.from_numpy(pj).to(mat.device)
    for s0 in range(0, pi.shape[0], 1 << 16):
        pc, pt = pair_stats_pairs_plain(mat, ti[s0:s0 + (1 << 16)],
                                        tj[s0:s0 + (1 << 16)], sketch_size)
        pc, pt = pc.cpu().numpy(), pt.cpu().numpy()
        for s, (c, t) in got.items():
            if not (np.array_equal(c[s0:s0 + (1 << 16)], pc)
                    and np.array_equal(t[s0:s0 + (1 << 16)], pt)):
                raise RuntimeError(
                    f"{s} route disagrees with the plain version at pairs "
                    f"[{s0}, {s0 + (1 << 16)}) S={sketch_size}")


def time_list(torch, mat, pi, pj, reps: int) -> dict:
    """One list's times (ms): the gathered entry alone and as a whole
    call, the gathered route, pairlist.cu alone and the blocked
    route."""
    from galah_tpu_torch.ops import sparse_device as sd
    from galah_tpu_torch.ops import tile_stats as ts
    from galah_tpu_torch.ops.pairlist import run_launch, valid_lengths

    pi32, pj32 = pi.astype(np.int32), pj.astype(np.int32)
    order = np.lexsort((pj32, pi32))
    segs, cells = sd.plan_gather_segments(pi32[order], pj32[order])
    ua, ub, seg, ra, rb, _ = sd.segment_tables(segs)
    lens = valid_lengths(mat)
    plan = ts.plan_gather(mat.device, ua, ub, seg, ra, rb)
    n = pi.shape[0]
    out = torch.empty((2, n), dtype=torch.int32, device=mat.device)
    ti = torch.from_numpy(pi).to(mat.device)
    tj = torch.from_numpy(pj).to(mat.device)
    k = mat.shape[1]
    entry_ms = events_ms(torch, lambda: ts.run_gather_launch(
        mat, lens, plan, k, out[0], out[1]), reps)
    pairlist_ms = events_ms(torch, lambda: run_launch(
        mat, lens, ti, tj, k, out[0], out[1]), reps)
    call_ms = host_ms(torch, lambda: ts.gather_stats(
        mat, ua, ub, seg, ra, rb, k), reps)
    gather_ms = host_ms(torch, lambda: sd.pair_stats_for_pairs(
        mat, pi, pj, k, strategy="gather"), reps)
    blocked_ms = host_ms(torch, lambda: sd.pair_stats_for_pairs(
        mat, pi, pj, k, strategy="blocked"), reps)
    b_ms, b_by = bound_ms(plan.n_rows, len(segs), n, k)
    return {"pairs": int(n), "segments": len(segs), "cells": int(cells),
            "rows": plan.n_rows, "fill": n / cells, "entry_ms": entry_ms,
            "entry_call_ms": call_ms, "gather_route_ms": gather_ms,
            "pairlist_ms": pairlist_ms, "blocked_route_ms": blocked_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rehearse_gather: no CUDA device", file=sys.stderr)
        return 1
    from galah_tpu_torch.kernels import build

    build.build(["tile_stats", "pairlist"])
    rng = np.random.default_rng(args.seed)
    n_rows = 64 * args.segments
    mat = torch.from_numpy(family_matrix(rng, n_rows)).cuda()
    lines = []
    for fill in FILLS:
        pi, pj = fill_list(rng, args.segments, fill, n_rows)
        for sketch_size in (K, K // 3):
            check_list(torch, mat, pi, pj, sketch_size)
        rec = {"what": "gather-vs-pairlist", "k": K, "target_fill": fill,
               **time_list(torch, mat, pi, pj, args.reps)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    full = [r for r in lines if r["target_fill"] == 1.0][0]
    rates = {"what": "auto-rates", "k": K,
             "gather_cells_per_s": full["cells"] / (
                 full["gather_route_ms"] / 1e3),
             "blocked_pairs_per_s": float(np.median(
                 [r["pairs"] / (r["blocked_route_ms"] / 1e3)
                  for r in lines])),
             "gather_entry_cells_per_s": full["cells"] / (
                 full["entry_ms"] / 1e3),
             "pairlist_pairs_per_s": float(np.median(
                 [r["pairs"] / (r["pairlist_ms"] / 1e3) for r in lines])),
             "card": card_line()}
    lines.append(rates)
    print(json.dumps(rates), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in lines))
    print(rates["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
