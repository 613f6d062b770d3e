"""Time ``slab_fold.cu``'s chosen tier against its global-memory tier
(the first design, kept as the tier for slabs beyond 8 SMs) on one
NVIDIA GPU, at the slabs ``chip_smoke.py``'s phase 5 times.

    python -m galah_tpu_torch.kernels.rehearse_slab_fold [--seed 0] \\
        [--reps 20]

Slabs (``phase5_slabs``; phase 5 adds the largest slabs of its phase
4u runs): the 16-window slab (width 16,384, 4,096 edges near the
diagonal), chains of 1,024 and 4,096 positions (one decision an
iteration, every iteration of the depth bound) and a slab of width
65,536 that ``ops/megakernel.fold_plan`` gives a cluster of 2.

At each slab the chosen tier is first checked against
``slab_fold_plain`` (rep and undecided flags and iterations, bit for
bit); then both tiers are timed in turns (global, chosen, chosen,
global), each three ways:

- kernel alone: ``ops/megakernel.run_launch`` into a held workspace,
  cost accounting off, CUDA events over `reps` launches queued behind a
  spin, so the host's launch overhead does not pace them;
- whole call: the same launch with the run's cost accounting (the
  profiler's event pair and counts), as ``slab_select`` calls it (CUDA
  events, no spin: the host's time a call paces the card);
- ``slab_select``: the edges and ``ext`` staged in one copy, the fold,
  the packed output read back in one copy and one wait (host clock,
  median).

Beside them: an empty kernel of the fold's block shape launched on the
same stream (``slab_fold_empty``, timed like the kernel alone: the
practical floor), and the bound: the bytes the fold must move (each
record read once, ``ext`` read and both flag arrays written once) over
3.35 TB/s against its operations (``kernels/costs.py``: every iteration
over every edge and position) over 67e12/s, the larger. One JSON line a
slab, then the card's name and power limit. Alone, it first splits the
whole call's host time at a slab of 4e's size (``whole_call_split``):
the C launch, ``run_launch`` with the accounting off and on, the
profiler's bracket, the upload, the readback and ``slab_select``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: the finch route's skani threshold, which the slab folds compare
SLAB_THR = 0.95


def random_slab(rng, w: int, n_edges: int, thr: float = SLAB_THR,
                ext_rate: float = 0.2):
    """(ei, ej, ev, ext) of a seeded slab of width w: `n_edges` edges
    i < j (i ascending, as the engine enqueues them), j within 64 of i,
    ANIs in [0.90, 0.99) with a tenth exactly at the threshold and a
    twentieth NaN, a fifth of the positions already clustered."""
    ei = np.sort(rng.integers(0, max(w - 1, 1), size=n_edges))
    ej = np.minimum(ei + rng.integers(1, 65, size=n_edges), w - 1)
    keep = ei < ej
    ei, ej = ei[keep], ej[keep]
    ev = rng.uniform(0.90, 0.99, size=ei.shape[0])
    pick = rng.random(ei.shape[0])
    ev[pick < 0.1] = thr
    ev[(pick >= 0.1) & (pick < 0.15)] = np.nan
    return (ei.astype(np.int32), ej.astype(np.int32), ev,
            rng.random(w) < ext_rate)


def chain_slab(w: int, positions=None):
    """A chain of passing edges: k -> k + 1 over a slab of w, or
    through `positions` (ascending) of a slab of w. One decision an
    iteration, so the fold takes as many iterations as the chain has
    positions."""
    pos = np.arange(w) if positions is None else np.asarray(positions)
    return (pos[:-1].astype(np.int32), pos[1:].astype(np.int32),
            np.full(len(pos) - 1, 0.97), np.zeros(w, dtype=bool))


def phase5_slabs(rng, thr: float = SLAB_THR):
    """label -> (ei, ej, ev, ext, thr, queue capacity) of the slabs
    timed at fixed shapes."""
    return {
        "the 16-window slab": (*random_slab(rng, 16384, 4096, thr), thr,
                               4096),
        "chain of 1,024": (*chain_slab(1024), thr, 1024),
        "chain of 4,096": (*chain_slab(4096), thr, 4096),
        "a cluster-tier slab": (*random_slab(rng, 65536, 4096, thr), thr,
                                4096),
    }


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _events_ms(torch, fn, reps: int, spin: bool) -> float:
    """CUDA-event ms a call of `fn` over `reps` calls after a warm one;
    `spin`: the calls queued behind a ~5 ms spin, so that the card's
    time alone is measured."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn, reps: int) -> float:
    """Median host-clock ms of `fn`, which ends synchronised with the
    card, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def empty_floor_ms(torch, reps: int = 50) -> float:
    """The launch of an empty kernel of the fold's block shape on the
    current stream, timed as the kernel alone is."""
    from galah_tpu_torch.kernels import build

    fn = build.load("slab_fold").slab_fold_empty
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        build.check("slab_fold_empty",
                    fn(torch.cuda.current_stream().cuda_stream))

    return _events_ms(torch, launch, reps, spin=True)


def bound(count: int, width: int, iters: int):
    """(ms, "bytes" or "operations") of the least time the H100 could
    take for the fold's work at these sizes."""
    from galah_tpu_torch.kernels import costs

    t_bytes = costs.slab_fold_bytes(count, width) / 3.35e12 * 1e3
    t_ops = costs.slab_fold_ops(iters, count, width) / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_slab(torch, device, slab, reps: int = 20, plain: bool = False,
              label: str = "") -> dict:
    """The chosen tier and the global-memory tier at one slab
    ``(ei, ej, ev, ext, thr[, capacity])``: parity of the chosen tier
    with the plain version, then kernel alone, whole call and
    slab_select of both, in turns; `plain` adds the plain version's
    host-clock time on CPU tensors."""
    from galah_tpu_torch.ops import megakernel as mk
    from galah_tpu_torch.ops.device_queue import PairQueue

    ei, ej, ev, ext, thr = slab[:5]
    w, n = len(ext), len(ei)
    cap = slab[5] if len(slab) > 5 else max(n, 1)
    qd, qs = PairQueue(cap, device), PairQueue(cap, device)
    qh = PairQueue(cap, "cpu")
    if qd.enqueue(ei, ej, ev, ext=ext) != n or qh.enqueue(ei, ej, ev) != n:
        raise RuntimeError(f"slab_fold {label}: the queue did not hold "
                           f"its {n} edges")
    ext_d, ext_h = qd.ext, torch.from_numpy(np.ascontiguousarray(ext))
    out = qd.workspace(mk.fold_bytes(w))
    chosen = mk.fold_plan(w, qd.cap)
    tiers = {"chosen": chosen, "global": mk.GLOBAL_TIER}
    rep, und, it = mk.slab_fold(qd.records, n, ext_d, thr, out=out)
    prep, pund, pit = mk.slab_fold_plain(qh.records, n, ext_h, thr, w)
    diff = int((rep.cpu() != prep).sum() + (und.cpu() != pund).sum())
    if diff or int(it) != int(pit):
        raise RuntimeError(f"slab_fold ({chosen.tier}) disagrees with its "
                           f"plain version at {label}: {diff} flags, "
                           f"{int(it)} against {int(pit)} iterations")
    iters = int(pit)
    times = {k: {"kernel_ms": [], "whole_ms": [], "select_ms": []}
             for k in tiers}
    for key in ("global", "chosen", "chosen", "global"):
        plan = tiers[key]
        with _env({"GALAH_OBS_PROFILE": "0"}):
            times[key]["kernel_ms"].append(_events_ms(
                torch, lambda: mk.run_launch(qd.records, n, ext_d, thr, w,
                                             out, plan), reps, spin=True))
        times[key]["whole_ms"].append(_events_ms(
            torch, lambda: mk.run_launch(qd.records, n, ext_d, thr, w, out,
                                         plan), reps, spin=False))
        times[key]["select_ms"].append(_host_ms(
            torch, lambda: mk.slab_select(qs, ei, ej, ev, ext, thr,
                                          plan=plan), max(reps // 2, 5)))
    b_ms, b_by = bound(n, w, iters)
    rec = {"slab": label, "width": w, "edges": n, "iterations": iters,
           "tier": chosen.tier, "smem_bytes": chosen.smem,
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": diff}
    for key, metrics in times.items():
        for metric, vals in metrics.items():
            rec[f"{metric}" if key == "chosen" else f"parent_{metric}"] = \
                float(np.mean(vals))
            rec[f"{metric}_runs" if key == "chosen"
                else f"parent_{metric}_runs"] = vals
    if plain:
        rec["plain_ms"] = _host_ms(torch, lambda: mk.slab_fold_plain(
            qh.records, n, ext_h, thr, w), 5)
    return rec


def describe(rec: dict) -> str:
    """One line of a time_slab record."""
    return (f"timing slab_fold at {rec['slab']}: width {rec['width']}, "
            f"{rec['edges']} edges, {rec['iterations']} iterations, tier "
            f"{rec['tier']}: kernel alone {rec['kernel_ms']:.4f} ms "
            f"(parent {rec['parent_kernel_ms']:.4f}), whole call "
            f"{rec['whole_ms']:.4f} ms (parent {rec['parent_whole_ms']:.4f})"
            f", slab_select {rec['select_ms']:.4f} ms (parent "
            f"{rec['parent_select_ms']:.4f}; host clock), bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")


def whole_call_split(torch, device, slab, reps: int = 500) -> dict:
    """Host microseconds a call (min of five runs of `reps`) of the
    pieces of the whole call at one slab: the C launch function alone,
    ``run_launch`` with the cost accounting off and on, the profiler's
    bracket (``PROFILE.launch``) around nothing, and ``slab_select``'s
    upload (``enqueue`` with ``ext``), readback (``read_back``) and the
    whole of it."""
    import struct

    from galah_tpu_torch.kernels import build
    from galah_tpu_torch.ops import megakernel as mk
    from galah_tpu_torch.ops.device_queue import PairQueue

    ei, ej, ev, ext, thr = slab[:5]
    w, n = len(ext), len(ei)
    q, qs = PairQueue(4096, device), PairQueue(4096, device)
    q.enqueue(ei, ej, ev, ext=ext)
    out = q.workspace(mk.fold_bytes(w))
    und_off, tail_off, nbytes = mk.packed_layout(w)
    plan = mk.fold_plan(w, q.cap)
    lib = build.load("slab_fold")
    thr_bits = struct.unpack("<q", struct.pack("<d", thr))[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (q.records.data_ptr(), n, q.ext.data_ptr(), w, thr_bits, w,
            plan.cluster, plan.per_block, plan.per_warp, out.data_ptr(),
            und_off, tail_off, out.data_ptr() + nbytes, stream)

    def bracket():
        with mk.PROFILE.launch(device, ("int64", n, w), lambda: (0, 0)):
            pass

    def upload():
        qs.enqueue(ei, ej, ev, ext=ext)
        qs.reset()

    def launch():
        mk.run_launch(q.records, n, q.ext, thr, w, out)

    pieces = {"C launch": lambda: lib.slab_fold_launch(*args),
              "profiler bracket": bracket,
              "upload": upload,
              "readback": lambda: q.read_back(out, nbytes),
              "slab_select": lambda: mk.slab_select(qs, ei, ej, ev, ext,
                                                    thr)}
    split = {}
    with _env({"GALAH_OBS_PROFILE": "0"}):
        pieces_off = {"run_launch, accounting off": launch}
        split.update(_host_us(torch, pieces_off, reps))
    split.update(_host_us(torch, {"run_launch, accounting on": launch},
                          reps))
    split.update(_host_us(torch, pieces, reps))
    return split


def _host_us(torch, pieces, reps):
    out = {}
    for name, fn in pieces.items():
        n = reps if name != "slab_select" else max(reps // 5, 20)
        fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / n * 1e6
            best = us if best is None else min(best, us)
        out[name] = best
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    floor = empty_floor_ms(torch)
    print(f"empty kernel launch: {floor:.4f} ms a launch")
    rng = np.random.default_rng(args.seed)
    # a slab of 4e's size (width 1,000, ~750 edges): the whole call's
    # host time, piece by piece
    split = whole_call_split(torch, device,
                             (*random_slab(rng, 1000, 750), SLAB_THR))
    print("whole call at a width-1,000 slab, host us a call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    for label, slab in phase5_slabs(rng).items():
        rec = time_slab(torch, device, slab, args.reps, label=label)
        rec["floor_ms"] = floor
        print(describe(rec))
        print(json.dumps(rec))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
