"""Time ``tile_stats.cu``'s intersect form against variants of its source
on one NVIDIA GPU, at the marker screen's row block (64 x 512 pairs).

    python -m galah_tpu_torch.kernels.rehearse_tile_stats \\
        [--earlier DIR] [--k 2176 6080 10048] [--seed 0]

The widths K are the screen's for corpora whose largest genome is about
2, 6 and 10 Mbp (one marker a kb, rounded up to a multiple of 64).
Variants, each built from source with ``build.NVCC_FLAGS``:

- ``committed``: ``tile_stats.cu`` as it stands;
- ``small-tiles``: the same with smaller staged tiles (2 x 8, 2 x 4,
  1 x 4, 1 x 2, 1 x 1) after 4 x 8 in its tile table, so a wider K is
  staged in fewer sketches rather than read in place;
- ``in-place``: the same with staging off, every K read in place;
- ``earlier``: ``DIR/tile_stats.cu`` (with DIR's headers), an earlier
  version with the same C signature, for example the parent commit's
  ``galah_tpu_torch/kernels`` unpacked by ``git archive``.

Each variant must equal the plain version (``tile_intersect_plain``) at
every K. It is timed with CUDA events (20 launches, twice) on rows whose
valid counts lie in [0.97 K, K], and once on all-sentinel rows of the
same shape, where no pair has an item to merge: the difference is the
time of the merge walks. One JSON line a (variant, K), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

TABLE = "constexpr int kTiles[][2] = {{4, 8}};"
SMALL_TILES = ("constexpr int kTiles[][2] = {{4, 8}, {2, 8}, {2, 4}, "
               "{1, 4}, {1, 2}, {1, 1}};")
STAGE_TEST = "if (bytes <= g_max_smem) {"
NO_STAGE = "if (false) {"


def stripe(k: int, rng: np.random.Generator, br: int = 64, bc: int = 512):
    """(rows, cols) int64 numpy: sorted biased hashes, valid counts in
    [0.97 K, K] and sentinel padding, drawn in families of 4 from shared
    pools so that pairs in a family overlap."""
    sentinel = np.iinfo(np.int64).max
    pools = [np.unique(rng.integers(-(1 << 62), 1 << 62, size=2 * k))
             for _ in range(bc // 4 + 1)]
    m = np.full((bc, k), sentinel, dtype=np.int64)
    for i in range(bc):
        cnt = int(rng.integers(int(0.97 * k), k + 1))
        m[i, :cnt] = np.sort(rng.choice(pools[i // 4], size=cnt,
                                        replace=False))
    return np.ascontiguousarray(m[:br]), m


def _variants(earlier):
    with open(os.path.join(_HERE, "tile_stats.cu")) as fh:
        src = fh.read()
    if TABLE not in src or src.count(STAGE_TEST) != 1:
        raise RuntimeError("tile_stats.cu no longer holds the lines this "
                           "rehearsal substitutes")
    out = {"committed": (_HERE, src),
           "small-tiles": (_HERE, src.replace(TABLE, SMALL_TILES)),
           "in-place": (_HERE, src.replace(STAGE_TEST, NO_STAGE))}
    if earlier:
        with open(os.path.join(earlier, "tile_stats.cu")) as fh:
            out["earlier"] = (earlier, fh.read())
    return out


def _build(variants, work):
    """Compile every variant at once; name -> ctypes launch function."""
    from galah_tpu_torch.kernels import build

    procs = {}
    for name, (inc, src) in variants.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(inc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(inc, f), d)
        with open(os.path.join(d, "tile_stats.cu"), "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "tile_stats.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log.decode()}")
        fn_name, argtypes = build.SIGNATURES["tile_stats"]
        fn = getattr(ctypes.CDLL(os.path.join(work, name, "lib.so")),
                     fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _time_ms(torch, fn, reps=20):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", default=None,
                    help="directory holding an earlier tile_stats.cu")
    ap.add_argument("--k", type=int, nargs="+", default=[2176, 6080, 10048])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from galah_tpu_torch.kernels.build import BUILD_DIR
    from galah_tpu_torch.ops.tile_stats import tile_intersect_plain

    if not torch.cuda.is_available():
        print("rehearse_tile_stats: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fns = _build(_variants(args.earlier),
                 os.path.join(BUILD_DIR, "rehearse_tile_stats"))
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for k in args.k:
        r_np, c_np = stripe(k, rng)
        rows = torch.from_numpy(r_np).to(dev)
        cols = torch.from_numpy(c_np).to(dev)
        empty_r = torch.full_like(rows, np.iinfo(np.int64).max)
        empty_c = torch.full_like(cols, np.iinfo(np.int64).max)
        want = tile_intersect_plain(rows, cols)
        common = torch.empty(rows.shape[0], cols.shape[0], dtype=torch.int32,
                             device=dev)
        total = torch.empty_like(common)
        na = (r_np != np.iinfo(np.int64).max).sum(axis=1)
        nb = (c_np != np.iinfo(np.int64).max).sum(axis=1)
        items = int((na[:, None] + nb[None, :]).sum())
        for name, fn in fns.items():
            def launch(a, b):
                err = fn(a.data_ptr(), b.data_ptr(), a.shape[0], b.shape[0],
                         k, k, 1, common.data_ptr(), total.data_ptr(),
                         stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            launch(rows, cols)
            torch.cuda.synchronize()
            exact = bool(torch.equal(common, want))
            ok &= exact
            full = [_time_ms(torch, lambda: launch(rows, cols))
                    for _ in range(2)]
            empty = _time_ms(torch, lambda: launch(empty_r, empty_c))
            print(json.dumps({
                "variant": name, "k": k, "pairs": [rows.shape[0],
                                                   cols.shape[0]],
                "exact": exact, "ms": full, "empty_rows_ms": empty,
                "merged_items": items,
                "items_per_ns": items / (min(full) * 1e6)}), flush=True)
        del rows, cols, empty_r, empty_c, want
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
