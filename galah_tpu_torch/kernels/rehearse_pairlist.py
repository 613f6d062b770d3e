"""Time ``pairlist.cu`` against variants of itself and an earlier
version on one NVIDIA GPU, at two pair lists of K = 1000 sketches.

    python -m galah_tpu_torch.kernels.rehearse_pairlist \\
        [--earlier ROOT] [--seed 0] [--reps 5]

Shapes (``sketch_size`` 1000, biased int64 rows made from the seed):

- ``finch``: 1,024 rows in 256 planted families of 4 and the 1,536
  within-family pairs, sorted by (pi, pj): the survivors of the finch
  1024 run's collision screen;
- ``dense``: 2,048 rows of one planted family (``family_rows``: each a
  base of 1,000 hashes with each value replaced by a fresh one with
  probability 1 - 0.99^21, about 98% ANI; every 16th row truncated to
  200-999 values) and all 2,096,128 pairs i < j in row-major order,
  the collision screen's order: the "many closely related genomes"
  case, where nothing screens out.

Variants, each built from source with ``build.NVCC_FLAGS``:

- ``committed``: ``pairlist.cu`` and ``merge_walk.cuh`` as they stand;
- ``in-place``: nothing staged, both rows of every pair read in place;
- ``eight-warps``: 8 pairs a block instead of 6;
- ``one-level``: the lane whose segment straddles the union rank
  `total` walks its whole segment again alone, instead of having it
  split across the warp once more (``merge_walk.cuh``'s kLevels);
- ``earlier``: ``ROOT/galah_tpu_torch/kernels/pairlist.cu`` of an
  earlier checkout (for example the parent commit unpacked by ``git
  archive``). Its launch function may have today's C signature or the
  one without valid lengths ``(mat, k, pi, pj, b, sketch_size, common,
  total, stream)``; an adapter calls either.

Each variant must equal the plain version (``pair_stats_pairs_plain``,
on the card, 65,536 pairs a call) on both shapes at sketch_size 1000
and 333. Times, CUDA events over ``--reps`` launches (more at the finch
list), twice: the kernel alone, one launch over the whole list. Then
the whole pass (``ops/sparse_device.pair_stats_for_pairs``, host numpy in
and out, host clock), this tree's in this process and, with
``--earlier``, the earlier tree's in a child process run from ROOT.
One JSON line a (variant, shape) and a (pass, shape); then, for the
committed source, the instructions of the staged kernel's walk loop
(one shared load a merged item) by opcode, from ``cuobjdump -sass``;
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from galah_tpu_torch.kernels import costs

_HERE = os.path.dirname(os.path.abspath(__file__))

K = 1000
SKETCH_SIZES = (1000, 333)
PLAIN_CHUNK = 1 << 16
SUBSTITUTED = 1.0 - 0.99 ** 21  # a member 1% substituted, per k=21 hash
SENTINEL = np.iinfo(np.int64).max

STAGE_LIMIT = "constexpr int kMaxStagedK = 1536;"
WARPS = "constexpr int kWarps = 6;"
LEVELS = "constexpr int kLevels = 2;"


def _hashes(rng: np.random.Generator, n: int) -> np.ndarray:
    # biased int64 hashes, never the sentinel
    return rng.integers(-(1 << 63), SENTINEL, size=n, dtype=np.int64)


def family_rows(rng: np.random.Generator, n: int, k: int = K,
                short_every: int = 0) -> np.ndarray:
    """(n, k) sorted, sentinel-padded rows of one planted family: a base
    of k hashes, each value of a row replaced by a fresh hash with
    probability SUBSTITUTED, the row kept to its distinct values; with
    short_every, every short_every-th row truncated to 200-999 values."""
    base = _hashes(rng, k)
    mat = np.full((n, k), SENTINEL, dtype=np.int64)
    for i in range(n):
        row = base.copy()
        swap = rng.random(k) < SUBSTITUTED
        row[swap] = _hashes(rng, int(swap.sum()))
        row = np.unique(row)
        if short_every and i % short_every == short_every - 1:
            row = row[:int(rng.integers(200, 1000))]
        mat[i, :row.shape[0]] = row
    return mat


def dense_list(rng: np.random.Generator, n: int = 2048):
    """(mat, pi, pj): one family of n rows, every 16th short, and all
    pairs i < j in row-major order."""
    mat = family_rows(rng, n, short_every=16)
    pi, pj = np.triu_indices(n, 1)
    return mat, pi.astype(np.int64), pj.astype(np.int64)


def finch_list(rng: np.random.Generator, families: int = 256,
               family: int = 4):
    """(mat, pi, pj): families of full rows and their within-family
    pairs, sorted by (pi, pj)."""
    mat = np.concatenate([family_rows(rng, family)
                          for _ in range(families)])
    a, b = np.triu_indices(family, 1)
    base = np.arange(families, dtype=np.int64)[:, None] * family
    return mat, (base + a).reshape(-1), (base + b).reshape(-1)


#: 32-bit operations a merged item (``kernels/costs.py``)
OPS_PER_ITEM = costs.PAIRLIST_OPS_PER_ITEM


def work(pi: np.ndarray, pj: np.ndarray, k: int, common: np.ndarray,
         total: np.ndarray):
    """(bytes, 32-bit operations) of a pair list and its results
    (``kernels/costs.pairlist_bytes`` and ``pairlist_ops``): each row
    that a pair uses read once and 24 bytes a pair in and out;
    OPS_PER_ITEM operations (two to order two int64 values, low words
    unsigned, then high words with the carry, and one to step the row
    whose value merged) for each item that a merge of the two rows
    takes to emit the union's first `total` values, total + common a
    pair (a common value takes one item of each row). The co-rank
    searches that split a merge across a warp's lanes are the kernel's
    cost, not the function's, and are not counted."""
    rows = np.union1d(pi, pj).shape[0]
    items = (np.asarray(common, dtype=np.float64).sum()
             + np.asarray(total, dtype=np.float64).sum())
    return (costs.pairlist_bytes(rows, pi.shape[0], k),
            costs.pairlist_ops(float(items)))


def _variants(earlier):
    """name -> (source, {header: text})"""
    with open(os.path.join(_HERE, "pairlist.cu")) as fh:
        src = fh.read()
    headers = {}
    for f in sorted(os.listdir(_HERE)):
        if f.endswith(".cuh"):
            with open(os.path.join(_HERE, f)) as fh:
                headers[f] = fh.read()
    walk = headers["merge_walk.cuh"]
    if (src.count(STAGE_LIMIT) != 1 or src.count(WARPS) != 1
            or walk.count(LEVELS) != 1):
        raise RuntimeError("pairlist.cu or merge_walk.cuh no longer holds "
                           "the lines this rehearsal substitutes")
    out = {
        "committed": (src, headers),
        "in-place": (src.replace(STAGE_LIMIT,
                                 "constexpr int kMaxStagedK = -1;"),
                     headers),
        "eight-warps": (src.replace(WARPS, "constexpr int kWarps = 8;"),
                        headers),
        "one-level": (src, {**headers, "merge_walk.cuh": walk.replace(
            LEVELS, "constexpr int kLevels = 1;")}),
    }
    if earlier:
        d = os.path.join(earlier, "galah_tpu_torch", "kernels")
        with open(os.path.join(d, "pairlist.cu")) as fh:
            esrc = fh.read()
        eh = {}
        for f in os.listdir(d):
            if f.endswith(".cuh"):
                with open(os.path.join(d, f)) as fh:
                    eh[f] = fh.read()
        out["earlier"] = (esrc, eh)
    return out


def n_params(src: str) -> int:
    m = re.search(r'extern "C" int pairlist_launch\(([^)]*)\)', src)
    if m is None:
        raise RuntimeError("no pairlist_launch in the source")
    return m.group(1).count(",") + 1


def _build(variants, work_dir):
    """Compile every variant at once; name -> (ctypes function, number
    of C parameters)."""
    from galah_tpu_torch.kernels import build

    procs = {}
    for name, (src, headers) in variants.items():
        d = os.path.join(work_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in headers.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        with open(os.path.join(d, "pairlist.cu"), "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "pairlist.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log.decode()}")
        n = n_params(variants[name][0])
        fn = ctypes.CDLL(os.path.join(work_dir, name, "lib.so")
                         ).pairlist_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P, I, P, P, P, I, I, P, P, P] if n == 10
                       else [P, I, P, P, I, I, P, P, P])
        fn.restype = ctypes.c_int
        fns[name] = (fn, n)
    return fns


def launcher(torch, fn, n, mat, lens, pi, pj, sketch_size, common, total):
    """A call that launches `fn` once over the whole list, through
    either C signature."""
    stream = torch.cuda.current_stream().cuda_stream
    k, b = mat.shape[1], pi.shape[0]
    if n == 10:
        args = (mat.data_ptr(), k, lens.data_ptr(), pi.data_ptr(),
                pj.data_ptr(), b, sketch_size, common.data_ptr(),
                total.data_ptr(), stream)
    else:
        args = (mat.data_ptr(), k, pi.data_ptr(), pj.data_ptr(), b,
                sketch_size, common.data_ptr(), total.data_ptr(), stream)

    def run():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"pairlist launch: cudaError_t {err}")
    return run


def walk_loop(sass: str, kernel: str = "pairlist_kernelILb1E"):
    """(instructions, shared loads, opcode counts) of the staged
    kernel's walk loop in ``cuobjdump -sass`` output: among the loop
    bodies (a branch back to an earlier address) of that kernel with
    neither a shuffle nor a cp.async, the one with the most shared
    loads that also has at least two selects a load (the diagonal
    search has one select for two loads)."""
    body = sass.split(kernel, 1)[1].split("Function :", 1)[0]
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    best = None
    for i, (a, text) in enumerate(ins):
        m = re.search(r"BRA\s.*?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > a or int(m.group(1), 16) not in at:
            continue
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
            for _, t in ins[at[int(m.group(1), 16)]:i + 1])
        lds = ops["LDS"]
        if (lds and not ops["SHFL"] and not ops["LDGSTS"]
                and ops["SEL"] >= 2 * lds
                and (best is None or lds > best[1])):
            best = (sum(ops.values()), lds, dict(ops.most_common()))
    if best is None:
        raise RuntimeError(f"no walk loop found in {kernel}")
    return best


def _time_ms(torch, fn, reps):
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


def pass_ms(torch, pass_fn, reps):
    """Host-clock ms of whole passes, after one warm pass."""
    pass_fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pass_fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


# run from an earlier checkout's root: its own pass over a saved list
EARLIER_PASS = """
import json, sys, time
import numpy as np, torch
from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs
data = np.load(sys.argv[1])
mat = torch.from_numpy(data["mat"]).cuda()
pi, pj, s = data["pi"], data["pj"], int(sys.argv[2])
c, t = pair_stats_for_pairs(mat, pi, pj, s)
ms = []
for _ in range(int(sys.argv[3])):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair_stats_for_pairs(mat, pi, pj, s)
    ms.append((time.perf_counter() - t0) * 1e3)
np.savez(sys.argv[4], common=c, total=t)
print(json.dumps({"ms": ms}))
"""


def earlier_pass(root, work_dir, name, mat, pi, pj, sketch_size, reps):
    """(ms list, common, total) of the earlier tree's own pass."""
    data = os.path.join(work_dir, f"{name}.npz")
    res = os.path.join(work_dir, f"{name}-out.npz")
    np.savez(data, mat=mat, pi=pi, pj=pj)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
    proc = subprocess.run(
        [sys.executable, "-c", EARLIER_PASS, data, str(sketch_size),
         str(reps), res], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"earlier pass failed:\n{proc.stderr[-3000:]}")
    out = np.load(res)
    return json.loads(proc.stdout.strip().splitlines()[-1])["ms"], \
        out["common"], out["total"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", default=None,
                    help="root of an earlier checkout of the repository")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from galah_tpu_torch.kernels.build import BUILD_DIR
    from galah_tpu_torch.ops.pairlist import (pair_stats_pairs_plain,
                                              valid_lengths)
    from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs

    if not torch.cuda.is_available():
        print("rehearse_pairlist: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    work_dir = os.path.join(BUILD_DIR, "rehearse_pairlist")
    fns = _build(_variants(args.earlier), work_dir)
    rng = np.random.default_rng(args.seed)
    shapes = {"finch": finch_list(rng), "dense": dense_list(rng)}
    ok = True
    for shape, (m_np, pi_np, pj_np) in shapes.items():
        mat = torch.from_numpy(m_np).to(dev)
        pi = torch.from_numpy(pi_np).to(dev)
        pj = torch.from_numpy(pj_np).to(dev)
        lens = valid_lengths(mat)
        b = pi_np.shape[0]
        reps = args.reps * (50 if shape == "finch" else 1)
        wants = {}
        for s in SKETCH_SIZES:
            parts = [pair_stats_pairs_plain(mat, pi[i:i + PLAIN_CHUNK],
                                            pj[i:i + PLAIN_CHUNK], s)
                     for i in range(0, b, PLAIN_CHUNK)]
            wants[s] = (torch.cat([c for c, _ in parts]),
                        torch.cat([t for _, t in parts]))
        common = torch.empty(b, dtype=torch.int32, device=dev)
        total = torch.empty_like(common)
        for name, (fn, n) in fns.items():
            exact = {}
            for s in SKETCH_SIZES:
                launcher(torch, fn, n, mat, lens, pi, pj, s, common,
                         total)()
                torch.cuda.synchronize()
                exact[s] = bool(torch.equal(common, wants[s][0])
                                and torch.equal(total, wants[s][1]))
                ok &= exact[s]
            run = launcher(torch, fn, n, mat, lens, pi, pj, K, common, total)
            rec = {"variant": name, "shape": shape, "pairs": b,
                   "rows": m_np.shape[0], "k": K, "exact": exact,
                   "ms": [_time_ms(torch, run, reps) for _ in range(2)]}
            print(json.dumps(rec), flush=True)
        c_np, t_np = pair_stats_for_pairs(mat, pi_np, pj_np, K)
        good = bool(np.array_equal(c_np, wants[K][0].cpu().numpy())
                    and np.array_equal(t_np, wants[K][1].cpu().numpy()))
        ok &= good
        print(json.dumps({
            "pass": "committed", "shape": shape, "pairs": b, "exact": good,
            "ms": pass_ms(torch, lambda: pair_stats_for_pairs(
                mat, pi_np, pj_np, K), max(reps // 5, 3))}), flush=True)
        if args.earlier:
            ms, ec, et = earlier_pass(args.earlier, work_dir, shape, m_np,
                                      pi_np, pj_np, K, max(reps // 5, 3))
            good = bool(np.array_equal(ec, c_np) and np.array_equal(et, t_np))
            ok &= good
            print(json.dumps({"pass": "earlier", "shape": shape, "pairs": b,
                              "exact": good, "ms": ms}), flush=True)
        del mat, pi, pj, lens, wants, common, total
    from galah_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", os.path.join(work_dir, "committed", "lib.so")],
        capture_output=True, text=True, check=True, timeout=120).stdout
    n, lds, ops = walk_loop(sass)
    print(json.dumps({"variant": "committed", "walk_loop_instructions": n,
                      "shared_loads": lds, "instructions_a_step": n / lds,
                      "opcodes": ops}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
