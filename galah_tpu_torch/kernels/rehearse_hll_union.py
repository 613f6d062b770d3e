"""Time ``hll_union.cu`` against an earlier version of it on one NVIDIA
GPU, at the shapes of the dashing pair pass over 1,024 genomes and at
the widest row block of an 8,192-genome corpus.

    python -m galah_tpu_torch.kernels.rehearse_hll_union \\
        [--earlier DIR] [--seed 0] [--reps 20]

Variants, each built from source with ``build.NVCC_FLAGS``:

- ``committed``: ``hll_union.cu`` as it stands, launched as
  ``ops/hll_union.plan_launch`` plans (register axis split into slices);
- ``unsplit``: the same library launched with one slice (chunk = all
  words), which isolates the split from the rest of the design;
- ``earlier``: ``DIR/hll_union.cu``, for example the parent commit's
  ``galah_tpu_torch/kernels`` unpacked by ``git archive``. Its launch
  function may have today's C signature or the unsplit one
  ``(rows, cols, br, bc, m, powsum, zeros, stream)``; an adapter calls
  either.

Registers (m = 4096) are drawn as HLL registers of a ~2 Mbp genome
fall (``hll_registers``: the max of ~500 geometric ranks a register,
at most 30), and, for a second parity case, uniform in [0, 53] with an
all-zero row and column. Each variant must equal the plain version
(``hll_union_stats_plain``) on the card: zeros exact, powsum bit for
bit at registers <= 41 and within one f32 ulp beyond. Times: CUDA
events, ``--reps`` launches, twice, with outputs and scratch allocated
beforehand, at the pass's four launch shapes
(64 x 1024, 768, 512, 256 pairs), the whole pass (its 16 launches in
order, ``ops/hll.py``'s row blocks against ``mat[c0:]``), and 64 x 8192
pairs. One JSON line a (variant, case); then, for the committed
source, the instructions of the main kernel's inner loop (one column
word against the block's rows) by opcode, from ``cuobjdump -sass``;
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

M = 4096
N_PASS = 1024
N_WIDE = 8192
ROW_TILE = 64
COL_TILE = 256


def hll_registers(rng: np.random.Generator, n: int, m: int = M,
                  per_register: float = 500.0, cap: int = 30) -> np.ndarray:
    """(n, m) uint8 registers as HLL registers fall for ~per_register
    distinct hashes a register: P(reg <= k) = (1 - 2^-k)^per_register,
    drawn by inverting that law, clipped to [1, cap]."""
    u = rng.random((n, m))
    k = np.ceil(-np.log2(-np.expm1(np.log(u) / per_register)))
    return np.clip(k, 1, cap).astype(np.uint8)


def uniform_registers(rng: np.random.Generator, n: int, hi: int,
                      m: int = M) -> np.ndarray:
    """(n, m) uint8 uniform in [0, hi], row 0 all zero, row 1 all hi."""
    regs = rng.integers(0, hi + 1, size=(n, m)).astype(np.uint8)
    regs[0] = 0
    regs[1] = hi
    return regs


def pass_launches(n: int = N_PASS):
    """(r0, c0) of each launch of the pair pass over n padded rows."""
    return [(r0, (r0 // COL_TILE) * COL_TILE)
            for r0 in range(0, n, ROW_TILE)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", default=None,
                    help="directory holding an earlier hll_union.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    return ap.parse_args(argv)


def _n_params(src: str) -> int:
    m = re.search(r'extern "C" int hll_union_launch\(([^)]*)\)', src)
    if m is None:
        raise RuntimeError("no hll_union_launch in the source")
    return m.group(1).count(",") + 1


def _build(variants, work):
    """Compile every source at once; name -> (ctypes function, number
    of C parameters)."""
    from galah_tpu_torch.kernels import build

    procs = {}
    for name, src in variants.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "hll_union.cu"), "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "hll_union.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log.decode()}")
        n = _n_params(variants[name])
        fn = ctypes.CDLL(os.path.join(work, name, "lib.so")).hll_union_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P, P, I, I, I, I, P, P, P, P, P] if n == 11
                       else [P, P, I, I, I, P, P, P])
        fn.restype = ctypes.c_int
        fns[name] = (fn, n)
    return fns


def loop_opcodes(sass: str, kernel: str = "hll_union_kernel"):
    """(body length, opcode counts) of the shortest loop body that adds
    doubles (DADD), between a backward branch and its target, of
    `kernel` in cuobjdump's SASS: the kernel's inner loop."""
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"([^;]*);")
    best = []
    for func in sass.split("Function : ")[1:]:
        if kernel not in func.splitlines()[0]:
            continue
        code = [(int(a, 16), op, rest) for a, op, rest in ins.findall(func)]
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in code
                        if int(target.group(1), 16) <= a <= addr]
                if "DADD" in body and (not best or len(body) < len(best)):
                    best = body
    return len(best), dict(collections.Counter(best).most_common())


def _launcher(torch, fn, n_params, split):
    """prepare(rows, cols) -> launch() for one variant: outputs and
    scratch allocated once (``ops/hll_union.prepare_launch``), so that
    a timed launch is the C call alone; launch() returns (powsum,
    zeros). `split` False launches one slice."""
    from galah_tpu_torch.ops import hll_union as hu

    def prepare(rows, cols):
        prepared = hu.prepare_launch(rows, cols)
        if not split:
            words = rows.shape[1] // 16
            prepared = prepared._replace(
                plan=hu.LaunchPlan(1, words, prepared.plan.blocks
                                   // prepared.plan.slices),
                scratch=None)
        args = hu.launch_args(prepared)
        if n_params == 8:  # (rows, cols, br, bc, m, powsum, zeros, stream)
            args = args[:5] + args[8:]

        def launch():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"hll_union launch: cudaError_t {err}")
            return prepared.powsum, prepared.zeros

        return launch

    return prepare


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


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from galah_tpu_torch.kernels.build import BUILD_DIR
    from galah_tpu_torch.ops.hll_union import (hll_union_stats_plain,
                                               plan_launch)

    if not torch.cuda.is_available():
        print("rehearse_hll_union: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with open(os.path.join(_HERE, "hll_union.cu")) as fh:
        sources = {"committed": fh.read()}
    if args.earlier:
        with open(os.path.join(args.earlier, "hll_union.cu")) as fh:
            sources["earlier"] = fh.read()
    work = os.path.join(BUILD_DIR, "rehearse_hll_union")
    fns = _build(sources, work)
    launchers = {"committed": _launcher(torch, *fns["committed"], True),
                 "unsplit": _launcher(torch, *fns["committed"], False)}
    if "earlier" in fns:
        launchers["earlier"] = _launcher(torch, *fns["earlier"], True)

    rng = np.random.default_rng(args.seed)
    cases = {"hll<=30": torch.from_numpy(hll_registers(rng, N_WIDE)),
             "uniform<=53": torch.from_numpy(
                 uniform_registers(rng, N_PASS, 53))}
    ok = True
    for case, regs in cases.items():
        wide = regs.to(dev)
        mat = wide[:N_PASS]
        hi = int(regs.max())
        shapes = [(mat[r0:r0 + ROW_TILE], mat[c0:])
                  for r0, c0 in pass_launches()[::4]]
        if case.startswith("hll"):
            shapes.append((wide[:ROW_TILE], wide))
        wants = [hll_union_stats_plain(r, c) for r, c in shapes]
        for name, prepare in launchers.items():
            rec = {"variant": name, "case": case, "registers_max": hi,
                   "m": M, "shapes": []}
            for (rows, cols), (wp, wz) in zip(shapes, wants):
                run = prepare(rows, cols)
                ps, z = run()
                torch.cuda.synchronize()
                ulps = int((ps.view(torch.int32) - wp.view(torch.int32))
                           .abs().max())
                good = bool(torch.equal(z, wz)) and ulps <= (
                    0 if hi <= 41 else 1)
                ok &= good
                shape = {"pairs": [rows.shape[0], cols.shape[0]],
                         "ok": good, "ulps": ulps}
                if name != "earlier" or fns["earlier"][1] == 11:
                    plan = plan_launch(rows.shape[0], cols.shape[0], M)
                    shape["slices"] = plan.slices if name != "unsplit" else 1
                if case.startswith("hll"):
                    shape["ms"] = [_time_ms(torch, run, args.reps)
                                   for _ in range(2)]
                rec["shapes"].append(shape)
            if case.startswith("hll"):
                blocks = [prepare(mat[r0:r0 + ROW_TILE], mat[c0:])
                          for r0, c0 in pass_launches()]

                def run_pass():
                    for run_block in blocks:
                        run_block()

                rec["pass_ms"] = [_time_ms(torch, run_pass,
                                           max(args.reps // 4, 1))
                                  for _ in range(2)]
                rec["pass_sum_of_shapes_ms"] = 4 * sum(
                    min(s["ms"]) for s in rec["shapes"][:4])
            print(json.dumps(rec), flush=True)
        del wide, mat, shapes, wants
    from galah_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", os.path.join(work, "committed", "lib.so")],
        capture_output=True, text=True, check=True, timeout=120).stdout
    n, ops = loop_opcodes(sass)
    print(json.dumps({"variant": "committed", "inner_loop_instructions": n,
                      "opcodes": ops}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
