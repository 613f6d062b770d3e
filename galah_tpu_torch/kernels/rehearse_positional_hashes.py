"""Time ``positional_hashes.cu`` against variants of its source and an
earlier version on one NVIDIA GPU, at a profile group of 8 x 2 Mbp.

    python -m galah_tpu_torch.kernels.rehearse_positional_hashes \\
        [--earlier DIR] [--seed 0] [--genomes 8] \\
        [--genome-length 2000000] [--reps 20]

The group is ``rehearse_profiles.make_group``'s from the seed (random
bases, 5-50 kb contigs, a few N runs), the first profile group of
chip_smoke.py's skani 512 run by its size. Variants, each built from
source with ``build.NVCC_FLAGS`` and ``-Xptxas -v``:

- ``committed``: ``positional_hashes.cu`` as it stands;
- one-line variants of it (``EDITS``): 4096 or 16384 windows a tile,
  the key bytes by byte permutes of each window's codes spread to
  nibble selectors instead of the 256-word table in shared memory, the window loop unrolled twice, 512
  threads a block;
- ``earlier``: ``DIR/positional_hashes.cu`` (with DIR's headers), an
  earlier version with the same range entry, for example the parent
  commit's ``galah_tpu_torch/kernels`` unpacked by ``git archive``
  (``--earlier`` again for more: ``earlier-2``, ...).

Each variant's range entry (all the group's windows into one tensor)
must equal the plain version (``positional_hashes_plain``) for murmur3
and tpufast, and each variant with a group entry its plain version
(``group_hashes_plain``) at c = 1 and 125. Then, with CUDA events, in
turns (the variants in order, then in reverse, ``--reps`` launches a
turn): the kernel alone, through the range entry and the group entry
(its table made once), for both hashes; the group's hash pass at c = 1
and 125, as the earlier route (a range launch, a clone a genome and the
cut's ``torch.where``) and as the group entry's whole call (outputs,
table and launch). One JSON line a variant with its ptxas report
and, for the committed source, the SASS of each instance's window loop
counted from ``cuobjdump -sass`` (the innermost loop that stores to
device memory, a window an 8-byte store, two a 16-byte one):
instructions a window by pipe, and the bound they give at the card's
issue rates. The yardstick: ``fill_`` of the group's output (8 bytes a
window), the card's rate for a pure write of that size. Then the card's name, power limit
and maximum SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

TILE_LINE = "constexpr int kTile = 8192;  // windows a tile"
# one-line variants of the committed source: name -> (line, replacement)
EDITS = {
    "tile-4096": (TILE_LINE, "constexpr int kTile = 4096;"),
    "tile-16384": (TILE_LINE, "constexpr int kTile = 16384;"),
    "ascii-prmt": (
        "  const u64 k1 = ascii[lsb & 0xFFu] |\n"
        "                 static_cast<u64>(ascii[(lsb >> 8) & 0xFFu]) << 32;\n"
        "  const u64 k2 = ascii[(lsb >> 16) & 0xFFu] |\n"
        "                 static_cast<u64>(ascii[lsb >> 24] & 0x00FFFFFFu)"
        " << 32;\n",
        "  const unsigned s1 = nibbles8(lsb & 0xFFFFu);\n"
        "  const unsigned s2 = nibbles8(lsb >> 16) | 0x40000000u;\n"
        "  const u64 k1 = __byte_perm(0x54474341u, 0u, s1) |\n"
        "      static_cast<u64>(__byte_perm(0x54474341u, 0u, s1 >> 16)) << 32;\n"
        "  const u64 k2 = __byte_perm(0x54474341u, 0u, s2) |\n"
        "      static_cast<u64>(__byte_perm(0x54474341u, 0u, s2 >> 16)) << 32;\n"),
    "unroll-2": ("#pragma unroll 1", "#pragma unroll 2"),
    "threads-512": ("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;"),
}
PEAK_BYTES_PER_S = 3.35e12
K = 15
CUTS = (1, 125)
# thread-instructions a clock an SM (four schedulers of 32 lanes) and
# the pipes' lanes a clock an SM on sm_90: integer ALU 64, IMAD (the
# FMA-heavy datapath) 64, shared-memory loads and stores 32
ISSUE_LANES = 128
PIPE_LANES = {"alu": 64, "fma": 64, "shared": 32}


def _variants(earlier):
    with open(os.path.join(_HERE, "positional_hashes.cu")) as fh:
        src = fh.read()
    out = {"committed": (_HERE, src)}
    for name, (line, repl) in EDITS.items():
        if src.count(line) != 1:
            raise RuntimeError(f"positional_hashes.cu no longer holds the "
                               f"line variant {name} substitutes")
        out[name] = (_HERE, src.replace(line, repl))
    for i, d in enumerate(earlier or ()):
        with open(os.path.join(d, "positional_hashes.cu")) as fh:
            out["earlier" if i == 0 else f"earlier-{i + 1}"] = (d, fh.read())
    return out


def _build(variants, work):
    """Compile every variant at once; name -> (library, ptxas report,
    library path)."""
    from galah_tpu_torch.kernels import build

    procs = {}
    for name, (inc, src) in variants.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(inc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(inc, f), d)
        with open(os.path.join(d, "positional_hashes.cu"), "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"),
             os.path.join(d, "positional_hashes.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        path = os.path.join(work, name, "lib.so")
        lib = ctypes.CDLL(path)
        sigs = [build.SIGNATURES["positional_hashes"]]
        if hasattr(lib, "positional_hashes_group_launch"):
            sigs += build.MORE_SIGNATURES["positional_hashes"]
        for fn_name, argtypes in sigs:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line
                 or "Compiling entry" in line]
        libs[name] = (lib, ptxas, path)
    return libs


def _pipe(op: str) -> str:
    """The sm_90 pipe of a SASS opcode, as this count books it."""
    base = op.split(".")[0]
    if base in ("IMAD", "IMUL", "HFMA2"):
        return "fma"
    if base in ("LDS", "STS", "ATOMS"):
        return "shared"
    if base in ("LDG", "STG", "LD", "ST", "LDGSTS", "RED", "ATOMG"):
        return "global"
    if base in ("BRA", "BSSY", "BSYNC", "EXIT", "BAR", "WARPSYNC", "RET",
                "CALL", "YIELD", "DEPBAR", "NOP", "BMOV"):
        return "control"
    return "alu"


def sass_window_loops(lib_path: str):
    """Per kernel instance, the innermost loop of its SASS that stores
    to device memory: its instructions a store (a window), by opcode
    and by pipe."""
    from galah_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        instance = "tpufast" if "ILb1E" in name else "murmur3"
        insts, labels, pending = [], {}, []
        for line in chunk.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            body = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            insts.append((addr, body))
        loops = []
        for addr, body in insts:
            if not body.startswith("BRA"):
                continue
            tgt = re.search(r"0x([0-9a-f]+)|`\((\.L_x_\d+)\)", body)
            if tgt is None:
                continue
            to = (int(tgt.group(1), 16) if tgt.group(1)
                  else labels.get(tgt.group(2)))
            if to is None or to >= addr:
                continue
            span = [b for a, b in insts if to <= a <= addr]
            # windows stored: two a 16-byte store
            stores = sum(2 if ".128" in b.split()[0] else 1
                         for b in span if b.startswith("STG"))
            if stores:
                loops.append((to, addr, span, stores))
        # the innermost store loops (an unrolled body and its remainder);
        # the one with the most stores is the one most windows run
        inner = [lp for lp in loops if not any(
            o[:2] != lp[:2] and lp[0] <= o[0] and o[1] <= lp[1]
            for o in loops)]
        if not inner:
            continue
        _, _, span, stores = max(inner, key=lambda x: (x[3], -len(x[2])))
        ops, pipes = {}, {}
        for b in span:
            op = b.split()[0]
            if op == "NOP":
                continue
            ops[op] = ops.get(op, 0) + 1
            pipes[_pipe(op)] = pipes.get(_pipe(op), 0) + 1
        n = sum(ops.values())
        out[instance] = {
            "store_loops": [(len(x[2]), x[3]) for x in inner],
            "windows_in_loop": stores,
            "per_window": n / stores,
            "by_pipe_per_window": {p: v / stores for p, v in pipes.items()},
            "by_opcode_in_loop": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])),
        }
    return out


def sass_bound(loop, windows: int, sms: int, clock_hz: float):
    """The least ms the card's issue and pipes allow for `windows`
    windows of a loop's instruction mix, the pipe that binds, and the
    mix in 32-bit operations at 67e12/s (the float rate's 128 FMAs of 2
    operations a clock an SM)."""
    per = loop["by_pipe_per_window"]
    clocks = {"issue": loop["per_window"] / ISSUE_LANES}
    for pipe, lanes in PIPE_LANES.items():
        clocks[pipe] = per.get(pipe, 0.0) / lanes
    by = max(clocks, key=clocks.get)
    ms = windows * clocks[by] / (sms * clock_hz) * 1e3
    return ms, by, clocks[by] * 2 * ISSUE_LANES


def _time(torch, fn, reps):
    """CUDA-event ms a call, the host queued ahead of the card by a ~5
    ms spin, so that a call's host side does not pace its kernels."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", action="append",
                    help="directory holding an earlier positional_hashes.cu "
                         "(repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-length", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from galah_tpu_torch.kernels.build import BUILD_DIR
    from galah_tpu_torch.kernels.rehearse_profiles import make_group
    from galah_tpu_torch.ops.constants import SENTINEL_BIASED
    from galah_tpu_torch.ops.positional_hashes import (
        apply_cut, positional_hashes_plain, subsample_cut)

    if not torch.cuda.is_available():
        print("rehearse_positional_hashes: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = _build(_variants(args.earlier),
                  os.path.join(BUILD_DIR, "rehearse_positional_hashes"))
    codes, offsets, lens = make_group(np.random.default_rng(args.seed),
                                      args.genomes, args.genome_length)
    # the group's layout (io/group.host_layout): each genome's contig
    # starts moved to its place, then the codes' length
    starts, jobs, pos, o0 = [], [], 0, 0
    for n, m in lens:
        starts.append(offsets[o0:o0 + m - 1] + pos)
        jobs.append((pos, max(int(n) - K + 1, 0)))
        pos, o0 = pos + int(n), o0 + int(m)
    starts = np.concatenate([*starts, [pos]]).astype(np.int64)
    hc, hs = torch.from_numpy(codes), torch.from_numpy(starts)
    dc, ds = hc.to(dev), hs.to(dev)
    n_win = codes.shape[0] - K + 1
    stream = torch.cuda.current_stream().cuda_stream
    plain = {a: positional_hashes_plain(hc, hs, algo=a)
             for a in ("murmur3", "tpufast")}
    algos = {"murmur3": 0, "tpufast": 1}

    def range_launch(lib, algo):
        out = torch.empty(n_win, dtype=torch.int64, device=dev)
        err = lib.positional_hashes_launch(dc.data_ptr(), ds.data_ptr(),
                                           ds.shape[0], 0, n_win,
                                           algos[algo], out.data_ptr(),
                                           stream)
        if err != 0:
            raise RuntimeError(f"cudaError_t {err}")
        return out

    def plan(lib):
        """Outputs and the device table, as ops/positional_hashes
        .plan_group makes them, at the library's tile."""
        outs = [torch.empty(n, dtype=torch.int64, device=dev)
                for _, n in jobs]
        tile = lib.positional_hashes_tile()
        counts = np.array([n for _, n in jobs], dtype=np.int64)
        table = np.stack([np.cumsum(-(-counts // tile)),
                          np.array([w0 for w0, _ in jobs], dtype=np.int64),
                          counts, np.array([o.data_ptr() for o in outs],
                                           dtype=np.int64)])
        t = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
        return outs, t, int(table[0, -1])

    def run(lib, planned, algo, c):
        outs, t, n_tiles = planned
        err = lib.positional_hashes_group_launch(
            dc.data_ptr(), ds.data_ptr(), ds.shape[0], t.data_ptr(),
            len(jobs), n_tiles, algos[algo], subsample_cut(c), stream)
        if err != 0:
            raise RuntimeError(f"cudaError_t {err}")
        return outs

    def group_launch(lib, algo, c):
        return run(lib, plan(lib), algo, c)

    def earlier_pass(lib, c):
        h = apply_cut(range_launch(lib, "murmur3"), subsample_cut(c))
        return [h[w0:w0 + n].clone() for w0, n in jobs]

    ok = True
    checks = {}
    for name, (lib, _, _) in libs.items():
        exact = {}
        for algo in algos:
            got = range_launch(lib, algo).cpu()
            exact[f"range {algo}"] = bool(torch.equal(got, plain[algo]))
            if hasattr(lib, "positional_hashes_group_launch"):
                for c in CUTS:
                    cut = subsample_cut(c)
                    got = group_launch(lib, algo, c)
                    exact[f"group {algo} c={c}"] = all(
                        torch.equal(g.cpu(), apply_cut(
                            plain[algo][w0:w0 + n], cut))
                        for g, (w0, n) in zip(got, jobs))
        torch.cuda.synchronize()
        checks[name] = exact
        ok &= all(exact.values())
    if not ok:
        print(json.dumps({"exact": checks}))
        print("rehearse_positional_hashes: a variant disagrees with the "
              "plain version", file=sys.stderr)
        return 1

    names = list(libs)
    times = {n: {} for n in names}
    for order in (names, names[::-1]):
        for name in order:
            lib = libs[name][0]
            grouped = hasattr(lib, "positional_hashes_group_launch")
            t = times[name]
            planned = plan(lib) if grouped else None
            for algo in algos:
                t.setdefault(f"range {algo}", []).append(_time(
                    torch, lambda: range_launch(lib, algo), args.reps))
                if grouped:
                    t.setdefault(f"group {algo}", []).append(_time(
                        torch, lambda: run(lib, planned, algo, 1),
                        args.reps))
            for c in CUTS:
                t.setdefault(f"range pass c={c}", []).append(_time(
                    torch, lambda: earlier_pass(lib, c), args.reps))
                if grouped:
                    t.setdefault(f"group pass c={c}", []).append(_time(
                        torch, lambda: group_launch(lib, "murmur3", c),
                        args.reps))

    fill_out = torch.empty(sum(n for _, n in jobs), dtype=torch.int64,
                           device=dev)
    fill_ms = [_time(torch, lambda: fill_out.fill_(7), args.reps)
               for _ in range(2)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    clock_hz = float(smi.split(",")[2]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    group_windows = sum(n for _, n in jobs)
    nbytes = (group_windows + (K - 1) * len(jobs) + 8 * starts.shape[0]
              + 32 * len(jobs) + 8 * group_windows)
    valid = int((plain["murmur3"] != SENTINEL_BIASED).sum())
    for name in names:
        lib, ptxas, path = libs[name]
        rec = {"variant": name, "exact": checks[name],
               "ms": {k: v for k, v in times[name].items()},
               "ptxas": ptxas, "windows": group_windows,
               "valid_windows": valid, "bytes": nbytes,
               "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
               "fill_output_ms": fill_ms}
        if name == "committed":
            loops = sass_window_loops(path)
            for algo, loop in loops.items():
                ms, by, ops = sass_bound(loop, valid, sms, clock_hz)
                loop.update({"issue_bound_ms": ms, "bound_by_pipe": by,
                             "ops_per_window_at_67e12": ops})
            rec["sass"] = loops
        print(json.dumps(rec), flush=True)
    print(f"card: {smi} (name, power limit W, max SM clock MHz); "
          f"{sms} SMs")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
