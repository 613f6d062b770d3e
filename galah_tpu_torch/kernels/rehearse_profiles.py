"""Trace one profile group's build on one NVIDIA GPU, in this checkout
and in an earlier one, with ``torch.profiler``.

    python -m galah_tpu_torch.kernels.rehearse_profiles \\
        [--earlier ROOT] [--seed 0] [--genomes 8] [--genome-length 2000000]

The group: ``--genomes`` genomes of ``--genome-length`` bases made from
the seed as ``chip_smoke.py`` makes its corpus (5-50 kb contigs, a few
N runs), 8 x 2 Mbp by default: the first profile group of the skani
512 run (``ops/fragment_ani.PROFILE_BATCH_BUDGET`` = 2^24 bases). Each
checkout profiles it in a child process run from its root, with its own
``galah_tpu_torch``: through ``build_profiles_batch`` where the
checkout has it, else one ``build_profile`` a genome (the route before
the batched build). Each child warms up once (kernel build, first
launches), then takes the host clock of ``--reps`` builds, each ended
by a synchronize (median), and one build under ``torch.profiler``
(CPU and CUDA activities): its host wall, the device time of its
kernels and copies summed (the stream runs one at a time, so the sum
is the busy time), the idle share, the number of kernels, copies,
``cudaStreamSynchronize`` calls and blocking copies, and the five
kernels that take the most device time. One JSON line a checkout; then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# run from a checkout's root: profile the saved group with its package
CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from galah_tpu_torch.io.fasta import Genome, GenomeStats
from galah_tpu_torch.ops import fragment_ani as fa

data = np.load(sys.argv[1])
reps = int(sys.argv[2])
codes, offs, lens = data["codes"], data["offsets"], data["lengths"]
genomes, c0, o0 = [], 0, 0
for i, (n, m) in enumerate(lens):
    off = offs[o0:o0 + m]
    genomes.append(Genome(f"g{i}", codes[c0:c0 + n].copy(), off - off[0],
                          GenomeStats(m - 1, 0, n)))
    c0, o0 = c0 + n, o0 + m
batched = getattr(fa, "build_profiles_batch", None)
device = torch.device("cuda")

def build():
    if batched is not None:
        out = batched(genomes, 15, 3000, device)
    else:
        out = [fa.build_profile(g, 15, 3000, device) for g in genomes]
    torch.cuda.synchronize()
    return out

build()
ms = []
for _ in range(reps):
    t0 = time.perf_counter()
    build()
    ms.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    profs = build()
    wall = (time.perf_counter() - t0) * 1e3

def dev_us(e):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0

events = prof.events()
# the device's own events (kernels, copies, sets); the CPU ops that
# launched them carry the same time again
dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
busy = sum(dev_us(e) for e in dev) / 1e3
kernels = [e for e in dev if not e.name.startswith("Memcpy")
           and not e.name.startswith("Memset")]
names = {}
for e in kernels:
    names[e.name] = names.get(e.name, 0.0) + dev_us(e) / 1e3
count = lambda prefix: sum(e.name.startswith(prefix) for e in events)
print(json.dumps({
    "route": "build_profiles_batch" if batched is not None
             else "build_profile a genome",
    "genomes": len(genomes), "bases": int(codes.shape[0]),
    "distinct": [int(p.ref_set.shape[0]) for p in profs],
    "host_ms_median": statistics.median(ms), "host_ms": ms,
    "profiled_wall_ms": wall,
    "device_busy_ms": busy if dev else None,
    "idle_share": 1 - busy / wall if dev else None,
    "kernels": len(kernels),
    "copies": sum(e.name.startswith("Memcpy") for e in dev),
    "stream_syncs": count("cudaStreamSynchronize"),
    "blocking_copies": count("cudaMemcpy") - count("cudaMemcpyAsync"),
    "copy_calls_async": count("cudaMemcpyAsync"),
    "top_kernels_ms": sorted(names.items(), key=lambda kv: -kv[1])[:5],
}))
"""


def make_group(rng, n_genomes: int, length: int):
    """(codes, contig offsets, (length, offset count) a genome) of
    `n_genomes` genomes laid end to end, each with its own offsets from
    0: random bases, 5-50 kb contigs, a few short N runs."""
    codes, offsets, lens = [], [], []
    for _ in range(n_genomes):
        c = rng.integers(0, 4, size=length).astype(np.uint8)
        for s in rng.integers(0, length - 100, size=8):
            c[s:s + int(rng.integers(1, 100))] = 255
        cuts = [0]
        while cuts[-1] < length:
            cuts.append(min(cuts[-1] + int(rng.integers(5_000, 50_000)),
                            length))
        codes.append(c)
        offsets.append(np.array(cuts, dtype=np.int64))
        lens.append((length, len(cuts)))
    return (np.concatenate(codes), np.concatenate(offsets),
            np.array(lens, dtype=np.int64))


def run_child(root: str, data: str, reps: int) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, data, str(reps)],
                          cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"profile build in {root} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", default=None,
                    help="root of an earlier checkout of the repository")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-length", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rehearse_profiles: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    codes, offsets, lens = make_group(np.random.default_rng(args.seed),
                                      args.genomes, args.genome_length)
    with tempfile.TemporaryDirectory(prefix="rehearse_profiles_") as work:
        data = os.path.join(work, "group.npz")
        np.savez(data, codes=codes, offsets=offsets, lengths=lens)
        trees = [("this", here)]
        if args.earlier:
            trees.append(("earlier", args.earlier))
        results = {}
        for name, root in trees:
            results[name] = run_child(root, data, args.reps)
            print(json.dumps({"tree": name, **results[name],
                              "card": card}))
        if args.earlier and results["this"]["distinct"] != \
                results["earlier"]["distinct"]:
            print("rehearse_profiles: the two trees' distinct counts "
                  "differ", file=sys.stderr)
            return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
