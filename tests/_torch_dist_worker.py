"""One rank of the port's multi-process tests
(tests/test_torch_distributed.py).

Joins a gloo process group on 127.0.0.1 as `rank` of `world`, then runs
the cases its mode names, printing one ``RESULT <json>`` line a case:

    python tests/_torch_dist_worker.py <port> <world> <rank> <corpus>
        <out_dir> <mode> [timeout_s]

Mode ``full`` clusters the corpus with the skani, finch and dashing
preclusters (dashing ranked by the corpus's genome-info file), ranks it
by quality with a record of the stats each rank read, fails one rank
inside a distributed pass, resumes from uneven per-rank checkpoints,
and checks the exchange helpers and the sharded passes over the rank
mesh. Mode ``cluster`` runs the skani cluster alone. In mode
``abandon`` rank 1 exits at once and rank 0's next exchange must raise
within `timeout_s`. A rank whose peers never come fails to join within
`timeout_s` and exits 3.
"""

import glob
import hashlib
import json
import os
import sys
import time


def result(case, **fields):
    print("RESULT " + json.dumps({"case": case, **fields}), flush=True)


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def cluster(cli, paths, out_dir, rank, name, extra=()):
    out = os.path.join(out_dir, f"{name}_rank{rank}.tsv")
    rc = cli.main(["cluster", "-f", *paths, "--device", "cpu", "-q",
                   "--threads", "1", *extra,
                   "--output-cluster-definition", out])
    result(name, rc=rc, wrote=os.path.exists(out))


def quality_reads(paths, info):
    """The quality order and the paths whose stats this rank read."""
    from galah_tpu_torch import quality

    read = []
    orig = quality.read_genome_stats

    def counted(path):
        read.append(path)
        return orig(path)

    quality.read_genome_stats = counted
    try:
        order = quality.filter_and_order_genomes(
            paths, quality.read_genome_info_file(info),
            formula="Parks2020_reduced")
    finally:
        quality.read_genome_stats = orig
    result("quality", order=[os.path.basename(p) for p in order],
           read=sorted(os.path.basename(p) for p in read))


def failure(distributed, rank):
    def compute(idxs):
        if rank == 1:
            raise RuntimeError("planted shard failure")
        return [1.0] * len(idxs)

    try:
        distributed.sharded_optional_floats(8, compute)
        result("failure", raised=False)
    except RuntimeError as e:
        result("failure", raised=True, planted="planted" in str(e))


def uneven_resume(cli, paths, out_dir, rank):
    """A checkpointed run, then this rank's distances dropped on rank 1
    only, then --resume: the tokens disagree and every rank resets."""
    from galah_tpu_torch.cluster import checkpoint

    ck = os.path.join(out_dir, "ck")
    cluster(cli, paths, out_dir, rank, "ckpt", ["--checkpoint-dir", ck])
    mine = os.path.join(ck, f"proc_{rank}")
    dist_file = os.path.join(mine, "precluster_distances.npz")
    had = os.path.exists(dist_file)
    if rank == 1:
        os.unlink(dist_file)
    resets = []
    orig = checkpoint.ClusterCheckpoint.reset_state

    def counted(self):
        resets.append(self.path)
        return orig(self)

    checkpoint.ClusterCheckpoint.reset_state = counted
    try:
        cluster(cli, paths, out_dir, rank, "resume",
                ["--checkpoint-dir", ck, "--resume"])
    finally:
        checkpoint.ClusterCheckpoint.reset_state = orig
    result("uneven", had_distances=had, resets=[os.path.basename(p)
                                                for p in resets])


def helpers(distributed, rank, world):
    import numpy as np

    shard = distributed.host_shard(list(range(10)))
    rows = np.arange(10, dtype=np.int64)[shard][:, None] * [1, 100]
    full = distributed.allgather_host_rows(10, rows, fill=-1)
    ragged = distributed.exchange(
        "ragged", np.full((rank + 1, 2 - rank % 2), rank, np.int32),
        fill=-7)
    result("helpers", shard=shard,
           round_trip=bool((full == np.arange(10)[:, None]
                            * [1, 100]).all()),
           same=distributed.tokens_agree(b"same token"),
           differ=distributed.tokens_agree(f"rank {rank}".encode()),
           ragged=ragged.tolist())


def mesh_passes(rank, world):
    """The sharded passes over rank meshes, their results as digests
    that the test compares with one process's."""
    import numpy as np
    import torch

    from galah_tpu_torch.ops.u64 import to_biased
    from galah_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(3)
    mat = rng.integers(0, 1 << 62, size=(90, 64), dtype=np.uint64)
    mat[10] = mat[4]
    mat[60, :40] = mat[61, :40]
    mat.sort(axis=1)
    t = to_biased(mat, "cpu")
    pi = rng.integers(0, 45, size=300)
    pj = rng.integers(45, 90, size=300)
    cols = torch.cat([t[64:90], t[:38]])
    meshes = {"auto": pm.auto_mesh("cpu"),
              "shared": pm.make_mesh(["cpu"] * 4,
                                     owners=[r % world for r in range(4)])}
    out = {}
    for name, m in meshes.items():
        pairs = pm.sharded_threshold_pairs(t, 21, 0.9, m, row_tile=16,
                                           col_tile=32)
        screen = pm.sharded_screen_pairs(t, np.full(90, 64), 0.3, m,
                                         row_tile=16, col_tile=32)
        c, tt = pm.sharded_pair_stats_for_pairs(t, pi, pj, 64, m)
        sc, st = pm.sharded_stripe_stats(t[:64], cols, 64, m, row_tile=16,
                                         r_pad=128)
        out[name] = {"shape": list(m.shape),
                     "pairs": sorted([a, b, v] for (a, b), v
                                     in pairs.items()),
                     "screen": screen, "pairlist": digest(c, tt),
                     "stripe": digest(sc, st)}
    result("mesh", **out)


def main() -> int:
    port, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    corpus, out_dir, mode = sys.argv[4], sys.argv[5], sys.argv[6]
    timeout_s = float(sys.argv[7]) if len(sys.argv) > 7 else 30.0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed

    torch.set_num_threads(1)
    from galah_tpu_torch import cli
    from galah_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    try:
        distributed.initialize(timeout_s=timeout_s)
    except Exception as e:  # the peerless mode's expected end
        result("init", ok=False, seconds=time.perf_counter() - t0,
               error=type(e).__name__)
        return 3
    result("init", ok=True, count=distributed.process_count(),
           index=distributed.process_index())
    if mode == "abandon":
        if rank:
            os._exit(0)
        import numpy as np

        t0 = time.perf_counter()
        try:
            distributed.exchange("probe", np.arange(3))
            result("abandon", raised=False)
        except RuntimeError as e:
            result("abandon", raised=True,
                   site=str(e).startswith("collective.probe failed"),
                   seconds=time.perf_counter() - t0)
        return 0
    paths = sorted(glob.glob(os.path.join(corpus, "*.fna")))
    if mode == "cluster":
        cluster(cli, paths, out_dir, rank, "skani")
    else:
        info = os.path.join(corpus, "info.csv")
        cluster(cli, paths, out_dir, rank, "skani")
        cluster(cli, paths, out_dir, rank, "finch",
                ["--precluster-method", "finch"])
        cluster(cli, paths, out_dir, rank, "dashing",
                ["--precluster-method", "dashing", "--genome-info", info])
        quality_reads(paths, info)
        failure(distributed, rank)
        uneven_resume(cli, paths, out_dir, rank)
        helpers(distributed, rank, world)
        mesh_passes(rank, world)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "galah_tpu"))
    result("modules", foreign=loaded,
           parallel=[m for m in ("galah_tpu_torch.parallel.mesh",
                                 "galah_tpu_torch.parallel.distributed")
                     if m in sys.modules])
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
