"""Kill-anywhere chaos harness: prove preemption safety by killing runs of
the port; the counterpart of ``galah_tpu``'s ``scripts/chaos_run.py``.

Loop (seeded, deterministic given --seed):

  1. build a tiny synthetic-family FASTA workload and compute the
     uninterrupted reference clustering once;
  2. each iteration, launch the same clustering (``python -m
     galah_tpu_torch``) as a subprocess with a checkpoint dir and
     interrupt it a different way: SIGTERM at a random delay (the
     cooperative path: stop at a safe boundary, exit 75), a GALAH_FI
     ``kill`` fault (os._exit mid-operation at a random dispatch or
     durable-write site, the SIGKILL/preemption stand-in), or a
     GALAH_FI filesystem fault (enospc / eio / torn-write inside
     io/atomic.py);
  3. resume with ``--resume`` (faults cleared) until the run completes;
  4. assert: the final cluster output is byte-identical to the
     uninterrupted reference, every artifact in the checkpoint dir is
     readable through the port's recovery-aware readers with no
     ``.tmp`` debris left in the (single-owner) checkpoint dir, and the
     final run report records the interruption/resume chain.

Any violation prints the evidence and exits 1. The acceptance gate is
25 consecutive passing iterations (``--iterations 25``);
tests/test_torch_chaos.py drives the same functions at a few.

``--modes`` picks the interruption modes (default: the five of
``MODES``, round-robin under a seeded shuffle); ``kill-dispatch`` is a
``kill`` at the first guarded dispatch site
(``resilience/dispatch.py``). ``--device cpu|cuda`` puts every child on
that device; without it a child runs where the CLI would (the card,
unless ``GALAH_TPU_PLATFORM`` says otherwise).

Usage:
    python -m galah_tpu_torch.resilience.chaos --iterations 25 \
        [--seed 0] [--device cpu|cuda] [--modes kill,torn-write] \
        [--workload cluster|cluster-overlap|index-insert|fleet] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from galah_tpu_torch.fleet.plan import PLAN_FILENAME
from galah_tpu_torch.io import atomic
from galah_tpu_torch.resilience.faults import KILL_EXIT_CODE
from galah_tpu_torch.resilience.interrupt import EXIT_PREEMPTED

#: the directory that holds the package, the children's working
#: directory, so that ``-m galah_tpu_torch`` is this checkout's
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The interruption modes one iteration draws from (round-robin with a
#: seeded shuffle, so 25 iterations cover every mode several times).
MODES = ("sigterm", "kill", "enospc", "eio", "torn-write")

#: Modes ``--modes`` may also name: a kill at the first guarded
#: ``dispatch.*`` site, which the all-sites ``kill`` reaches only by
#: chance.
EXTRA_MODES = ("kill-dispatch",)

#: Devices a child may be put on (``GALAH_TPU_PLATFORM``); with none
#: named, a child takes the CLI's own choice (cuda, unless the
#: environment's ``GALAH_TPU_PLATFORM`` says otherwise).
DEVICES = ("cpu", "cuda")

RUN_TIMEOUT_S = 600

#: SIGTERM's delay after a child starts, as fractions of the reference
#: run's wall, where the reference shows no start of its run: a child
#: spends about the first 45% starting (torch's import, and the card's
#: context on cuda; 3.4 s of 7.4 on the CPU cluster workload)
SIGTERM_WINDOW = (0.45, 1.05)


def sigterm_window(wall: float,
                   started: Optional[float] = None) -> Tuple[float, float]:
    """The SIGTERM delay range, seconds: from `started` (when the
    reference run's checkpoint appeared, its handlers installed) to the
    end of its `wall`, else SIGTERM_WINDOW's fractions of the wall. A
    signal that lands mid-run takes the cooperative stop (exit 75); one
    that lands while the child is still starting or already in its
    teardown, after its handlers were removed, ends it (exit -15), and
    one after it exited does nothing: legitimate outcomes all. The
    cluster workload's run, between its checkpoint and its TSV, lasts
    milliseconds on the CPU, so there nearly every signal lands in
    the start or the teardown."""
    if started is not None:
        return started, wall
    lo, hi = SIGTERM_WINDOW
    return lo * wall, hi * wall


def run_marking(proc: subprocess.Popen, marker: str
                ) -> Tuple[bytes, Optional[float], float]:
    """Wait for `proc`: (its output, the seconds until `marker` existed,
    None if it never did, its wall). The output is drained on another
    thread while this one polls."""
    t0 = time.monotonic()
    box: Dict[str, bytes] = {}
    reader = threading.Thread(
        target=lambda: box.update(out=proc.communicate(
            timeout=RUN_TIMEOUT_S)[0]), daemon=True)
    reader.start()
    seen: Optional[float] = None
    while reader.is_alive():
        if seen is None and os.path.exists(marker):
            seen = time.monotonic() - t0
        reader.join(0.02)
    return box.get("out", b""), seen, time.monotonic() - t0


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------


def make_workload(root: str, seed: int, families: int = 2,
                  members: int = 3, length: int = 20_000) -> List[str]:
    """Synthetic genome families (test_synthetic_families.py recipe):
    `families` random bases, `members` genomes each at ~0.5%
    within-family divergence — small enough for seconds-scale CPU
    runs, structured enough that the clustering is non-trivial."""
    import numpy as np

    bases = np.array(list("ACGT"))
    rng = np.random.default_rng(seed)
    paths = []
    for fam in range(families):
        base = rng.integers(0, 4, size=length)
        for member in range(members):
            codes = base.copy()
            if member:
                sites = rng.random(length) < 0.005
                codes[sites] = (codes[sites] + rng.integers(
                    1, 4, size=int(sites.sum()))) % 4
            p = os.path.join(root, f"fam{fam}_m{member}.fna")
            seq = "".join(bases[codes])
            with open(p, "w") as f:
                f.write(">contig1\n")
                for i in range(0, len(seq), 70):
                    f.write(seq[i:i + 70] + "\n")
            paths.append(p)
    return paths


def cluster_argv(genomes: List[str], out_tsv: str, ckpt: str,
                 report: str, resume: bool,
                 precluster: str = "skani") -> List[str]:
    argv = [sys.executable, "-m", "galah_tpu_torch", "cluster",
            "--genome-fasta-files", *genomes,
            "--precluster-method", precluster,
            "--cluster-method", "skani",
            "--output-cluster-definition", out_tsv,
            "--checkpoint-dir", ckpt,
            "--run-report", report]
    if resume:
        argv.append("--resume")
    return argv


#: Env for the cluster-overlap workload: force the overlapped dataflow
#: (an engagement failure is then a loud error) with the device greedy
#: strategy and the slab fold pinned on, so that a fused-fold failure
#: fails the iteration instead of passing the byte-identity gate by
#: another route. A resumed run reloads saved distances and runs
#: stage-serial by design, so the same env is safe on every launch in
#: the kill/resume chain.
OVERLAP_ENV = {"GALAH_TPU_OVERLAP": "1",
               "GALAH_TPU_GREEDY_STRATEGY": "device",
               "GALAH_TPU_MEGAKERNEL": "1"}

#: Env for the paged iterations the cluster-overlap workload
#: interleaves: the out-of-core sketch tier forced on
#: (``io/pagestore.py``) with a 1 MiB resident budget, so every
#: page-in evicts and the kill/fault window covers the page store's
#: commit sites (io.atomic.write[pagestore.page],
#: io.atomic.append[pagestore.dir], prefix-matched by the harness's
#: site=io.atomic fault spec). The paged band walk is a bucketed
#: stage-serial pass, which the forced overlap refuses (a stream cannot
#: band a prefix), so these iterations leave GALAH_TPU_OVERLAP at auto
#: and gate against the SAME overlapped reference: the chaos loop
#: doubles as a cross-engine byte-identity check.
PAGED_ENV = {"GALAH_TPU_GREEDY_STRATEGY": "device",
             "GALAH_TPU_MEGAKERNEL": "1",
             "GALAH_TPU_HLL_BUCKETS": "1",
             "GALAH_TPU_PAGESTORE": "1",
             "GALAH_TPU_SKETCH_RAM_MB": "1"}


def device_env(device: Optional[str]) -> Dict[str, str]:
    """The env that puts every child on `device`; None adds nothing, so
    the children keep the CLI's default and the caller's environment."""
    if device is None:
        return {}
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r}; choices: {DEVICES}")
    return {"GALAH_TPU_PLATFORM": device}


def index_argv(index_dir: str, genomes: Optional[List[str]] = None,
               action: str = "insert", resume: bool = False,
               report: Optional[str] = None) -> List[str]:
    """`galah_tpu_torch index` argv for the index-insert chaos workload.
    --batch 2 keeps several durable safe boundaries inside one insert
    so kills land between batches as well as inside them."""
    argv = [sys.executable, "-m", "galah_tpu_torch", "index",
            "--index-dir", index_dir]
    if report:
        argv += ["--run-report", report]
    argv.append(action)
    if genomes:
        argv += ["--genome-fasta-files", *genomes]
    if action == "insert":
        argv += ["--batch", "2"]
        if resume:
            argv.append("--resume")
    return argv


def launch(argv: List[str], extra_env: Optional[Dict[str, str]] = None
           ) -> subprocess.Popen:
    env = dict(os.environ)
    env.pop("GALAH_FI", None)  # each run decides its own faults
    # chaos runs double as the concurrency-sanitizer workload: every
    # child arms GalahSan so kills land mid-acquisition too
    env.setdefault("GALAH_SAN", "1")
    env.update(extra_env or {})
    return subprocess.Popen(argv, env=env, cwd=PACKAGE_PARENT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


# ---------------------------------------------------------------------------
# Artifact audit
# ---------------------------------------------------------------------------


def scan_artifacts(ckpt_dir: str) -> List[str]:
    """Corruption findings in a checkpoint dir AFTER a completed run
    ([] == clean). Readable-with-recovery is the contract: torn lines
    rejected by their checksum are expected debris of a kill, but
    anything the recovery-aware readers cannot read, and any ``.tmp``
    left in the single-owner checkpoint dir after a successful run
    (its open sweeps), is a violation."""
    problems: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return problems
    for name in sorted(os.listdir(ckpt_dir)):
        p = os.path.join(ckpt_dir, name)
        if name.endswith(".tmp"):
            problems.append(f"leftover tmp debris: {p}")
        elif name.endswith(".jsonl"):
            try:
                atomic.read_jsonl(p)
            except Exception as exc:
                problems.append(f"unreadable jsonl {p}: {exc}")
        elif name.endswith(".json"):
            try:
                with open(p) as f:
                    json.load(f)
            except Exception as exc:
                problems.append(f"unparseable json {p}: {exc}")
        elif name.endswith(".npz"):
            try:
                import numpy as np

                with np.load(p) as z:
                    for member in z.files:
                        z[member]
            except Exception as exc:
                problems.append(f"unloadable npz {p}: {exc}")
    return problems


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------


def mode_schedule(modes: Sequence[str], iterations: int,
                  seed: int) -> List[str]:
    """The iterations' modes: `modes` round-robin, shuffled by `seed`
    (every mode at least once from len(modes) iterations on)."""
    schedule = [modes[i % len(modes)] for i in range(iterations)]
    random.Random(seed).shuffle(schedule)
    return schedule


def fault_env(mode: str, seed: int) -> Optional[Dict[str, str]]:
    """The GALAH_FI spec for an interruption mode (None for sigterm).

    ``kill`` uses a low per-site probability over ALL sites so the
    seeded coin picks a different dispatch or durable-write operation
    each iteration; ``kill-dispatch`` kills at the first dispatch site;
    the fs faults target io/atomic.py and fire once."""
    if mode == "sigterm":
        return None
    if mode == "kill":
        return {"GALAH_FI":
                f"site=;kind=kill;prob=0.15;seed={seed};max=1"}
    if mode == "kill-dispatch":
        # the first guarded dispatch (dispatch.* sites; the durable
        # writes are io.atomic.* and the reads io.ingest[...])
        return {"GALAH_FI":
                f"site=dispatch.;kind=kill;prob=1;seed={seed};max=1"}
    return {"GALAH_FI": f"site=io.atomic;kind={mode};prob=0.5;"
                        f"seed={seed};max=1"}


def run_one(genomes: List[str], work: str, mode: str, seed: int,
            log: List[str], precluster: str = "skani",
            extra_env: Optional[Dict[str, str]] = None,
            window: Tuple[float, float] = (0.4, 2.2)
            ) -> Tuple[bool, str]:
    """One kill/resume iteration; returns (ok, detail)."""
    rng = random.Random(f"chaos:{seed}:{mode}")
    ckpt = os.path.join(work, "ckpt")
    out_tsv = os.path.join(work, "clusters.tsv")
    report = os.path.join(work, "report.json")

    # -- interrupted run ------------------------------------------------
    env = dict(extra_env or {})
    env.update(fault_env(mode, seed) or {})
    proc = launch(cluster_argv(genomes, out_tsv, ckpt, report,
                               resume=False, precluster=precluster),
                  env)
    if mode == "sigterm":
        # `window` spans the reference run from its handlers' install
        # to its exit (sigterm_window)
        time.sleep(rng.uniform(*window))
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    try:
        stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return False, f"{mode}: interrupted run hung"
    rc = proc.returncode
    log.append(f"    interrupted run exited {rc}")
    interrupted = rc != 0
    # SIGTERM can land before the handlers install (default handler:
    # -15) or after the run finished (0): all are legitimate outcomes
    # of killing at an arbitrary instant.
    acceptable = {0, 1, EXIT_PREEMPTED, KILL_EXIT_CODE, -15,
                  -signal.SIGKILL}
    if rc not in acceptable:
        return False, (f"{mode}: unexpected exit {rc}\n"
                       + stdout.decode(errors="replace")[-2000:])

    # -- resume until complete (faults cleared) -------------------------
    for attempt in range(3):
        if not interrupted:
            break
        can_resume = os.path.exists(
            os.path.join(ckpt, "fingerprint.json"))
        proc = launch(cluster_argv(genomes, out_tsv, ckpt, report,
                                   resume=can_resume,
                                   precluster=precluster), extra_env)
        try:
            stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return False, f"{mode}: resume run hung"
        log.append(f"    resume attempt {attempt} exited "
                   f"{proc.returncode} (resume={can_resume})")
        if proc.returncode == 0:
            break
        if attempt == 2:
            return False, (f"{mode}: resume never completed "
                           f"(last exit {proc.returncode})\n"
                           + stdout.decode(errors="replace")[-2000:])

    if not os.path.exists(out_tsv):
        return False, f"{mode}: completed run left no cluster output"
    return True, stdout.decode(errors="replace")


def check_report(report_path: str, ckpt: str, was_preempted: bool
                 ) -> Optional[str]:
    """The final run report must record the resume chain."""
    try:
        with open(report_path) as f:
            rep = json.load(f)
    except Exception as exc:
        return f"run report unreadable: {exc}"
    pre = rep.get("preemption")
    if not isinstance(pre, dict):
        return "run report has no preemption section"
    if pre.get("resumed_from") != ckpt:
        return (f"resumed_from={pre.get('resumed_from')!r}, "
                f"expected {ckpt!r}")
    if was_preempted and pre.get("prior_interruptions", 0) < 1:
        return ("cooperative preemption left no interruption record "
                f"(prior_interruptions={pre.get('prior_interruptions')})")
    san = rep.get("sanitizer")
    if isinstance(san, dict):
        for key in ("undeclared_acquisitions", "undeclared_edges",
                    "inversions", "races"):
            if san.get(key, 0):
                return f"sanitizer violation: {key}={san[key]}"
    return None


def run_iteration(genomes: List[str], reference: bytes, workdir: str,
                  mode: str, seed: int, precluster: str = "skani",
                  extra_env: Optional[Dict[str, str]] = None,
                  window: Tuple[float, float] = (0.4, 2.2)
                  ) -> Tuple[bool, str]:
    work = os.path.join(workdir, f"iter_{seed}_{mode}")
    os.makedirs(work, exist_ok=True)
    log: List[str] = []
    ok, detail = run_one(genomes, work, mode, seed, log,
                         precluster=precluster, extra_env=extra_env,
                         window=window)
    if not ok:
        return False, "\n".join(log + [detail])
    ckpt = os.path.join(work, "ckpt")
    with open(os.path.join(work, "clusters.tsv"), "rb") as f:
        out = f.read()
    if out != reference:
        return False, "\n".join(log + [
            f"{mode}: resumed clusters differ from the uninterrupted "
            f"reference ({len(out)} vs {len(reference)} bytes)"])
    problems = scan_artifacts(ckpt)
    if problems:
        return False, "\n".join(log + [f"{mode}: corrupt artifacts:"]
                                + problems)
    was_preempted = "exited 75" in "\n".join(log)
    # the chain is only recorded when the completing run actually
    # resumed a durable checkpoint; a kill BEFORE the fingerprint ever
    # reached disk legitimately starts over with no chain to record
    resumed = any("resume=True" in line for line in log)
    if resumed:
        err = check_report(os.path.join(work, "report.json"), ckpt,
                           was_preempted)
        if err:
            return False, "\n".join(log + [f"{mode}: {err}"])
    return True, "\n".join(log)


# ---------------------------------------------------------------------------
# Index-insert workload
# ---------------------------------------------------------------------------


def index_dir_bytes(path: str) -> Dict[str, bytes]:
    """Byte snapshot of an index directory, keyed by file name.

    ``interruptions.jsonl`` is the one legitimately run-dependent file
    (it records the kills themselves); everything else — logs,
    generation manifests, commit pointer, fingerprint — must converge
    to the uninterrupted reference byte for byte."""
    out: Dict[str, bytes] = {}
    for name in sorted(os.listdir(path)):
        if name == "interruptions.jsonl":
            continue
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def run_index_iteration(base_idx: str, new_genomes: List[str],
                        reference: Dict[str, bytes], workdir: str,
                        mode: str, seed: int,
                        cache_env: Dict[str, str],
                        window: Tuple[float, float] = (0.4, 2.2)
                        ) -> Tuple[bool, str]:
    """One kill/resume iteration over `index insert`; (ok, detail).

    Asserts the three index-insert chaos invariants: a kill at any
    instant leaves the index fsck-clean and loadable at a committed
    generation; a completed resume leaves zero .tmp debris; and the
    converged directory is byte-identical to the uninterrupted insert
    (modulo the interruption chain record)."""
    from galah_tpu_torch.index import store as index_store

    work = os.path.join(workdir, f"ixiter_{seed}_{mode}")
    os.makedirs(work, exist_ok=True)
    idx = os.path.join(work, "idx")
    shutil.copytree(base_idx, idx)
    report = os.path.join(work, "report.json")
    log: List[str] = []
    rng = random.Random(f"chaos-index:{seed}:{mode}")

    env = dict(cache_env)
    env.update(fault_env(mode, seed) or {})
    proc = launch(index_argv(idx, new_genomes, report=report), env)
    if mode == "sigterm":
        # `window` spans the reference insert's wall, as in run_one
        time.sleep(rng.uniform(*window))
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    try:
        stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return False, f"{mode}: interrupted insert hung"
    rc = proc.returncode
    log.append(f"    interrupted insert exited {rc}")
    interrupted = rc != 0
    acceptable = {0, 1, EXIT_PREEMPTED, KILL_EXIT_CODE, -15,
                  -signal.SIGKILL}
    if rc not in acceptable:
        return False, "\n".join(log + [
            f"{mode}: unexpected exit {rc}",
            stdout.decode(errors="replace")[-2000:]])

    # invariant 1: whatever instant the kill landed, the index is
    # loadable at a committed generation with zero fsck problems
    # (uncommitted tails and tmp debris are expected warnings here)
    rep = index_store.fsck(idx)
    if rep["problems"]:
        return False, "\n".join(log + [
            f"{mode}: fsck problems after the kill:"] + rep["problems"])
    if rep["generation"] not in (1, 2):
        return False, "\n".join(log + [
            f"{mode}: unexpected generation {rep['generation']} "
            f"after the kill"])
    log.append(f"    post-kill index loadable at generation "
               f"{rep['generation']}")

    for attempt in range(3):
        if not interrupted:
            break
        proc = launch(index_argv(idx, new_genomes, resume=True,
                                 report=report), cache_env)
        try:
            stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return False, f"{mode}: resumed insert hung"
        log.append(f"    resume attempt {attempt} exited "
                   f"{proc.returncode}")
        if proc.returncode == 0:
            break
        if attempt == 2:
            return False, "\n".join(log + [
                f"{mode}: resumed insert never completed "
                f"(last exit {proc.returncode})",
                stdout.decode(errors="replace")[-2000:]])

    # invariant 2: a completed insert leaves no .tmp debris and every
    # artifact readable through the recovery-aware readers
    problems = scan_artifacts(idx)
    if problems:
        return False, "\n".join(log + [f"{mode}: corrupt artifacts:"]
                                + problems)
    rep = index_store.fsck(idx)
    if not rep["ok"]:
        return False, "\n".join(log + [f"{mode}: final fsck failed:"]
                                + rep["problems"] + rep["warnings"])

    # invariant 3: byte-identical convergence with the uninterrupted
    # reference insert
    got = index_dir_bytes(idx)
    if got != reference:
        diffs = sorted(set(got) ^ set(reference)) + [
            n for n in sorted(set(got) & set(reference))
            if got[n] != reference[n]]
        return False, "\n".join(log + [
            f"{mode}: converged index differs from the uninterrupted "
            f"reference in: {diffs}"])
    return True, "\n".join(log)


def run_index_harness(iterations: int, seed: int, workdir: str,
                      verbose: bool = True, device: Optional[str] = None,
                      modes: Sequence[str] = MODES) -> int:
    """Chaos loop over `index insert`; returns FAILED iteration count.

    Builds the base index once (uninterrupted), computes the reference
    insert on a copy, then kills/resumes the same insert on fresh
    copies. The insert mixes joiners into existing clusters (each
    family's last member) with a whole novel family (new
    representatives), so kills land on both decision paths."""
    gdir = os.path.join(workdir, "genomes")
    os.makedirs(gdir, exist_ok=True)
    genomes = make_workload(gdir, seed, families=3, members=4,
                            length=12_000)
    new = [genomes[3], genomes[7]] + genomes[8:]
    base = [g for g in genomes if g not in new]
    cache_env = {"GALAH_TPU_CACHE":
                 os.path.join(workdir, "sketch_cache"),
                 **device_env(device)}

    base_idx = os.path.join(workdir, "base_idx")
    proc = launch(index_argv(base_idx, base, action="build"), cache_env)
    stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        print("FATAL: index build failed:\n"
              + stdout.decode(errors="replace")[-3000:])
        return iterations or 1

    ref_idx = os.path.join(workdir, "ref_idx")
    shutil.copytree(base_idx, ref_idx)
    t0 = time.monotonic()
    proc = launch(index_argv(ref_idx, new), cache_env)
    stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    window = sigterm_window(time.monotonic() - t0)
    if proc.returncode != 0:
        print("FATAL: reference insert failed:\n"
              + stdout.decode(errors="replace")[-3000:])
        return iterations or 1
    reference = index_dir_bytes(ref_idx)
    if verbose:
        print(f"reference index: {len(reference)} files, "
              f"{sum(len(b) for b in reference.values())} bytes")

    schedule = mode_schedule(modes, iterations, seed)
    failures = 0
    for i, mode in enumerate(schedule):
        ok, detail = run_index_iteration(
            base_idx, new, reference, workdir, mode,
            seed * 1000 + i, cache_env, window=window)
        status = "PASS" if ok else "FAIL"
        if verbose or not ok:
            print(f"[{i + 1:2d}/{iterations}] index/{mode:<10s} "
                  f"{status}")
            for line in detail.splitlines():
                if not ok or line.strip().startswith(
                        ("interrupted", "resume", "post-kill")):
                    print(f"      {line.strip()}")
        failures += 0 if ok else 1
    print(f"chaos[index]: {iterations - failures}/{iterations} "
          f"iterations passed")
    return failures


# ---------------------------------------------------------------------------
# Fleet workload
# ---------------------------------------------------------------------------

#: Fleet interruption modes: SIGKILL a worker's whole process group
#: (the preempted-node stand-in), SIGKILL the SCHEDULER itself — its
#: workers survive in their own sessions and the resumed supervisor
#: must adopt and re-own them — or SIGTERM the scheduler (cooperative
#: drain: the signal is forwarded to every worker group, everyone
#: exits 75 at a safe boundary).
FLEET_MODES = ("worker-kill", "sched-kill", "sched-sigterm")

#: Chaos knobs for every fleet launch: a deep reassignment budget (a
#: kill/resume chain must never quarantine a healthy shard for being
#: unlucky), tight poll/heartbeat cadence so preemption detection fits
#: seconds-scale runs, and deterministic near-zero backoff.
FLEET_CHAOS_ENV = {
    "GALAH_TPU_FLEET_RETRY_MAX_ATTEMPTS": "10",
    "GALAH_TPU_FLEET_RETRY_BASE_DELAY": "0.05",
    "GALAH_TPU_FLEET_RETRY_MAX_DELAY": "0.2",
    "GALAH_TPU_FLEET_RETRY_JITTER": "0",
    "GALAH_TPU_FLEET_POLL_S": "0.1",
    "GALAH_TPU_FLEET_HEARTBEAT_S": "0.5",
}


def fleet_argv(genomes: List[str], fleet_dir: str, out_tsv: str,
               report: str, resume: bool, workers: int = 2,
               shards: int = 3) -> List[str]:
    argv = [sys.executable, "-m", "galah_tpu_torch", "fleet", "run",
            "--genome-fasta-files", *genomes,
            "--precluster-method", "skani",
            "--cluster-method", "skani",
            "--fleet-dir", fleet_dir,
            "--workers", str(workers),
            "--shards", str(shards),
            "--output-cluster-definition", out_tsv,
            "--run-report", report]
    if resume:
        argv.append("--resume")
    return argv


def find_fleet_workers(fleet_dir: str) -> List[int]:
    """Pids of live fleet WORKER processes (each a session leader,
    so pid == pgid), found by /proc cmdline: any galah_tpu_torch process
    whose argv references the fleet's shards/ subtree is a worker —
    the scheduler references the fleet dir itself, never the
    subtree."""
    marker = os.path.join(fleet_dir, "shards") + os.sep
    pids: List[int] = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read().decode("utf-8", "replace")
        except OSError:
            continue
        if marker in cmdline and "galah_tpu_torch" in cmdline:
            pids.append(int(entry))
    return sorted(pids)


def check_fleet_report(report_path: str, n_shards: int
                       ) -> Optional[str]:
    """The completing run's report must carry a coherent fleet
    section: every shard done, every shard's lifetime launch count
    equal to its recorded preemption chain plus the one attempt that
    finished, and the fleet totals equal to the sum of the chains."""
    try:
        with open(report_path) as f:
            rep = json.load(f)
    except Exception as exc:
        return f"run report unreadable: {exc}"
    fleet = rep.get("fleet")
    if not isinstance(fleet, dict):
        return "run report has no fleet section"
    if (fleet.get("n_shards") != n_shards
            or fleet.get("shards_done") != n_shards):
        return (f"incomplete fleet: n_shards={fleet.get('n_shards')} "
                f"shards_done={fleet.get('shards_done')} "
                f"(expected {n_shards})")
    if fleet.get("shards_failed"):
        return f"quarantined shards: {fleet.get('shards_failed')}"
    chain_total = 0
    for sh in fleet.get("shards", []):
        chain = sh.get("preemptions", [])
        chain_total += len(chain)
        if sh.get("status") != "done":
            return (f"shard {sh.get('shard_id')} finished with "
                    f"status {sh.get('status')!r}")
        if sh.get("attempts", 0) != len(chain) + 1:
            return (f"incoherent chain for shard "
                    f"{sh.get('shard_id')}: {sh.get('attempts')} "
                    f"attempt(s) vs {len(chain)} preemption(s) "
                    f"{chain}")
    if fleet.get("preemptions") != chain_total:
        return (f"preemption total {fleet.get('preemptions')} != "
                f"sum of shard chains {chain_total}")
    if fleet.get("reassignments") != chain_total:
        return (f"reassignments {fleet.get('reassignments')} != "
                f"preemption total {chain_total}")
    san = rep.get("sanitizer")
    if isinstance(san, dict):
        for key in ("undeclared_acquisitions", "undeclared_edges",
                    "inversions", "races"):
            if san.get(key, 0):
                return f"sanitizer violation: {key}={san[key]}"
    return None


def check_fleet_analyze(fleet_dir: str) -> Optional[str]:
    """``galah_tpu_torch fleet analyze --json`` must succeed on the
    completed fleet dir — even when the scheduler itself was killed
    mid-run, the event log alone must support a rollup — and its
    blame decomposition must conserve the fleet wall: component
    blame_s summing to fleet_wall_s within 1%, with a named
    bottleneck."""
    proc = subprocess.run(
        [sys.executable, "-m", "galah_tpu_torch", "fleet", "analyze",
         "--json", "--no-report", fleet_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=120,
        cwd=PACKAGE_PARENT)
    if proc.returncode != 0:
        return (f"fleet analyze exited {proc.returncode}: "
                + proc.stderr.decode(errors="replace")[-1000:])
    try:
        ru = json.loads(proc.stdout)
    except Exception as exc:
        return f"fleet analyze --json emitted unparseable JSON: {exc}"
    wall = ru.get("fleet_wall_s")
    comps = ru.get("components", {})
    if not isinstance(wall, (int, float)) or wall <= 0:
        return f"fleet analyze rollup has no wall: {wall!r}"
    blame_sum = sum(c.get("blame_s", 0.0) for c in comps.values()
                    if isinstance(c, dict))
    if abs(blame_sum - wall) > 0.01 * wall:
        return (f"fleet blame does not conserve the wall: "
                f"sum {blame_sum:.3f}s vs wall {wall:.3f}s")
    if not ru.get("bottleneck"):
        return "fleet analyze named no bottleneck"
    return None


def run_fleet_iteration(genomes: List[str], reference: bytes,
                        workdir: str, mode: str, seed: int,
                        cache_env: Dict[str, str], shards: int = 3
                        ) -> Tuple[bool, str]:
    """One fleet kill/resume iteration; returns (ok, detail)."""
    work = os.path.join(workdir, f"fliter_{seed}_{mode}")
    os.makedirs(work, exist_ok=True)
    fleet_dir = os.path.join(work, "fleet")
    out_tsv = os.path.join(work, "clusters.tsv")
    report = os.path.join(work, "report.json")
    log: List[str] = []
    rng = random.Random(f"chaos-fleet:{seed}:{mode}")
    env = dict(cache_env)
    env.update(FLEET_CHAOS_ENV)

    # -- interrupted fleet run ------------------------------------------
    proc = launch(fleet_argv(genomes, fleet_dir, out_tsv, report,
                             resume=False, shards=shards), env)
    if mode == "worker-kill":
        # wait for workers to appear, then SIGKILL one or two whole
        # worker process groups at seeded instants (a kill may land
        # mid-profile, mid-checkpoint-write, or after the worker
        # already finished — all must be survivable)
        want = rng.randint(1, 2)
        killed = 0
        deadline = time.monotonic() + 60
        while (killed < want and proc.poll() is None
               and time.monotonic() < deadline):
            time.sleep(rng.uniform(0.2, 0.9))
            workers = find_fleet_workers(fleet_dir)
            if not workers:
                continue
            victim = workers[rng.randrange(len(workers))]
            try:
                os.killpg(victim, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                continue
            killed += 1
            log.append(f"    SIGKILLed worker group {victim}")
    else:
        time.sleep(rng.uniform(1.0, 6.0))
        if proc.poll() is None:
            sig = (signal.SIGKILL if mode == "sched-kill"
                   else signal.SIGTERM)
            proc.send_signal(sig)
            log.append(f"    sent {sig.name} to the scheduler process")
    try:
        stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return False, "\n".join(
            log + [f"{mode}: interrupted fleet run hung"])
    rc = proc.returncode
    log.append(f"    interrupted fleet run exited {rc}")
    interrupted = rc != 0
    # no GALAH_FI faults here, so exit 1 (quarantine) is NOT
    # acceptable: the reassignment budget must absorb every kill
    acceptable = {0, EXIT_PREEMPTED, -15, -signal.SIGKILL}
    if rc not in acceptable:
        return False, "\n".join(log + [
            f"{mode}: unexpected exit {rc}",
            stdout.decode(errors="replace")[-2000:]])

    # -- resume until complete ------------------------------------------
    for attempt in range(3):
        if not interrupted:
            break
        can_resume = os.path.exists(
            os.path.join(fleet_dir, PLAN_FILENAME))
        proc = launch(fleet_argv(genomes, fleet_dir, out_tsv, report,
                                 resume=can_resume, shards=shards),
                      env)
        try:
            stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return False, "\n".join(
                log + [f"{mode}: resumed fleet run hung"])
        log.append(f"    resume attempt {attempt} exited "
                   f"{proc.returncode} (resume={can_resume})")
        if proc.returncode == 0:
            break
        if attempt == 2:
            return False, "\n".join(log + [
                f"{mode}: fleet never completed "
                f"(last exit {proc.returncode})",
                stdout.decode(errors="replace")[-2000:]])

    # -- invariants -----------------------------------------------------
    if not os.path.exists(out_tsv):
        return False, "\n".join(
            log + [f"{mode}: completed fleet left no cluster output"])
    with open(out_tsv, "rb") as f:
        out = f.read()
    if out != reference:
        return False, "\n".join(log + [
            f"{mode}: fleet clusters differ from the single-process "
            f"reference ({len(out)} vs {len(reference)} bytes)"])
    problems = scan_artifacts(fleet_dir)
    shards_dir = os.path.join(fleet_dir, "shards")
    if os.path.isdir(shards_dir):
        for name in sorted(os.listdir(shards_dir)):
            sroot = os.path.join(shards_dir, name)
            problems += scan_artifacts(sroot)
            problems += scan_artifacts(os.path.join(sroot, "ckpt"))
    for dirpath, _dirnames, filenames in os.walk(fleet_dir):
        for fn in filenames:
            if fn.endswith(".tmp"):
                p = os.path.join(dirpath, fn)
                msg = f"leftover tmp debris: {p}"
                if msg not in problems:
                    problems.append(msg)
    if problems:
        return False, "\n".join(
            log + [f"{mode}: corrupt fleet artifacts:"] + problems)
    err = check_fleet_report(report, n_shards=shards)
    if err:
        return False, "\n".join(log + [f"{mode}: {err}"])
    err = check_fleet_analyze(fleet_dir)
    if err:
        return False, "\n".join(log + [f"{mode}: {err}"])
    return True, "\n".join(log)


def run_fleet_harness(iterations: int, seed: int, workdir: str,
                      verbose: bool = True, device: Optional[str] = None) -> int:
    """Chaos loop over an elastic fleet run; returns FAILED count.

    The reference is the same corpus through ONE single-process
    ``cluster`` run. Every iteration runs ``fleet run`` sharded 3 ways
    across 2 workers — 10 genomes in 2 families, so the contiguous
    shard boundaries land MID-family and the cross-shard merge pairs
    are real — then SIGKILLs a worker group or the scheduler itself
    (round-robin over FLEET_MODES: any 3+ iterations kill the
    scheduler at least once), resumes, and holds the converged fleet
    to byte-identical output with zero debris and a coherent
    reassignment chain in the run report."""
    gdir = os.path.join(workdir, "genomes")
    os.makedirs(gdir, exist_ok=True)
    genomes = make_workload(gdir, seed, families=2, members=5,
                            length=12_000)
    cache_env = {"GALAH_TPU_CACHE":
                 os.path.join(workdir, "sketch_cache"),
                 **device_env(device)}

    ref_work = os.path.join(workdir, "reference")
    os.makedirs(ref_work, exist_ok=True)
    ref_tsv = os.path.join(ref_work, "clusters.tsv")
    proc = launch(cluster_argv(
        genomes, ref_tsv, os.path.join(ref_work, "ckpt"),
        os.path.join(ref_work, "report.json"), resume=False),
        cache_env)
    stdout, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        print("FATAL: reference run failed:\n"
              + stdout.decode(errors="replace")[-3000:])
        return iterations or 1
    with open(ref_tsv, "rb") as f:
        reference = f.read()
    if verbose:
        nlines = reference.count(b"\n")
        print(f"reference clustering: {len(reference)} bytes, "
              f"{nlines} lines")

    schedule = mode_schedule(FLEET_MODES, iterations, seed)
    failures = 0
    for i, mode in enumerate(schedule):
        ok, detail = run_fleet_iteration(
            genomes, reference, workdir, mode, seed * 1000 + i,
            cache_env)
        status = "PASS" if ok else "FAIL"
        if verbose or not ok:
            print(f"[{i + 1:2d}/{iterations}] fleet/{mode:<13s} "
                  f"{status}")
            for line in detail.splitlines():
                if not ok or line.strip().startswith(
                        ("interrupted", "resume", "SIGKILLed",
                         "sent")):
                    print(f"      {line.strip()}")
        failures += 0 if ok else 1
    print(f"chaos[fleet]: {iterations - failures}/{iterations} "
          f"iterations passed")
    return failures


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


def run_harness(iterations: int, seed: int, workdir: str,
                verbose: bool = True, overlap: bool = False,
                device: Optional[str] = None, modes: Sequence[str] = MODES) -> int:
    """Full chaos loop; returns the number of FAILED iterations.

    With ``overlap=True`` every child run (reference, interrupted, and
    resume) uses the finch preclusterer with the overlapped dataflow
    forced on, so kills land inside the single fused pipeline — mid
    ingest, mid speculative fragment batch, or at the quiesce point —
    and the byte-identity gate proves the overlapped engine is exactly
    as preemption-safe as the stage-serial one.  Odd iterations swap
    in ``PAGED_ENV`` instead: the paged bucketed band walk forced on
    under a tiny resident budget, so the same kill/fault schedule also
    lands inside pagestore page commits and evictions — still gated
    byte-for-byte against the overlapped reference."""
    precluster = "finch" if overlap else "skani"
    extra_env = {**device_env(device), **(OVERLAP_ENV if overlap else {})}
    paged_env = {**device_env(device), **PAGED_ENV}
    gdir = os.path.join(workdir, "genomes")
    os.makedirs(gdir, exist_ok=True)
    genomes = make_workload(gdir, seed)

    # uninterrupted reference; with SIGTERM iterations, a second run
    # times their window: the first one built the kernels and the C
    # parser, which the interrupted runs find built
    schedule = mode_schedule(modes, iterations, seed)
    reference = b""
    window = (0.4, 2.2)
    for name in ("reference", "reference_warm")[
            :2 if "sigterm" in schedule else 1]:
        ref_work = os.path.join(workdir, name)
        os.makedirs(ref_work, exist_ok=True)
        ref_tsv = os.path.join(ref_work, "clusters.tsv")
        ref_ckpt = os.path.join(ref_work, "ckpt")
        proc = launch(cluster_argv(
            genomes, ref_tsv, ref_ckpt,
            os.path.join(ref_work, "report.json"), resume=False,
            precluster=precluster), extra_env)
        stdout, started, wall = run_marking(
            proc, os.path.join(ref_ckpt, "fingerprint.json"))
        window = sigterm_window(wall, started)
        if proc.returncode != 0:
            print(f"FATAL: {name} run failed:\n"
                  + stdout.decode(errors="replace")[-3000:])
            return iterations or 1
        with open(ref_tsv, "rb") as f:
            got = f.read()
        if reference and got != reference:
            print("FATAL: two uninterrupted runs wrote different TSVs")
            return iterations or 1
        reference = got
    if verbose:
        nlines = reference.count(b"\n")
        print(f"reference clustering: {len(reference)} bytes, "
              f"{nlines} lines")

    failures = 0
    for i, mode in enumerate(schedule):
        paged = overlap and i % 2 == 1
        ok, detail = run_iteration(genomes, reference, workdir, mode,
                                   seed * 1000 + i,
                                   precluster=precluster,
                                   extra_env=paged_env if paged
                                   else extra_env, window=window)
        status = "PASS" if ok else "FAIL"
        label = f"{mode}+paged" if paged else mode
        if verbose or not ok:
            print(f"[{i + 1:2d}/{iterations}] {label:<16s} {status}")
            if verbose or not ok:
                for line in detail.splitlines():
                    if not ok or line.strip().startswith(
                            ("interrupted", "resume")):
                        print(f"      {line.strip()}")
        failures += 0 if ok else 1
    print(f"chaos: {iterations - failures}/{iterations} iterations "
          f"passed")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh tempdir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    ap.add_argument("--workload", default="cluster",
                    choices=("cluster", "cluster-overlap",
                             "index-insert", "fleet"),
                    help="what to kill: a checkpointed cluster run "
                         "(default), the same run with the overlapped "
                         "dataflow forced on — odd iterations force "
                         "the paged sketch tier instead "
                         "(cluster-overlap), an "
                         "incremental `index insert` against a "
                         "prebuilt index, or an elastic multi-worker "
                         "`fleet run` whose workers AND scheduler get "
                         "killed (fleet)")
    ap.add_argument("--device", default=None, choices=DEVICES,
                    help="the children's device (GALAH_TPU_PLATFORM); "
                         "default: the CLI's own, cuda unless "
                         "GALAH_TPU_PLATFORM says otherwise")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated interruption modes of the "
                         "cluster and index workloads, drawn "
                         f"round-robin (default {','.join(MODES)}; "
                         f"also {', '.join(EXTRA_MODES)})")
    args = ap.parse_args(argv)
    modes = tuple(m.strip() for m in args.modes.split(",") if m.strip())
    bad = sorted(set(modes) - set(MODES + EXTRA_MODES))
    if bad or not modes:
        ap.error(f"--modes: unknown mode(s) {bad}; choices: "
                 f"{MODES + EXTRA_MODES}")

    workdir = args.workdir or tempfile.mkdtemp(prefix="galah_chaos_")
    print(f"chaos scratch: {workdir}")
    t0 = time.monotonic()
    try:
        if args.workload == "index-insert":
            failures = run_index_harness(args.iterations, args.seed,
                                         workdir, device=args.device,
                                         modes=modes)
        elif args.workload == "fleet":
            failures = run_fleet_harness(args.iterations, args.seed,
                                         workdir, device=args.device)
        else:
            failures = run_harness(
                args.iterations, args.seed, workdir,
                overlap=args.workload == "cluster-overlap",
                device=args.device, modes=modes)
    finally:
        if not args.keep and not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    print(f"chaos wall: {time.monotonic() - t0:.1f} s "
          f"({args.workload}, device {args.device or 'default'})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
