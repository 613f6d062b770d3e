"""The persistent, versioned on-disk sketch index: the port of
``galah_tpu/index/store.py``.

Layout of one single-owner directory (``docs/index.md``); every byte
goes through ``io/atomic.py``, and every file, field, frame, key order
and float repr is ``galah_tpu``'s, so either package reads and writes
the other's index:

  fingerprint.json    the sketch and threshold parameters and their
                      digest, written once by ``index build`` and
                      checked by every later open (an index is data:
                      a mismatch is refused, never wiped)
  genomes.jsonl       framed records {i, path, key}; ``key`` is the
                      digest the disk cache names the genome's
                      ``minhash`` entry by (``io/diskcache.entry_digest``)
  sketches.jsonl      framed records {i, hashes}: the bottom-k hashes as
                      u64 integers, unpadded, so reopening the index
                      never reads a FASTA file again
  pairs.jsonl         framed records {i, j, ani}: every sketch-ANI pair
                      at or above the precluster threshold, grouped by
                      the higher index
  gen-NNNNNN.json     one generation: committed log lengths,
                      representatives, memberships, tombstones
  MANIFEST.json       the commit pointer {generation: N}; log records
                      past the committed lengths are an uncommitted tail
  interruptions.jsonl the preemption chain (not part of the committed
                      bytes)

A generation commits by writing gen-N.json, then replacing
MANIFEST.json, each an atomic whole-file replace; log appends are
durable a record at a time. A writer killed at any instant leaves the
index loadable at the prior generation, and the next mutating open
truncates the uncommitted tails, so an interrupted and resumed
mutation writes the bytes an uninterrupted one writes. No committed
file holds a timestamp.

``galah_tpu``'s out-of-core sketch list (its pagestore tier) is not
ported: the port loads the live sketches into memory and, for insert
and query, into one matrix on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from galah_tpu_torch.io import atomic
from galah_tpu_torch.io.diskcache import entry_digest

logger = logging.getLogger(__name__)

INDEX_FORMAT = "galah-tpu-index"
INDEX_VERSION = 1

_FINGERPRINT = "fingerprint.json"
_MANIFEST = "MANIFEST.json"
_GENOMES = "genomes.jsonl"
_SKETCHES = "sketches.jsonl"
_PAIRS = "pairs.jsonl"
_INTERRUPTIONS = "interruptions.jsonl"


class IndexCorrupt(ValueError):
    """Committed index state failed validation (see `fsck`)."""


def index_params(ani: float, precluster_ani: float, sketch_size: int,
                 k: int, seed: int, algo: str) -> Dict[str, Any]:
    """The parameters an index is bound to (thresholds as fractions).
    No tool version: sketches and ANIs are bit-stable, so an upgrade
    must not orphan an index."""
    return {
        "method": "finch",
        "ani": float(ani),
        "precluster_ani": float(precluster_ani),
        "sketch_size": int(sketch_size),
        "k": int(k),
        "seed": int(seed),
        "algo": str(algo),
    }


def params_digest(params: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(params, sort_keys=True).encode()).hexdigest()


def genome_key(path: str, sketch_params: Dict[str, Any]) -> str:
    """A genome record's key: the digest of its ``minhash`` entry in the
    disk cache (path, size, ``mtime_ns``, kind and sketch params)."""
    return entry_digest(path, "minhash", sketch_params)


def _gen_name(generation: int) -> str:
    return f"gen-{generation:06d}.json"


@dataclasses.dataclass
class IndexState:
    """One committed generation, in memory."""

    generation: int
    genomes: List[str]                      # paths, greedy order
    keys: List[str]                         # genome_key of each
    sketches: List[np.ndarray]              # uint64 bottom-k, unpadded
    pairs: Dict[Tuple[int, int], float]     # i < j, precluster hits
    reps: List[int]                         # sorted ascending, live
    membership: Dict[int, int]              # live non-rep -> its rep
    tombstones: Set[int]

    @property
    def n_genomes(self) -> int:
        return len(self.genomes)

    @property
    def live(self) -> List[int]:
        return [g for g in range(len(self.genomes))
                if g not in self.tombstones]


def _empty_state() -> IndexState:
    return IndexState(generation=0, genomes=[], keys=[], sketches=[],
                      pairs={}, reps=[], membership={}, tombstones=set())


def _valid_frames(path: str) -> List[bytes]:
    """The raw bytes of each checksum-valid framed line, in file order:
    truncation keeps the committed bytes as they are, never
    re-serialized."""
    if not os.path.exists(path):
        return []
    out: List[bytes] = []
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if not line.strip():
                continue
            payload, sep, crc_hex = line.rpartition(
                atomic.FRAME_SEP.encode())
            if not sep:
                continue
            try:
                want = int(crc_hex, 16)
            except ValueError:
                continue
            if (zlib.crc32(payload) & 0xFFFFFFFF) != want:
                continue
            out.append(payload + sep + crc_hex + b"\n")
    return out


class IndexStore:
    """One index directory: the committed-state loader and the durable
    writer. Single-owner: opening for mutation sweeps ``*.tmp`` debris
    and truncates uncommitted log tails. The loaded state is read and
    replaced under ``_lock``, so readers may share a store across
    threads."""

    def __init__(self, path: str,
                 params: Optional[Dict[str, Any]] = None,
                 create: bool = False) -> None:
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._state: Optional[IndexState] = None
        fp_file = os.path.join(self.path, _FINGERPRINT)
        if create:
            if params is None:
                raise ValueError("creating an index requires params")
            os.makedirs(self.path, exist_ok=True)
            atomic.sweep_tmp(self.path)
            if os.path.exists(fp_file):
                stored = self._read_fingerprint()
                if stored["params"] != params:
                    diffs = [k for k in sorted(set(stored["params"])
                                               | set(params))
                             if stored["params"].get(k) != params.get(k)]
                    raise ValueError(
                        f"index at {self.path} was built with different "
                        f"parameters (mismatched: {', '.join(diffs)}); "
                        "delete the directory to rebuild")
            else:
                atomic.write_json(
                    fp_file,
                    {"format": INDEX_FORMAT, "version": INDEX_VERSION,
                     "params": params,
                     "digest": params_digest(params)},
                    indent=1, site="io.atomic.write[index.fingerprint]")
            self.params = params
            return
        if not os.path.exists(fp_file):
            raise ValueError(
                f"no index at {self.path} (missing {_FINGERPRINT}); "
                "run `galah-tpu index build` first")
        stored = self._read_fingerprint()
        if params is not None and stored["params"] != params:
            raise ValueError(
                f"index at {self.path} was built with different "
                "parameters; delete the directory to rebuild")
        self.params = stored["params"]

    def _read_fingerprint(self) -> Dict[str, Any]:
        fp_file = os.path.join(self.path, _FINGERPRINT)
        try:
            with open(fp_file) as f:
                stored = json.load(f)
        except (OSError, ValueError) as e:
            raise IndexCorrupt(
                f"unreadable index fingerprint at {fp_file}: {e}")
        if stored.get("format") != INDEX_FORMAT:
            raise IndexCorrupt(
                f"{fp_file} is not a {INDEX_FORMAT} fingerprint")
        if stored.get("digest") != params_digest(stored.get("params",
                                                            {})):
            raise IndexCorrupt(
                f"index fingerprint digest mismatch at {fp_file}")
        return stored

    @property
    def sketch_params(self) -> Dict[str, Any]:
        return {"sketch_size": self.params["sketch_size"],
                "k": self.params["k"], "seed": self.params["seed"],
                "algo": self.params["algo"]}

    # -- committed-state loader ---------------------------------------

    def generation(self) -> int:
        """The committed generation (0: built but never committed)."""
        mf = os.path.join(self.path, _MANIFEST)
        if not os.path.exists(mf):
            return 0
        try:
            with open(mf) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise IndexCorrupt(f"unreadable {mf}: {e}")
        gen = int(manifest.get("generation", 0))
        if gen < 1:
            raise IndexCorrupt(f"{mf} names invalid generation {gen}")
        return gen

    def load(self) -> IndexState:
        """The state MANIFEST.json points at (held; see `reload`)."""
        with self._lock:
            if self._state is None:
                self._state = self._load_generation(self.generation())
            return self._state

    def reload(self) -> IndexState:
        """Drop the held state and read the committed one again (a
        stale reader picks up a newer generation so)."""
        with self._lock:
            self._state = None
        return self.load()

    def _gen_manifest(self, generation: int) -> Dict[str, Any]:
        gf = os.path.join(self.path, _gen_name(generation))
        try:
            with open(gf) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise IndexCorrupt(
                f"generation manifest {gf} unreadable: {e}")

    def _load_generation(self, generation: int) -> IndexState:
        if generation == 0:
            return _empty_state()
        gen = self._gen_manifest(generation)
        n_genomes = int(gen["n_genomes"])
        n_pairs = int(gen["n_pairs"])

        grecs = self._committed(_GENOMES, n_genomes)
        srecs = self._committed(_SKETCHES, n_genomes)
        precs = self._committed(_PAIRS, n_pairs)

        genomes, keys, sketches = [], [], []
        for n, (g, s) in enumerate(zip(grecs, srecs)):
            if int(g["i"]) != n or int(s["i"]) != n:
                raise IndexCorrupt(
                    f"genome/sketch record {n} carries index "
                    f"{g['i']}/{s['i']}")
            genomes.append(g["path"])
            keys.append(g["key"])
            sketches.append(np.asarray(s["hashes"], dtype=np.uint64))
        pairs: Dict[Tuple[int, int], float] = {}
        for p in precs:
            i, j = int(p["i"]), int(p["j"])
            if not 0 <= i < j < n_genomes:
                raise IndexCorrupt(
                    f"pair record ({i}, {j}) out of range "
                    f"(n_genomes={n_genomes})")
            pairs[(i, j)] = float(p["ani"])
        return IndexState(
            generation=generation, genomes=genomes, keys=keys,
            sketches=sketches, pairs=pairs,
            reps=sorted(int(r) for r in gen["reps"]),
            membership={int(k): int(v)
                        for k, v in gen["membership"].items()},
            tombstones={int(t) for t in gen["tombstones"]})

    def _committed(self, name: str, count: int) -> List[Any]:
        """The first `count` records of a log: the committed region.
        Records past it are an uncommitted tail, ignored here."""
        fn = os.path.join(self.path, name)
        records, bad = atomic.read_jsonl(fn)
        if len(records) < count:
            raise IndexCorrupt(
                f"{fn} holds {len(records)} intact record(s) but the "
                f"committed generation requires {count}")
        if bad:
            # torn frames can only be tail debris (the committed region
            # was fsynced before its commit); the next mutation drops
            # them
            logger.debug("%s: %d torn frame(s) past the committed "
                         "region", fn, bad)
        return records[:count]

    # -- mutation: tail truncation, appends, commit -------------------

    def begin_mutation(self) -> IndexState:
        """Open for writing: sweep tmp debris, truncate every log to its
        committed length, drop orphaned future generation manifests,
        and return the committed state."""
        atomic.sweep_tmp(self.path)
        gen = self.generation()
        counts = {_GENOMES: 0, _SKETCHES: 0, _PAIRS: 0}
        if gen:
            m = self._gen_manifest(gen)
            counts[_GENOMES] = counts[_SKETCHES] = int(m["n_genomes"])
            counts[_PAIRS] = int(m["n_pairs"])
        for name, count in counts.items():
            self._truncate(name, count)
        # a kill between the gen-N write and the MANIFEST swap leaves a
        # manifest the pointer never reached
        for fn in os.listdir(self.path):
            if fn.startswith("gen-") and fn.endswith(".json"):
                try:
                    g = int(fn[4:-5])
                except ValueError:
                    continue
                if g > gen:
                    os.unlink(os.path.join(self.path, fn))
        with self._lock:
            self._state = None
        return self.load()

    def _truncate(self, name: str, count: int) -> None:
        fn = os.path.join(self.path, name)
        if not os.path.exists(fn):
            if count:
                raise IndexCorrupt(
                    f"{fn} is missing but the committed generation "
                    f"requires {count} record(s)")
            return
        frames = _valid_frames(fn)
        if len(frames) < count:
            raise IndexCorrupt(
                f"{fn} holds {len(frames)} intact record(s) but the "
                f"committed generation requires {count}")
        want = b"".join(frames[:count])
        with open(fn, "rb") as f:
            have = f.read()
        if have == want:
            return
        logger.info("Discarding uncommitted tail of %s (%d committed "
                    "record(s) kept)", fn, count)
        atomic.write_bytes(fn, want,
                           site="io.atomic.write[index.truncate]")

    def append_genome(self, i: int, path: str, key: str) -> None:
        atomic.append_jsonl(
            os.path.join(self.path, _GENOMES),
            {"i": i, "path": os.path.abspath(path), "key": key},
            site="io.atomic.append[index.genomes]")

    def append_sketch(self, i: int, hashes: np.ndarray) -> None:
        """`hashes` is the unpadded uint64 sketch; written as the u64
        integers."""
        atomic.append_jsonl(
            os.path.join(self.path, _SKETCHES),
            {"i": i, "hashes": [int(h) for h in hashes]},
            site="io.atomic.append[index.sketches]")

    def append_pairs(
            self, pairs: Sequence[Tuple[int, int, float]]) -> None:
        fn = os.path.join(self.path, _PAIRS)
        for i, j, ani in pairs:
            atomic.append_jsonl(fn, {"i": int(i), "j": int(j),
                                     "ani": float(ani)},
                                site="io.atomic.append[index.pairs]")

    def commit(self, state: IndexState) -> int:
        """Commit `state` as the next generation: its manifest, then the
        MANIFEST pointer (the atomic commit point)."""
        generation = self.generation() + 1
        gen = {
            "generation": generation,
            "n_genomes": len(state.genomes),
            "n_pairs": len(state.pairs),
            "reps": sorted(state.reps),
            "membership": {str(k): int(v) for k, v in
                           sorted(state.membership.items())},
            "tombstones": sorted(state.tombstones),
        }
        atomic.write_json(
            os.path.join(self.path, _gen_name(generation)), gen,
            indent=1, site="io.atomic.write[index.generation]")
        atomic.write_json(
            os.path.join(self.path, _MANIFEST),
            {"format": INDEX_FORMAT, "version": INDEX_VERSION,
             "generation": generation},
            indent=1, site="io.atomic.write[index.manifest]")
        state.generation = generation
        with self._lock:
            self._state = state
        return generation

    # -- interruption / resume chain ----------------------------------

    def record_interruption(self, info: Dict[str, Any]) -> None:
        atomic.append_jsonl(
            os.path.join(self.path, _INTERRUPTIONS), info,
            site="io.atomic.append[index.interrupts]")

    def load_interruptions(self) -> List[Dict[str, Any]]:
        records, bad = atomic.read_jsonl(
            os.path.join(self.path, _INTERRUPTIONS))
        if bad:
            logger.warning("Dropped %d torn interruption record(s) in "
                           "%s", bad, self.path)
        return records


# -- fsck --------------------------------------------------------------


def fsck(path: str) -> Dict[str, Any]:
    """Audit an index directory; never mutates it.

    Returns {"ok", "problems", "warnings", "generation", ...}. Torn or
    extra records past the committed lengths are warnings (a killed
    writer's uncommitted tail, which the next mutation drops); anything
    wrong inside the committed state is a problem.
    """
    path = os.path.abspath(path)
    problems: List[str] = []
    warnings: List[str] = []
    out: Dict[str, Any] = {"path": path, "ok": False,
                           "problems": problems, "warnings": warnings,
                           "generation": None, "genomes": 0,
                           "clusters": 0, "tombstones": 0, "pairs": 0}
    try:
        store = IndexStore(path)
    except (ValueError, IndexCorrupt) as e:
        problems.append(str(e))
        return out
    tmp = [f for f in os.listdir(path) if f.endswith(".tmp")]
    if tmp:
        warnings.append(f"{len(tmp)} .tmp debris file(s) "
                        "(sweep happens at next mutating open)")
    try:
        gen = store.generation()
    except IndexCorrupt as e:
        problems.append(str(e))
        return out
    out["generation"] = gen
    try:
        state = store.load()
    except IndexCorrupt as e:
        problems.append(str(e))
        return out
    # uncommitted tails and torn frames, per log
    for name, committed in ((_GENOMES, state.n_genomes),
                            (_SKETCHES, state.n_genomes),
                            (_PAIRS, len(state.pairs))):
        fn = os.path.join(path, name)
        records, bad = atomic.read_jsonl(fn)
        extra = len(records) - committed
        if extra:
            warnings.append(f"{name}: {extra} uncommitted tail "
                            "record(s)")
        if bad:
            warnings.append(f"{name}: {bad} torn/corrupt frame(s) "
                            "past the committed region")
    for fn in os.listdir(path):
        if fn.startswith("gen-") and fn.endswith(".json"):
            try:
                g = int(fn[4:-5])
            except ValueError:
                problems.append(f"unparseable generation file {fn}")
                continue
            if g > gen:
                warnings.append(f"orphan generation manifest {fn} "
                                "(commit pointer never reached it)")
    # decision-state invariants
    live = set(state.live)
    rep_set = set(state.reps)
    if not rep_set <= live:
        problems.append("representatives include tombstoned genomes")
    for g, r in state.membership.items():
        if g not in live:
            problems.append(f"membership recorded for dead genome {g}")
        if r not in rep_set:
            problems.append(
                f"genome {g} assigned to non-representative {r}")
        if g in rep_set:
            problems.append(f"representative {g} also has a "
                            "membership record")
    assigned = rep_set | set(state.membership)
    if gen and assigned != live:
        missing = sorted(live - assigned)[:5]
        extra_m = sorted(assigned - live)[:5]
        if missing:
            problems.append(f"live genomes without an assignment: "
                            f"{missing}")
        if extra_m:
            problems.append(f"assignments for unknown genomes: "
                            f"{extra_m}")
    for i, s in enumerate(state.sketches):
        # compared directly: a uint64 difference wraps when out of order
        if s.size > 1 and not bool(np.all(s[1:] > s[:-1])):
            problems.append(f"sketch {i} is not sorted-distinct")
    out.update(genomes=len(live), clusters=len(state.reps),
               tombstones=len(state.tombstones),
               pairs=len(state.pairs))
    out["ok"] = not problems
    return out
