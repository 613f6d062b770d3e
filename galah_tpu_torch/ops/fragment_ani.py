"""Fragment-containment exact ANI: the port of ``ops/fragment_ani.py``.

A query genome is cut into windows of ``fraglen`` positions; every
valid canonical k-mer hash of a window is tested for membership in the
reference's distinct k-mer set (``ops/window_hits``, the CUDA kernel on
the card). A window with enough valid k-mers is a fragment; it is
aligned when its matched fraction implies identity >= the floor, and
ANI is the background-corrected mean identity over aligned windows.

Profiles (hashes, distinct set, markers, windows, sorted queries) are
torch tensors that stay on the device. The per-window integers are
folded on the device (``torch.bincount``); the float64 post-math runs
in host numpy as a verbatim copy of ``galah_tpu``'s, because its
compressed-segment ``np.add.reduceat`` order is what makes the floats
bit-identical (``torch.sum`` reduces in another order and could move a
value by one ulp across a threshold).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch import config
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.io.group import iter_groups, load_group
from galah_tpu_torch.ops import hashing
from galah_tpu_torch.ops.constants import MARKER_C, SENTINEL_BIASED
from galah_tpu_torch.ops.u64 import biased_scalar
from galah_tpu_torch.device import pinned, resolve_device
from galah_tpu_torch.ops import positional_hashes as k15
from galah_tpu_torch.ops.window_hits import window_element_hits

# Numeric contract (GL9xx): the per-window counts are integers; the ANI
# post-math accumulates in float64 over COMPRESSED segments (numpy's
# reduceat order, as galah_tpu), whatever the launch cut.
DETERMINISM_CONTRACT = {
    "family": "fragment",
    "dtype": "float64",
    "functions": ["directed_ani_arrays", "directed_ani_batch",
                  "bidirectional_ani_values", "_combine_bidirectional",
                  "_directed_from_counts_arrays", "_seq_sum",
                  "_segment_compressed_sums"],
}

# markers: hashes below 2^64 / MARKER_C, in the biased domain
MARKER_CUT_BIASED = biased_scalar((1 << 64) // MARKER_C)

# query elements (= int32 flags out) per window_hits launch: bounds the
# launch's flags plus the fold's window-id temporaries to ~2 GB
LAUNCH_ELEM_CAP = 1 << 27

#: the membership routes GALAH_TPU_FRAGMENT_STRATEGY may pin
#: (``galah_tpu``'s; the card refuses xla and c:
#: ``device.CUDA_REFUSED_PINS``). On the card ``pallas`` is
#: window_hits.cu; on the CPU all three run its plain version.
FRAGMENT_STRATEGIES = ("pallas", "xla", "c")

DEFAULT_MIN_WINDOW_VALID_FRAC = 0.5

# bases a profile group: its hashes take 8 B a window on the device, 128
# MB a group (``galah_tpu``'s ``PROFILE_BATCH_BUDGET``)
PROFILE_BATCH_BUDGET = 1 << 24


@dataclasses.dataclass
class GenomeProfile:
    """Device-resident k-mer views of one genome for exact ANI. Hash
    tensors are biased int64 (``ops/u64.py``)."""

    path: str
    k: int
    fraglen: int
    flat_hashes: torch.Tensor   # (n-k+1,) positional, sentinel-masked
    ref_set: torch.Tensor       # sorted distinct valid hashes
    markers: torch.Tensor       # ref_set below the marker cut
    subsample_c: int = 1

    _sorted_query: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None
    _totals_host: Optional[np.ndarray] = None

    @property
    def n_windows(self) -> int:
        return -(-self.flat_hashes.shape[0] // self.fraglen)

    def windows(self) -> torch.Tensor:
        """(W, fraglen) positional hash windows; the last k-1 slots of
        each window are masked, so no k-mer crosses a window boundary
        (fastANI's disjoint fragments). Built anew on each call: only
        sorted_query(), which is cached, needs them."""
        L, w = self.fraglen, self.n_windows
        flat = self.flat_hashes
        pad = torch.full((w * L,), SENTINEL_BIASED, dtype=torch.int64,
                         device=flat.device)
        pad[:flat.shape[0]] = flat
        wins = pad.reshape(w, L)
        wins[:, L - (self.k - 1):] = SENTINEL_BIASED
        return wins

    def sorted_query(self) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """(qh, qw, totals): the windows' valid hashes sorted ascending,
        their window ids (int32), and each window's valid count
        (int32). Sorted stably, so equal hashes keep window order."""
        if self._sorted_query is None:
            wins = self.windows()
            mask = wins != SENTINEL_BIASED
            totals = mask.sum(dim=1, dtype=torch.int32)
            rows = torch.nonzero(mask)[:, 0]
            qh, order = torch.sort(wins[mask], stable=True)
            self._sorted_query = (qh, rows[order].to(torch.int32), totals)
        return self._sorted_query

    def totals_host(self) -> np.ndarray:
        if self._totals_host is None:
            self._totals_host = self.sorted_query()[2].cpu().numpy()
        return self._totals_host


def check_subsample(subsample_c: int) -> None:
    """``--ani-subsample`` takes 1 <= c <= MARKER_C: the markers, the
    distinct hashes below 2^64 / MARKER_C, must survive the cut."""
    if not 1 <= subsample_c <= MARKER_C:
        raise ValueError(
            f"subsample_c must be in [1, {MARKER_C}], got {subsample_c}")


def subsample_mask(hashes: torch.Tensor, subsample_c: int) -> torch.Tensor:
    """`hashes` (biased) with every hash at or above 2^64 / c replaced
    by the sentinel: the FracMinHash subsample of skani's compression
    (reference: src/skani.rs:159-161). Positions keep their windows, so
    the per-window counts stay comparable; c = 1 keeps every hash."""
    return k15.apply_cut(hashes, k15.subsample_cut(subsample_c))


def build_profile(genome: Genome, k: int, fraglen: int, device="cuda",
                  subsample_c: int = 1,
                  hash_algorithm: str = "murmur3") -> GenomeProfile:
    """Profile a genome for fragment ANI, on `device`."""
    return build_profiles_batch([genome], k, fraglen, device, subsample_c,
                                hash_algorithm)[0]


def build_profiles_batch(genomes: Sequence[Genome], k: int, fraglen: int,
                         device="cuda", subsample_c: int = 1,
                         hash_algorithm: str = "murmur3"
                         ) -> List[GenomeProfile]:
    """Profiles of `genomes`, in order, on `device`, a group of at most
    ``PROFILE_BATCH_BUDGET`` bases at a time (``io/group.py``). Each
    genome's profile depends only on the genome, not on its group. With
    `subsample_c` > 1 only hashes below 2^64 / c stay (``subsample_mask``,
    before the distinct sets, as ``galah_tpu``'s ``_profile_from_flat``);
    the markers are then the masked distinct set's slice below 2^64 /
    MARKER_C, the same slice as unmasked since c <= MARKER_C."""
    check_subsample(subsample_c)
    device = resolve_device(device)
    out: List[GenomeProfile] = []
    for idx in iter_groups(genomes, PROFILE_BATCH_BUDGET):
        group = [genomes[i] for i in idx]
        flats = _group_flat_hashes(group, k, device, hash_algorithm,
                                   subsample_c)
        for g, flat, (ref_set, markers) in zip(group, flats,
                                               _distinct_sets(flats)):
            out.append(GenomeProfile(path=g.path, k=k, fraglen=fraglen,
                                     flat_hashes=flat, ref_set=ref_set,
                                     markers=markers,
                                     subsample_c=subsample_c))
    return out


def _group_flat_hashes(group: Sequence[Genome], k: int,
                       device: torch.device, algo: str,
                       subsample_c: int = 1) -> List[torch.Tensor]:
    """Each genome's positional hashes, subsampled. At k=15 the group's
    codes go to the device in one copy and through one launch of
    ``ops/positional_hashes.group_hashes`` (its kernel on cuda), which
    writes each genome's hashes, cut, into a tensor of its own, so a
    profile held in the LRU holds no other genome's hashes; other k take
    ``hashing.positional_hashes`` a genome."""
    if k != k15.K:
        return [subsample_mask(hashing.positional_hashes(g, k, device,
                                                         algo=algo),
                               subsample_c) for g in group]
    loaded = load_group(group, k, device)
    return k15.group_hashes(loaded.codes, loaded.starts, loaded.jobs,
                            algo=algo, subsample_c=subsample_c)


def _distinct_sets(flats: Sequence[torch.Tensor]
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(ref_set, markers) of each genome's positional hashes: the sorted
    distinct valid hashes, and their prefix below the marker cut (biased
    order is u64 order). Each genome is sorted on the device (the
    sentinel sorts last) and its first occurrences marked; the group's
    distinct and marker counts come to the host in one copy, and the
    sets are then compacted on the device by a scatter."""
    pending = []
    sizes = []
    for flat in flats:
        if flat.shape[0] == 0:
            pending.append(None)
            continue
        s = torch.sort(flat).values
        keep = s != SENTINEL_BIASED
        keep[1:] &= s[1:] != s[:-1]
        rank = torch.cumsum(keep, 0)
        below = torch.searchsorted(s, MARKER_CUT_BIASED).reshape(1)
        # distinct hashes below the cut: the rank just before it
        n_markers = torch.where(
            below > 0, rank.index_select(0, (below - 1).clamp(min=0)),
            torch.zeros_like(below))
        pending.append((s, keep, rank))
        sizes.append(torch.cat([rank[-1:], n_markers]))
    host = (torch.stack(sizes).cpu().tolist() if sizes else [])
    out = []
    it = iter(host)
    for item in pending:
        if item is None:
            empty = torch.zeros(0, dtype=torch.int64,
                                device=flats[0].device)
            out.append((empty, empty))
            continue
        s, keep, rank = item
        n_distinct, n_markers = next(it)
        ref = torch.empty(n_distinct + 1, dtype=torch.int64,
                          device=s.device)
        # every dropped hash lands in the spare last slot
        ref.scatter_(0, torch.where(keep, rank - 1, n_distinct), s)
        ref_set = ref[:n_distinct]
        out.append((ref_set, ref_set[:n_markers]))
    return out


@dataclasses.dataclass
class DirectedANI:
    ani: float               # mean identity over aligned windows (fraction)
    aligned_fraction: float  # aligned windows / valid windows
    frags_matching: int
    frags_total: int


# ---------------------------------------------------------------------------
# float64 host post-math: verbatim copies of galah_tpu/ops/fragment_ani.py
# ---------------------------------------------------------------------------


def _seq_sum(a: np.ndarray) -> float:
    """f64 sum in np.add.reduceat's order over a COMPRESSED array
    (masked entries compressed out, never zero-filled: interleaved +0.0
    terms shift reduceat's pairwise blocks and can move a ulp)."""
    if a.shape[0] == 0:
        return 0.0
    return float(np.add.reduceat(a, np.zeros(1, dtype=np.intp))[0])


def _segment_compressed_sums(
    values: np.ndarray,   # (W_total,) f64
    mask: np.ndarray,     # (W_total,) bool — which entries count
    starts: np.ndarray,   # (n_segs,) segment starts into values
) -> "Tuple[np.ndarray, np.ndarray]":
    """Per-segment (sum of values[mask], count of mask), each sum
    bit-identical to _seq_sum over that segment's compressed slice."""
    n = starts.shape[0]
    sums = np.zeros(n, dtype=np.float64)
    idx = np.flatnonzero(mask)
    counts = (np.searchsorted(idx, np.append(starts[1:],
                                             values.shape[0]))
              - np.searchsorted(idx, starts))
    if idx.size == 0:
        return sums, counts
    comp = values[idx]
    cstarts = np.searchsorted(idx, starts)
    nonempty = np.flatnonzero(counts > 0)
    sums[nonempty] = np.add.reduceat(
        comp, cstarts[nonempty].astype(np.intp))
    return sums, counts


def _directed_from_counts_arrays(
    matched_cat: np.ndarray,   # (W_total,) int32, segments per pair
    total_cat: np.ndarray,     # (W_total,) int32, aligned to matched
    starts: np.ndarray,        # (n_pairs,) int64 segment starts
    k: int,
    fraglen: int,
    subsample_c: int,
    identity_floor: float,
    min_window_valid_frac: float,
):
    """Per-pair (ani, af, frags_matching, frags_total) arrays from
    concatenated per-window (matched, valid) counts."""
    matched = matched_cat.astype(np.float64)
    total = total_cat.astype(np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.intp)

    min_valid = (min_window_valid_frac * (fraglen - k + 1)
                 / subsample_c)
    frag_ok = total >= max(min_valid, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        c_w = np.where(frag_ok, matched / np.maximum(total, 1.0), 0.0)
    c_floor = identity_floor ** k
    aligned = frag_ok & (c_w >= c_floor)

    frags_total = np.add.reduceat(
        frag_ok.astype(np.int64), starts)
    frags_matching = np.add.reduceat(
        aligned.astype(np.int64), starts)

    below = frag_ok & ~aligned
    sum_below, cnt_below = _segment_compressed_sums(c_w, below, starts)
    r_est = np.where(cnt_below > 0,
                     sum_below / np.maximum(cnt_below, 1), 0.0)

    seg_lens = np.diff(np.append(starts, matched.shape[0]))
    r_w = np.repeat(r_est, seg_lens)
    c_adj = np.clip((c_w - r_w) / np.maximum(1.0 - r_w, 1e-9),
                    1e-12, 1.0)
    sum_id, _ = _segment_compressed_sums(c_adj ** (1.0 / k), aligned,
                                         starts)

    has = frags_matching > 0
    ani = np.where(has, sum_id / np.maximum(frags_matching, 1), 0.0)
    af = np.where(
        has,
        frags_matching / np.maximum(frags_total, 1).astype(np.float64),
        0.0)
    return ani, af, frags_matching, frags_total


# ---------------------------------------------------------------------------
# device membership + fold
# ---------------------------------------------------------------------------

HitsFn = Callable[[Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   torch.device], torch.Tensor]


def resolve_fragment_strategy(device_type: str) -> str:
    """The exact-ANI membership route: a ``GALAH_TPU_FRAGMENT_STRATEGY``
    pin, else ``pallas``, the port's one route (``galah_tpu``'s AUTO
    takes its C merge or XLA on a CPU backend; the port runs
    window_hits' plain version there). On `device_type` ``cuda`` a pin
    of ``xla`` or ``c`` raises: the card runs window_hits.cu only."""
    env = pinned("GALAH_TPU_FRAGMENT_STRATEGY",
                 config.env_value("GALAH_TPU_FRAGMENT_STRATEGY"),
                 device_type)
    return env if env in FRAGMENT_STRATEGIES else "pallas"


def fragment_pairs_per_launch() -> Optional[int]:
    """``GALAH_TPU_FRAGMENT_PAIRS``: a cap on the directed queries in
    one window_hits launch, or None (the element cap alone decides)."""
    raw = config.env_value("GALAH_TPU_FRAGMENT_PAIRS")
    return max(1, int(raw)) if raw else None


def iter_launches(queries: Sequence[Tuple[GenomeProfile, GenomeProfile]]):
    """Index lists of the directed queries one window_hits launch
    covers: consecutive queries whose query elements fit under
    LAUNCH_ELEM_CAP (one oversized query still launches alone), and no
    more of them than ``GALAH_TPU_FRAGMENT_PAIRS`` when it is set.
    Queries without windows are left out; their result is all zero."""
    cap = LAUNCH_ELEM_CAP
    pair_cap = fragment_pairs_per_launch()
    chunk: List[int] = []
    vol = 0
    for n, (q, _r) in enumerate(queries):
        if q.n_windows == 0:
            continue
        m = int(q.sorted_query()[0].shape[0])
        if chunk and (vol + m > cap or len(chunk) == pair_cap):
            yield chunk
            chunk, vol = [], 0
        chunk.append(n)
        vol += m
    if chunk:
        yield chunk


def directed_ani_arrays(
    queries: Sequence[Tuple[GenomeProfile, GenomeProfile]],
    identity_floor: float = 0.80,
    min_window_valid_frac: float = DEFAULT_MIN_WINDOW_VALID_FRAC,
    hits: HitsFn = window_element_hits,
):
    """(ani, af, frags_matching, frags_total) arrays, one entry per
    directed (query, ref) pair. `hits` is the membership function; the
    default launches the CUDA kernel on the card (a comparison run may
    pass ``window_element_hits_plain``)."""
    n = len(queries)
    out_ani = np.zeros(n, dtype=np.float64)
    out_af = np.zeros(n, dtype=np.float64)
    out_fm = np.zeros(n, dtype=np.int64)
    out_ft = np.zeros(n, dtype=np.int64)
    if not queries:
        return out_ani, out_af, out_fm, out_ft
    shapes = {(q.k, q.fraglen, q.subsample_c) for pair in queries
              for q in pair}
    if len(shapes) != 1:
        raise ValueError(f"profiles built with different (k, fraglen, "
                         f"subsample_c) cannot be compared: {shapes}")
    (k, fraglen, subsample_c), = shapes
    device = queries[0][0].flat_hashes.device
    resolve_fragment_strategy(device.type)

    for chunk in iter_launches(queries):
        pairs = [queries[i] for i in chunk]
        flags = hits([(q.sorted_query()[0], r.ref_set) for q, r in pairs],
                     device)
        q_lens = torch.tensor([q.sorted_query()[0].shape[0]
                               for q, _ in pairs], device=device)
        n_win = np.array([q.n_windows for q, _ in pairs], dtype=np.int64)
        starts = np.zeros(len(pairs), dtype=np.int64)
        np.cumsum(n_win[:-1], out=starts[1:])
        # per element: its window's index in the launch's concatenated
        # window list, then one bincount folds flags into counts
        wid = torch.cat([q.sorted_query()[1] for q, _ in pairs]).to(
            torch.int64)
        wid += torch.repeat_interleave(
            torch.from_numpy(starts).to(device), q_lens)
        matched = torch.bincount(wid[flags != 0],
                                 minlength=int(n_win.sum()))
        ani, af, fm, ft = _directed_from_counts_arrays(
            matched.cpu().numpy().astype(np.int32),
            np.concatenate([q.totals_host() for q, _ in pairs]),
            starts, k, fraglen, subsample_c, identity_floor,
            min_window_valid_frac)
        out_ani[chunk] = ani
        out_af[chunk] = af
        out_fm[chunk] = fm
        out_ft[chunk] = ft
    return out_ani, out_af, out_fm, out_ft


def directed_ani_batch(
    queries: Sequence[Tuple[GenomeProfile, GenomeProfile]],
    identity_floor: float = 0.80,
    min_window_valid_frac: float = DEFAULT_MIN_WINDOW_VALID_FRAC,
    hits: HitsFn = window_element_hits,
) -> List[DirectedANI]:
    """Directed fragment ANI for many (query, ref) pairs, packed into
    as few window_hits launches as the launch cap allows."""
    ani, af, fm, ft = directed_ani_arrays(
        queries, identity_floor, min_window_valid_frac, hits)
    return [DirectedANI(float(ani[i]), float(af[i]), int(fm[i]),
                        int(ft[i])) for i in range(len(queries))]


# Repeat-merge hazard signature: the gate passes on an aligned fraction
# that is both MARGINAL (below margin x threshold) and ASYMMETRIC (the
# other direction far lower) — shared repeats, not genome-wide identity.
_HAZARD_AF_MARGIN = 2.0
_HAZARD_ASYMMETRY = 3.0


def _repeat_hazard(af_ab: float, af_ba: float,
                   min_aligned_frac: float) -> bool:
    hi, lo = max(af_ab, af_ba), min(af_ab, af_ba)
    return (hi < _HAZARD_AF_MARGIN * min_aligned_frac
            and hi >= _HAZARD_ASYMMETRY * lo)


def _warn_repeat_merge_hazard(af_hi: float, af_lo: float,
                              min_aligned_frac: float) -> None:
    warnings.warn(
        f"1 pair(s) passed the aligned-fraction gate marginally "
        f"and asymmetrically (e.g. {af_hi:.3f} vs {af_lo:.3f} against "
        f"threshold {min_aligned_frac:.3f}) — the signature of shared "
        "repeats/mobile elements rather than genome-wide identity; "
        "the reported ANI is the max over directions and may merge "
        "unrelated genomes. Consider raising --min-aligned-fraction.",
        RuntimeWarning, stacklevel=3)


def _combine_bidirectional(ab: DirectedANI, ba: DirectedANI,
                           min_aligned_frac: float) -> Optional[float]:
    """The reference's fastANI-wrapper gate (reference:
    src/fastani.rs:56-65): pass iff EITHER direction's matched-fragment
    fraction >= min_aligned_frac; the result is the max ANI."""
    af_ab = ab.frags_matching / max(ab.frags_total, 1)
    af_ba = ba.frags_matching / max(ba.frags_total, 1)
    gate = ((ab.frags_total > 0 and af_ab >= min_aligned_frac)
            or (ba.frags_total > 0 and af_ba >= min_aligned_frac))
    if not gate or (ab.frags_matching == 0 and ba.frags_matching == 0):
        return None
    if _repeat_hazard(af_ab, af_ba, min_aligned_frac):
        _warn_repeat_merge_hazard(max(af_ab, af_ba), min(af_ab, af_ba),
                                  min_aligned_frac)
    return max(ab.ani, ba.ani)


def bidirectional_ani_values(
    pairs: Sequence[Tuple[GenomeProfile, GenomeProfile]],
    min_aligned_frac: float,
    identity_floor: float = 0.80,
    hits: HitsFn = window_element_hits,
) -> List[Optional[float]]:
    """Gated max-over-directions ANI per pair (None when gated out);
    both directions of every pair go through one directed batch."""
    directed = directed_ani_batch(
        [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs],
        identity_floor=identity_floor, hits=hits)
    n = len(pairs)
    return [_combine_bidirectional(directed[i], directed[n + i],
                                   min_aligned_frac) for i in range(n)]
