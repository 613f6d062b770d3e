"""The library API: build and run the clusterer from another tool, as
CoverM embeds galah. The port of ``galah_tpu/api.py``, name for name
(reference: src/cluster_argument_parsing.rs:84-124, :897-1158,
:1265-1375):

    import argparse
    from galah_tpu_torch.api import (ClustererCommandDefinition,
                                     add_cluster_arguments,
                                     generate_galah_clusterer)

    defn = ClustererCommandDefinition(ani="dereplication-ani")
    parser = argparse.ArgumentParser()
    add_cluster_arguments(parser, defn)     # the renamed flags
    args = parser.parse_args()
    clusterer = generate_galah_clusterer(genome_paths, vars(args), defn,
                                         device="cuda")
    clusters = clusterer.cluster()          # indices into .genome_paths

A ``ClustererCommandDefinition`` holds the flag names as data, so the
embedding tool can rename them; every error names a flag under the
definition's name. The device is explicit: ``cuda`` unless the caller
asks for ``cpu``, and ``cuda`` without a GPU raises. The port's own
``cluster`` command (``cli.py``) is a consumer of the same functions
with the default definition.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from galah_tpu_torch.config import (CLUSTER_METHODS, HASH_ALGORITHMS,
                                    PRECLUSTER_METHODS, QUALITY_FORMULAS,
                                    Defaults, parse_percentage)
from galah_tpu_torch.resilience.quarantine import ON_BAD_GENOME_CHOICES


@dataclasses.dataclass(frozen=True)
class ClustererCommandDefinition:
    """Flag names as data, so an embedding tool can rename them.

    Each field is the long-option name (without leading dashes) of its
    parameter; the defaults are the standalone command's names
    (reference: GalahClustererCommandDefinition,
    cluster_argument_parsing.rs:90-124)."""

    ani: str = "ani"
    precluster_ani: str = "precluster-ani"
    min_aligned_fraction: str = "min-aligned-fraction"
    fragment_length: str = "fragment-length"
    precluster_method: str = "precluster-method"
    cluster_method: str = "cluster-method"
    quality_formula: str = "quality-formula"
    hash_algorithm: str = "hash-algorithm"
    ani_subsample: str = "ani-subsample"
    rep_scan_window: str = "rep-scan-window"
    rep_rounds: str = "rep-rounds"
    checkm_tab_table: str = "checkm-tab-table"
    checkm2_quality_report: str = "checkm2-quality-report"
    genome_info: str = "genome-info"
    min_completeness: str = "min-completeness"
    max_contamination: str = "max-contamination"
    threads: str = "threads"
    on_bad_genome: str = "on-bad-genome"

    def dest(self, flag_name: str) -> str:
        return flag_name.replace("-", "_")


def add_cluster_arguments(
    parser: argparse.ArgumentParser,
    definition: ClustererCommandDefinition = ClustererCommandDefinition(),
) -> None:
    """Add the clustering and quality flags under the definition's
    names, with ``galah_tpu``'s defaults, types and choices."""
    d = definition
    parser.add_argument(f"--{d.ani}", type=float, default=Defaults.ANI,
                        help="ANI threshold for clustering (default: 95)")
    parser.add_argument(f"--{d.precluster_ani}", type=float,
                        default=Defaults.PRETHRESHOLD_ANI,
                        help="Precluster ANI threshold (default: 90; equal "
                             "to the ANI threshold for skani+skani)")
    parser.add_argument(f"--{d.min_aligned_fraction}", type=float,
                        default=Defaults.ALIGNED_FRACTION * 100,
                        help="Min aligned fraction of two genomes for "
                             "clustering (default: 15)")
    parser.add_argument(f"--{d.fragment_length}", type=int,
                        default=Defaults.FRAGMENT_LENGTH,
                        help="Fragment length of the fastANI-style "
                             "calculation (default: 3000)")
    parser.add_argument(f"--{d.precluster_method}",
                        default=Defaults.PRECLUSTER_METHOD,
                        choices=PRECLUSTER_METHODS,
                        help="Precluster method: skani, finch or dashing "
                             "(default: skani)")
    parser.add_argument(f"--{d.cluster_method}",
                        default=Defaults.CLUSTER_METHOD,
                        choices=CLUSTER_METHODS,
                        help="Exact ANI method (default: skani)")
    parser.add_argument(f"--{d.checkm_tab_table}",
                        help="Output of `checkm qa .. --tab_table`")
    parser.add_argument(f"--{d.checkm2_quality_report}",
                        help="CheckM2 quality_report.tsv output")
    parser.add_argument(f"--{d.genome_info}",
                        help="dRep-style genome info CSV "
                             "(genome,completeness,contamination)")
    parser.add_argument(f"--{d.min_completeness}", type=float,
                        help="Ignore genomes with less completeness than "
                             "this percentage")
    parser.add_argument(f"--{d.max_contamination}", type=float,
                        help="Ignore genomes with more contamination than "
                             "this percentage")
    parser.add_argument(f"--{d.quality_formula}",
                        default=Defaults.QUALITY_FORMULA,
                        choices=QUALITY_FORMULAS,
                        help="Quality formula for ranking genomes "
                             "(default: Parks2020_reduced)")
    parser.add_argument(f"--{d.hash_algorithm}",
                        default=Defaults.HASH_ALGO,
                        choices=HASH_ALGORITHMS,
                        help="k-mer hash of the sketches and profiles: "
                             "murmur3 (the finch contract) or tpufast "
                             "(default: murmur3)")
    parser.add_argument(f"--{d.ani_subsample}", type=int,
                        default=Defaults.ANI_SUBSAMPLE,
                        help="FracMinHash compression of the exact ANI "
                             "stage: keep only the k-mers whose hash is "
                             "below 2^64/c (1 = every k-mer; skani's own "
                             "compression is 125). Higher is about c-fold "
                             "less membership work with a noisier "
                             "per-fragment identity (default: 1)")
    parser.add_argument(f"--{d.rep_scan_window}", type=int, default=None,
                        help="Speculative rep-scan batch width of the host "
                             "greedy strategy (GALAH_TPU_GREEDY_STRATEGY="
                             "host): genomes per window evaluated against "
                             "all current representatives in one backend "
                             "call (default: 128). Wider = fewer round "
                             "trips, more speculative ANIs; the waste is "
                             "the exact-ani-wasted counter of the run "
                             "report")
    parser.add_argument(f"--{d.rep_rounds}", type=int, default=None,
                        help="Device greedy-selection round width: genomes "
                             "speculatively taken per round of the "
                             "round-based representative scan (default: "
                             "1024)")
    parser.add_argument(f"--{d.threads}", "-t", type=int, default=1,
                        help="Host threads that read genomes ahead and "
                             "read assembly stats (default: 1)")
    parser.add_argument(f"--{d.on_bad_genome}",
                        default="error", choices=ON_BAD_GENOME_CHOICES,
                        help="What to do with unreadable genome FASTAs "
                             "(missing, empty, corrupt): 'error' aborts "
                             "on first touch (default); 'skip' "
                             "preflights every input, quarantines the "
                             "bad ones into quarantine.json next to "
                             "the outputs, and clusters the rest")


@dataclasses.dataclass
class GalahClusterer:
    """A clustering job over quality-ordered genome paths, ready to run.

    `genome_paths` is the filtered, quality-ordered list; `cluster()`
    returns clusters of indices into it, representative first
    (reference analog: GalahClusterer, cluster_argument_parsing.rs:84-88
    and its .cluster() at :1185)."""

    genome_paths: List[str]
    preclusterer: object   # backends.base.PreclusterBackend
    clusterer: object      # backends.base.ClusterBackend
    device: object         # torch.device the backends run on
    clock: object          # timing.StageClock the backends report to
    #: a cluster.checkpoint.ClusterCheckpoint, set by the caller
    checkpoint: Optional[object] = None
    #: the sketch settings a checkpoint's fingerprint holds, equal to
    #: galah_tpu's for the same values
    backend_params: Dict = dataclasses.field(default_factory=dict)
    #: host-scan speculative window (None = the engine's)
    rep_scan_window: Optional[int] = None
    #: device greedy-selection round width (None = the engine's)
    rep_rounds: Optional[int] = None
    #: genomes quarantined by the --on-bad-genome skip preflight (None
    #: under the default error policy)
    quarantine: Optional[object] = None

    def cluster(self) -> List[List[int]]:
        from galah_tpu_torch.cluster.engine import cluster as run

        return run(self.genome_paths, self.preclusterer, self.clusterer,
                   self.device, rep_rounds=self.rep_rounds,
                   clock=self.clock, checkpoint=self.checkpoint,
                   rep_scan_window=self.rep_scan_window)


def _get(values: Dict, definition: ClustererCommandDefinition,
         flag_name: str):
    return values.get(definition.dest(flag_name))


def quality_order_genomes(
    genome_paths: Sequence[str],
    values: Dict,
    definition: ClustererCommandDefinition = ClustererCommandDefinition(),
    threads: int = 1,
    missing_key: str = "checkm-input-missing",
    missing_msg: str = ("Since CheckM input is missing, genomes are not "
                        "being ordered by quality. Instead the order of "
                        "their input is being used"),
) -> Tuple[List[str], bool]:
    """Quality-filter and order `genome_paths` from `values`' inputs:
    (ordered paths, whether a quality input was used). With no quality
    input the paths keep their input order and `missing_msg` is warned
    once a process under `missing_key` (``index`` passes its own).
    Conflicting quality inputs raise ValueError."""
    from galah_tpu_torch import quality

    d = definition
    return quality.quality_order_genomes(
        genome_paths,
        checkm_tab_table=_get(values, d, d.checkm_tab_table),
        checkm2_quality_report=_get(values, d, d.checkm2_quality_report),
        genome_info=_get(values, d, d.genome_info),
        formula=_get(values, d, d.quality_formula),
        min_completeness=_get(values, d, d.min_completeness),
        max_contamination=_get(values, d, d.max_contamination),
        threads=threads, missing_msg=missing_msg, missing_key=missing_key,
        min_completeness_flag=f"--{d.min_completeness}",
        max_contamination_flag=f"--{d.max_contamination}")


def generate_galah_clusterer(
    genome_paths: Sequence[str],
    values: Dict,
    definition: ClustererCommandDefinition = ClustererCommandDefinition(),
    cache=None,
    quarantine_manifest=None,
    device="cuda",
    clock=None,
) -> GalahClusterer:
    """Check the values, quarantine unreadable genomes (under 'skip'),
    quality-filter and order the genomes, and build the backends on
    `device`.

    `values` is a vars(args)-style mapping keyed by the definition's
    dest names (reference analog: generate_galah_clusterer,
    cluster_argument_parsing.rs:897-1158). `cache` is an
    ``io.diskcache.CacheDir`` (by default the one ``GALAH_TPU_CACHE``
    names, if any), `clock` a ``timing.StageClock`` (by default a new
    one); quality ordering is its stage ``quality``. Every bad value is
    a ValueError naming its flag under the definition's name."""
    from galah_tpu_torch.backends import (
        FastANIEquivalentClusterer,
        HLLPreclusterer,
        HLLStore,
        MinHashPreclusterer,
        ProfileStore,
        SkaniEquivalentClusterer,
        SkaniPreclusterer,
        SketchStore,
    )
    from galah_tpu_torch.backends.fragment_backend import ANI_KMER
    from galah_tpu_torch.device import resolve_device
    from galah_tpu_torch.io import diskcache
    from galah_tpu_torch.ops.constants import MARKER_C
    from galah_tpu_torch.ops.hll import DEFAULT_P
    from galah_tpu_torch.resilience.quarantine import preflight_quarantine
    from galah_tpu_torch.timing import StageClock

    d = definition
    device = resolve_device(device)
    clock = clock or StageClock(device)
    cache = cache or diskcache.get_cache(clock=clock)

    ani = parse_percentage(_get(values, d, d.ani), f"--{d.ani}")
    precluster_ani = parse_percentage(
        _get(values, d, d.precluster_ani), f"--{d.precluster_ani}")
    min_af = parse_percentage(
        _get(values, d, d.min_aligned_fraction),
        f"--{d.min_aligned_fraction}")
    fraglen = int(_get(values, d, d.fragment_length)
                  or Defaults.FRAGMENT_LENGTH)
    pre_method = _get(values, d, d.precluster_method)
    cl_method = _get(values, d, d.cluster_method)
    threads = int(_get(values, d, d.threads) or 1)
    hash_algo = _get(values, d, d.hash_algorithm) or Defaults.HASH_ALGO
    if hash_algo not in HASH_ALGORITHMS:
        raise ValueError(
            f"unknown hash algorithm {hash_algo!r}; "
            f"choices: {HASH_ALGORITHMS}")
    raw_subsample = _get(values, d, d.ani_subsample)
    ani_subsample = int(raw_subsample if raw_subsample is not None
                        else Defaults.ANI_SUBSAMPLE)
    if not 1 <= ani_subsample <= MARKER_C:
        raise ValueError(
            f"--{d.ani_subsample} must be in [1, {MARKER_C}], "
            f"got {ani_subsample}")
    raw_window = _get(values, d, d.rep_scan_window)
    rep_scan_window = int(raw_window) if raw_window is not None else None
    if rep_scan_window is not None and rep_scan_window < 1:
        raise ValueError(
            f"--{d.rep_scan_window} must be >= 1, got {rep_scan_window}")
    raw_rounds = _get(values, d, d.rep_rounds)
    rep_rounds = int(raw_rounds) if raw_rounds is not None else None
    if rep_rounds is not None and rep_rounds < 1:
        raise ValueError(
            f"--{d.rep_rounds} must be >= 1, got {rep_rounds}")
    on_bad = _get(values, d, d.on_bad_genome) or "error"
    if on_bad not in ON_BAD_GENOME_CHOICES:
        raise ValueError(
            f"unknown --{d.on_bad_genome} policy {on_bad!r}; "
            f"choices: {ON_BAD_GENOME_CHOICES}")

    # the quarantine comes before quality ordering, which reads every
    # genome itself; the default 'error' policy reads nothing here
    quarantine = quarantine_manifest
    genome_paths = list(genome_paths)
    if on_bad == "skip":
        genome_paths, quarantine = preflight_quarantine(
            genome_paths, quarantine_manifest, threads=threads, clock=clock)
        if not genome_paths:
            raise ValueError(
                "every input genome was quarantined as unreadable; "
                "nothing to cluster (see the quarantine manifest)")
    with clock.stage("quality"):
        genome_paths, _ = quality_order_genomes(genome_paths, values, d,
                                                threads=threads)

    # skani+skani: precluster at the final threshold (reference:
    # src/cluster_argument_parsing.rs:983-1030)
    if pre_method == "skani" and cl_method == "skani":
        precluster_ani = ani
    store = ProfileStore(device, fraglen=fraglen, clock=clock,
                         hash_algorithm=hash_algo, threads=threads,
                         cache=cache, subsample_c=ani_subsample)
    if pre_method == "finch":
        pre = MinHashPreclusterer(
            min_ani=precluster_ani,
            store=SketchStore(device, algo=hash_algo, clock=clock,
                              cache=cache),
            threads=threads)
    elif pre_method == "skani":
        pre = SkaniPreclusterer(threshold=precluster_ani,
                                min_aligned_fraction=min_af, store=store)
    elif pre_method == "dashing":
        pre = HLLPreclusterer(
            min_ani=precluster_ani,
            store=HLLStore(device, algo=hash_algo, clock=clock,
                           cache=cache),
            threads=threads)
    else:
        raise ValueError(f"unknown precluster method {pre_method!r}")
    if cl_method == "fastani":
        cl = FastANIEquivalentClusterer(
            threshold=ani, min_aligned_fraction=min_af, store=store)
    elif cl_method == "skani":
        cl = SkaniEquivalentClusterer(
            threshold=ani, min_aligned_fraction=min_af, store=store)
    else:
        raise ValueError(f"unknown cluster method {cl_method!r}")

    backend_params = {
        "minhash": {"sketch_size": Defaults.MINHASH_SKETCH_SIZE,
                    "k": Defaults.MINHASH_KMER, "seed": 0,
                    "algo": hash_algo},
        "hll": {"p": DEFAULT_P, "k": Defaults.MINHASH_KMER, "seed": 0,
                "algo": hash_algo},
        "fragment": {"k": ANI_KMER, "fraglen": fraglen,
                     "screen_identity": SkaniPreclusterer.SCREEN_IDENTITY,
                     # recorded only when active, as galah_tpu does, so
                     # default-path fingerprints stay the same
                     **({"subsample_c": ani_subsample}
                        if ani_subsample != 1 else {})},
    }
    return GalahClusterer(genome_paths=genome_paths, preclusterer=pre,
                          clusterer=cl, device=device, clock=clock,
                          backend_params=backend_params,
                          rep_scan_window=rep_scan_window,
                          rep_rounds=rep_rounds, quarantine=quarantine)
