"""Defaults and percentage parsing, copied from ``galah_tpu/config.py``
so both packages read the same numbers from the same flags."""

from __future__ import annotations


class Defaults:
    """Compile-time defaults (reference: src/lib.rs:39-47)."""

    ALIGNED_FRACTION = 0.15          # --min-aligned-fraction 15%
    FRAGMENT_LENGTH = 3000           # --fragment-length
    ANI = 95.0                       # --ani (percent)
    PRETHRESHOLD_ANI = 90.0          # --precluster-ani (percent)
    MINHASH_KMER = 21                # finch k (reference: src/finch.rs:33)
    MINHASH_SKETCH_SIZE = 1000       # finch bottom-k sketch size
    MINHASH_SEED = 0                 # murmur3 seed of the finch contract
    HASH_ALGO = "murmur3"            # --hash-algorithm
    PRECLUSTER_METHOD = "skani"
    CLUSTER_METHOD = "skani"         # choices: skani, fastani
    QUALITY_FORMULA = "Parks2020_reduced"
    ANI_SUBSAMPLE = 1                # --ani-subsample: FracMinHash c
    # genomes per durable `index insert` batch, the preemption boundary
    # (galah_tpu's GALAH_TPU_INDEX_BATCH default)
    INDEX_BATCH = 32


PRECLUSTER_METHODS = ("skani", "finch", "dashing")
HASH_ALGORITHMS = ("murmur3", "tpufast")
CLUSTER_METHODS = ("skani", "fastani")
QUALITY_FORMULAS = (
    "Parks2020_reduced",
    "completeness-4contamination",
    "completeness-5contamination",
    "dRep",
)


def parse_percentage(value: float, name: str = "value") -> float:
    """Normalize a percentage argument to a fraction in [0, 1].

    Values in [1, 100] are percent (so exactly 1 means 1%, not 100%);
    values in [0, 1) are already fractions; anything else is an error
    (reference: src/cluster_argument_parsing.rs:1160-1182).
    """
    v = float(value)
    if 1.0 <= v <= 100.0:
        return v / 100.0
    if 0.0 <= v < 1.0:
        return v
    raise ValueError(f"{name} must be within [0, 100], got {value}")
