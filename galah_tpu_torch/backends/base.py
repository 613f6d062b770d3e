"""The two backend contracts an embedding tool codes against: the port
of ``galah_tpu/backends/base.py`` (reference: src/lib.rs:23-37).

* ``PreclusterBackend.distances(paths)``: the sparse pair cache of a
  cheap all-pairs pass (ANI fractions of the pairs i < j that pass).
* ``ClusterBackend.calculate_ani_batch(pairs)``: exact ANI of many
  (path_a, path_b) pairs at once, None where the aligned-fraction gate
  fails, so a backend can evaluate a whole batch on the device.

ANI values are fractions in [0, 1].
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from galah_tpu_torch.cluster.cache import PairDistanceCache


class PreclusterBackend(abc.ABC):
    """Cheap sketch-based all-pairs pass producing the sparse pair cache."""

    @abc.abstractmethod
    def method_name(self) -> str: ...

    @abc.abstractmethod
    def distances(self, genome_paths: Sequence[str]) -> "PairDistanceCache":
        """ANI fraction for every i < j pair passing the precluster
        threshold."""


class ClusterBackend(abc.ABC):
    """Exact-ANI backend driving the greedy clustering decisions."""

    # batch-size hint for callers assembling speculative pair batches:
    # batches that are a multiple of it fill the backend's device blocks
    # (1 = no blocking)
    pair_block_multiple: int = 1

    @abc.abstractmethod
    def method_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def ani_threshold(self) -> float:
        """Final clustering ANI threshold, as a fraction."""

    @abc.abstractmethod
    def calculate_ani_batch(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Optional[float]]:
        """ANI for each (path_a, path_b); None = failed aligned-fraction
        gate."""

    def calculate_ani(self, f1: str, f2: str) -> Optional[float]:
        return self.calculate_ani_batch([(f1, f2)])[0]

    def calculate_ani_batch_array(self, pairs: Sequence[Tuple[str, str]]
                                  ) -> np.ndarray:
        """The batch result as a float64 array, NaN where the backend
        returned None (NaN >= threshold is False, as ``ani is not None``
        guards on the host)."""
        anis = self.calculate_ani_batch(pairs)
        return np.array([np.nan if a is None else float(a) for a in anis],
                        dtype=np.float64)
