"""Exact-ANI backends and the skani-style, finch and dashing
preclusterers, over the two contracts of ``backends/base.py``."""

from galah_tpu_torch.backends.base import (  # noqa: F401
    ClusterBackend,
    PreclusterBackend,
)

from galah_tpu_torch.backends.fragment_backend import (  # noqa: F401
    FastANIEquivalentClusterer,
    ProfileStore,
    SkaniEquivalentClusterer,
    SkaniPreclusterer,
)
from galah_tpu_torch.backends.hll_backend import (  # noqa: F401
    HLLPreclusterer,
    HLLStore,
)
from galah_tpu_torch.backends.minhash_backend import (  # noqa: F401
    MinHashPreclusterer,
    SketchStore,
)
