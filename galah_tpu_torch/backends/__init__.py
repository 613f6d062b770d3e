"""Exact-ANI backends and the skani-style preclusterer."""

from galah_tpu_torch.backends.fragment_backend import (  # noqa: F401
    FastANIEquivalentClusterer,
    ProfileStore,
    SkaniEquivalentClusterer,
    SkaniPreclusterer,
)
