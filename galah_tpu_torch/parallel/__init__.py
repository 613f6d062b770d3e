"""Scale-out: the pair passes sharded over a mesh of device slots
(``mesh``) and multi-process runs over ``torch.distributed``
(``distributed``). The port of ``galah_tpu/parallel/``."""

from galah_tpu_torch.parallel import distributed  # noqa: F401
from galah_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    auto_mesh,
    make_mesh,
    sharded_hll_threshold_pairs,
    sharded_screen_pairs,
    sharded_threshold_pairs,
)
