"""Data parallelism over torch.distributed ranks and device meshes (port of
future_od_tpu/parallel)."""
from future_od_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicate,
)
