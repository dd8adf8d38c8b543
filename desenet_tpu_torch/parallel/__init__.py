"""Multi-process parallelism over ``torch.distributed``: one process a
device, the global batch split over the processes (``multihost``), the
rank grid of a data x spatial run (``mesh``) and the height-sharded
feature maps of its spatial axis (``spatial``)."""

from desenet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    check_spatial,
    make_mesh,
    pad_batch_for_mesh,
    process_count,
    process_index,
    shard_batch,
)

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "Mesh", "check_spatial",
           "make_mesh", "pad_batch_for_mesh", "process_count",
           "process_index", "shard_batch"]
