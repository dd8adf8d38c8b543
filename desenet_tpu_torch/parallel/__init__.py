"""Multi-process data parallelism over ``torch.distributed``: one process
a device, the global batch split over the processes (``multihost``), the
process count and rank (``mesh``)."""

from desenet_tpu_torch.parallel.mesh import process_count, process_index

__all__ = ["process_count", "process_index"]
