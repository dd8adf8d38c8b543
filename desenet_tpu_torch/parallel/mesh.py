"""The process count and rank of a data-parallel run.

What ``desenet_tpu/parallel/mesh.py`` keeps that has a meaning without a
device mesh. The JAX package's mesh shards one program's batch over the
devices; here each process drives one device and holds its rows of the
global batch, so the data axis is the process group of
``torch.distributed`` (``multihost.init_multihost``), and its size and this
process's place on it are all the engine needs. The data x spatial mesh
(``--spatial``) is not ported (ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations

import torch.distributed as dist


def process_count() -> int:
    """Processes in the run (1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
