"""The rank grid of a multi-process run: the data axis, and with
``spatial=k`` a spatial axis that splits every image's height.

Counterpart of ``desenet_tpu/parallel/mesh.py``, with its names. There one
program runs over a device mesh and GSPMD shards the batch (and, on a
``(data, spatial)`` mesh, the image height) and inserts the collectives.
Here each process drives one device, so the mesh is the world's processes
laid out as an ``n_data x spatial`` grid, adjacent ranks on the spatial
axis (as adjacent devices are there), with one process group for each
row and column of the grid (``make_mesh``). A process holds its data
row's images (``shard_batch``) and, on the spatial axis, one height band
of each; ``parallel/spatial.py`` is what GSPMD inserts between the
bands.

The band split differs from GSPMD's on purpose: each spatial rank takes a
whole number of ``max_stride``-row bands, as even as they go (672 px at
spatial 2 is 11 + 10 bands of 32 rows), so that every stride-2 conv's
window starts on a band's first row at every depth. GSPMD splits evenly
and pads a height that does not divide.

Without a process group a mesh is its layout alone (this process at
coordinate 0 on both axes, no groups): enough for ``check_spatial`` and
``pad_batch_for_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# batch keys whose dim 1 is image height, split over SPATIAL_AXIS
_SPATIAL_KEYS = ("image", "seg_labels")


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


@dataclass(frozen=True)
class Mesh:
    """An ``n_data x spatial`` grid of processes and this process's place
    on it. ``data_group`` holds the ranks of this process's spatial
    coordinate (the data axis: the gradient and the losses' normalizers
    run over it), ``spatial_group`` those of its data coordinate (the halo
    exchanges run over it); None where the axis has one process or there
    is no process group."""

    n_data: int
    spatial: int
    data_index: int = 0
    spatial_index: int = 0
    data_group: Any = None
    spatial_group: Any = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ((DATA_AXIS,) if self.spatial <= 1
                else (DATA_AXIS, SPATIAL_AXIS))

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, (self.n_data, self.spatial)))


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1) -> Mesh:
    """The world's ``n_devices`` processes (all of them by default) as a
    1-D data axis, or with ``spatial > 1`` as ``n_devices // spatial``
    data rows of ``spatial`` adjacent ranks. Every process of the group
    calls it, with the same arguments: it makes one process group for
    each row and each column, in one order on every rank."""
    pc = process_count()
    n = pc if n_devices is None else int(n_devices)
    if dist.is_available() and dist.is_initialized() and n != pc:
        raise ValueError(f"make_mesh({n}): the process group has {pc} "
                         "processes, one a device")
    sp = max(int(spatial), 1)
    if n % sp:
        raise ValueError(f"{n} devices not divisible by spatial={sp}")
    n_dp = n // sp
    rank = process_index()
    dp_i, sp_i = divmod(rank, sp)
    if pc == 1 or sp == 1:
        return Mesh(n_dp, sp, dp_i, sp_i)
    data_group = spatial_group = None
    for d in range(n_dp):  # every rank makes every group, in this order
        g = dist.new_group([d * sp + s for s in range(sp)])
        if d == dp_i:
            spatial_group = g
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(n_dp)])
        if s == sp_i:
            data_group = g
    return Mesh(n_dp, sp, dp_i, sp_i,
                data_group=data_group if n_dp > 1 else None,
                spatial_group=spatial_group)


def check_spatial(mesh: Mesh, img_size: int, max_stride: int = 32) -> None:
    """Raise if a spatially-partitioned run would shard the deepest feature
    map below 2 rows per device (the JAX package's validity floor, kept
    with its message)."""
    if SPATIAL_AXIS not in mesh.axis_names:
        return
    sp = mesh.shape[SPATIAL_AXIS]
    deepest = img_size // max_stride
    if deepest // sp < 2:
        raise ValueError(
            f"spatial={sp} shards the deepest feature map "
            f"({img_size}px / stride {max_stride} = {deepest} rows) below "
            f"2 rows per device; use img_size >= {2 * sp * max_stride} or "
            f"spatial <= {max(deepest // 2, 1)}"
        )


def band_counts(height: int, spatial: int, max_stride: int = 32
                ) -> Tuple[int, ...]:
    """The number of ``max_stride``-row bands of a ``height``-row image
    that each spatial rank takes: whole bands, the first ranks one more
    where they do not divide."""
    if height % max_stride:
        raise ValueError(f"height {height} is not a multiple of the stride "
                         f"{max_stride}")
    n = height // max_stride
    if n < spatial:
        raise ValueError(f"{height} rows hold {n} bands of {max_stride}, "
                         f"fewer than spatial={spatial}")
    per, extra = divmod(n, spatial)
    return tuple(per + (r < extra) for r in range(spatial))


def band_rows(height: int, spatial: int, index: int,
              max_stride: int = 32) -> slice:
    """The rows of a ``height``-row image that spatial rank ``index``
    holds (``band_counts``)."""
    counts = band_counts(height, spatial, max_stride)
    start = sum(counts[:index]) * max_stride
    return slice(start, start + counts[index] * max_stride)


def _rows(x, n_data: int, index: int):
    n = x.shape[0]
    if n % n_data:
        raise ValueError(f"batch of {n} not divisible by the {n_data} "
                         "data ranks (pad_batch_for_mesh)")
    per = n // n_data
    return x[index * per:(index + 1) * per]


def spatial_band(batch: dict, mesh: Mesh, max_stride: int = 32) -> dict:
    """This rank's height band of ``image`` and ``seg_labels`` (keys of
    ``_SPATIAL_KEYS`` of 3 or more dimensions, height at dim 1); the other
    keys as they are."""
    if mesh.spatial <= 1:
        return batch
    out = {}
    for k, v in batch.items():
        if k in _SPATIAL_KEYS and v.ndim >= 3:
            v = v[:, band_rows(v.shape[1], mesh.spatial, mesh.spatial_index,
                               max_stride)]
        out[k] = v
    return out


def shard_batch(batch: dict, mesh: Mesh, max_stride: int = 32) -> dict:
    """This process's part of a global batch dict: its data rank's rows of
    every array, and on a spatial mesh its height band of ``image`` and
    ``seg_labels`` (``band_counts``)."""
    rows = {k: _rows(v, mesh.n_data, mesh.data_index)
            for k, v in batch.items()}
    return spatial_band(rows, mesh, max_stride)


def pad_batch_for_mesh(batch: dict, mesh: Mesh):
    """Pad a batch dict of arrays (numpy or torch) up to a multiple of the
    data axis by repeating the last element; returns (padded_batch,
    n_valid), as the JAX package's."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % mesh.n_data
    if pad == 0:
        return batch, n

    def _pad(x):
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        import torch

        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

    return {k: _pad(v) for k, v in batch.items()}, n
