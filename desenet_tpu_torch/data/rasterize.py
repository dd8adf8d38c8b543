"""Polygon -> class-id mask rasterization.

The port's own copy of ``desenet_tpu/data/rasterize.py``: PIL's
``ImageDraw.polygon`` fill, where later polygons overwrite earlier ones and
polygons with fewer than 3 points are ignored. The native rasterizer
(``native.rasterize_polygons_native``, bit-identical to PIL) draws by
default; a mask with a degenerate polygon (self-intersecting or with a
repeated vertex), which the library refuses, is drawn with PIL, and so is
every mask under ``DESENET_NATIVE_RASTER=0`` or ``DESENET_NATIVE=0``. PIL
is imported inside the function that draws with it.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np


def rasterize_polygons(
    seg: Sequence[Tuple[int, np.ndarray]], hw: Tuple[int, int]
) -> np.ndarray:
    """seg: list of (cls_id, (k,2) pixel polygon). Returns (H, W) int32."""
    if os.environ.get("DESENET_NATIVE_RASTER", "1") == "1":
        from desenet_tpu_torch.native import rasterize_polygons_native

        out = rasterize_polygons_native(seg, hw)
        if out is not None:
            return out
    return rasterize_polygons_pil(seg, hw)


def rasterize_polygons_pil(
    seg: Sequence[Tuple[int, np.ndarray]], hw: Tuple[int, int]
) -> np.ndarray:
    """The PIL path of ``rasterize_polygons``."""
    from PIL import Image, ImageDraw

    cls = np.zeros(hw, dtype=np.int32)
    for cls_id, pts in seg:
        if len(pts) <= 2:
            continue
        mask = Image.new("L", (hw[1], hw[0]), 0)
        draw = ImageDraw.Draw(mask)
        draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
        cls[np.asarray(mask, dtype=bool)] = int(cls_id)
    return cls
