"""Polygon -> class-id mask rasterization.

The port's own copy of ``desenet_tpu/data/rasterize.py``'s PIL path (PIL's
``ImageDraw.polygon`` fill): later polygons overwrite earlier ones; polygons
with fewer than 3 points are ignored. The JAX package's optional C++
rasterizer is bit-identical to PIL by construction, so the masks are equal
either way. PIL is imported inside the function.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def rasterize_polygons(
    seg: Sequence[Tuple[int, np.ndarray]], hw: Tuple[int, int]
) -> np.ndarray:
    """seg: list of (cls_id, (k,2) pixel polygon). Returns (H, W) int32."""
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
