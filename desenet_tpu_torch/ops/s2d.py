"""Space-to-depth-4 input layout of the phase stem (``models/layers.py``
``PhaseStemA``/``PhaseStemB``), the port's copy of
``desenet_tpu/ops/s2d.py``.

The host packs the served batch in this layout
(``native.assemble_batch_s2d4``, the permutation folded into the batch
copy); these helpers cover the small-batch and test paths.

Channel order is (pr, pc, ci): output channel ``(pr * 4 + pc) * C + ci``
holds input pixel ``(4y + pr, 4x + pc, ci)``, matching
``layers.phase_stem_kernel_a``. H or W not divisible by 4 raises
ValueError.
"""

from __future__ import annotations

import numpy as np
import torch


def _check(h: int, w: int) -> None:
    if h % 4 or w % 4:
        raise ValueError(f"s2d4 needs H, W divisible by 4, got {h}x{w}")


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """torch (B, H, W, C) -> (B, H/4, W/4, 16C), contiguous."""
    b, h, w, c = x.shape
    _check(h, w)
    x = x.reshape(b, h // 4, 4, w // 4, 4, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)


def space_to_depth4_np(x: np.ndarray) -> np.ndarray:
    """numpy (..., H, W, C) -> (..., H/4, W/4, 16C), contiguous."""
    *lead, h, w, c = x.shape
    _check(h, w)
    x = x.reshape(*lead, h // 4, 4, w // 4, 4, c)
    n = len(lead)
    x = np.moveaxis(x, (n + 1, n + 3), (n + 2, n + 3))
    return np.ascontiguousarray(x).reshape(*lead, h // 4, w // 4, 16 * c)
