"""The yardsticks of the YOLOv5 v7.0 instance-segmentation cell, counted
on the plain reference (``reference/v7seg.py``) and from the work the
served boxes ask for, never on the program.

- ``forward_flops``: ``FlopCounterMode`` over the reference's forward of
  one image on the meta device, convolutions and matmuls at 2 FLOPs a
  multiply-add (as ``counts/flops.py``): 265.6 GFLOP at 640, Proto
  included, the masks not (v7.0's published count is the same model's).
- ``mask_assembly_bound``: the least time the mask assembly's work could
  take on an H100 (``counts/bounds.bound_ms``): 2 x 32 operations (a
  multiply-add a coefficient) for each proto pixel inside each kept box's
  crop, float32 on the CUDA cores; the prototypes read once an image, 32
  float32 coefficients a kept box, and all ``max_det`` bit rows of every
  image written.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts.bounds import H100_F32_FLOPS, bound_ms
from benchmark.reference.v7seg import forward, param_specs


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of the reference's forward of one (h, w) image."""
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev) for n, s, _, _ in param_specs(cfg)}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        forward(cfg, P, torch.empty((1, 3, h, w), device=dev))
    return float(counter.get_total_flops())


def mask_assembly_bound(b: int, hp: int, wp: int, nm: int, max_det: int,
                        kept: float, crop_px: float,
                        itemsize: int = 2) -> tuple:
    """(ms, "bytes" or "operations") of one launch over ``b`` images of
    (nm, hp, wp) prototypes in ``itemsize`` bytes, ``kept`` boxes and
    ``crop_px`` proto pixels inside their crops, summed over the launch."""
    flops = 2.0 * nm * crop_px
    nbytes = b * nm * hp * wp * itemsize + 4 * nm * kept \
        + b * max_det * hp * wp / 8
    return bound_ms(flops, nbytes, H100_F32_FLOPS)
