"""The frozen yardstick: peaks of the card and the least time a kernel's
work could take on it.

A copy of the bound arithmetic of ``desenet_tpu_torch/tools/timing.py``
(the peaks, ``bound_ms``, ``seg_tail_bound`` and ``nms_fused_bound``),
kept here so that a change to the program cannot move its own yardstick.
The rates are NVIDIA's published ones for the H100 SXM at its full power
limit (dense, no sparsity).
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12       # HBM3
H100_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
NMS_PAIR_FLOPS = 16              # one IoU test of a pick against a candidate


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = H100_BF16_FLOPS) -> tuple:
    """(milliseconds, "bytes" or "operations"): the larger of ``nbytes``
    over the memory rate and ``flops`` over ``peak_flops``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seg_tail_bound(b: int, h: int, w: int, c: int, scale: int,
                   itemsize: int = 2) -> tuple:
    """K2 on (b, h, w, c) logits -> (b, h*scale, w*scale) uint8: two
    multiply-adds per output pixel and class for the separable bilinear
    blend and a compare per class, float32 on the CUDA cores; the logits
    read once, the class map written once."""
    out_px = b * h * scale * w * scale
    return bound_ms(out_px * (4 * c + c - 1), b * h * w * c * itemsize + out_px,
                    H100_F32_FLOPS)


def nms_fused_bound(b: int, a: int, max_det: int, candidates: float,
                    picks: float) -> tuple:
    """K1 on six (b, a) f32 planes -> (b, max_det, 6): the score plane read
    whole, the other five only at an image's ``candidates`` (4 bytes a
    field), the output rows written once; each of an image's ``picks`` is
    tested against its ``candidates`` (means per image, as the reference
    counts them on these inputs)."""
    nbytes = 4 * (b * a + 5 * b * candidates + 6 * b * max_det)
    return bound_ms(b * picks * candidates * NMS_PAIR_FLOPS, nbytes,
                    H100_F32_FLOPS)
