"""Resize / pooling primitives with exact PyTorch semantics on NCHW tensors.

Counterpart of ``desenet_tpu/ops/resize.py``. The JAX package expresses
every resample as a separable matrix contraction so that it lands on the
TPU's matrix unit; here the ops are PyTorch's own (``F.interpolate``,
``F.adaptive_avg_pool2d``, ``F.max_pool2d``), which define the semantics the
JAX matrices reproduce. The numpy matrix constructors are kept verbatim: the
seg-tail kernel (``ops/seg_pallas.py``) takes its interpolation indices and
weights from ``_linear_matrix``, and the tests pin the torch ops against the
other two.

Model-layer functions here take and return NCHW tensors (the JAX functions
take NHWC).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic 1-D linear interpolation matrix."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = (i + 0.5) * n_in / n_out - 0.5
            src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@functools.lru_cache(maxsize=None)
def _nearest_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) one-hot matrix for torch 'nearest' (floor) indexing."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    idx = np.minimum((np.arange(n_out) * n_in // n_out), n_in - 1)
    m[np.arange(n_out), idx] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) averaging matrix with torch AdaptiveAvgPool boundaries:
    window i covers [floor(i*n_in/n_out), ceil((i+1)*n_in/n_out))."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)  # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW x to (H_out, W_out)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of NCHW x with torch floor-index semantics."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="nearest")


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsample of NCHW x (the PANet neck 2x)."""
    if scale == 1:
        return x
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on NCHW x."""
    return F.adaptive_avg_pool2d(x, out_hw)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(kernel=k, stride=1, padding=k//2) on NCHW x (the SPP pools)."""
    return F.max_pool2d(x, k, 1, k // 2)


# ---- the JAX package's separable forms, for the int8 and fp8 paths --------
#
# The int8 glue rounds a resample of int8 values back to int8, and the fp8
# storage mode rounds it to fp8: there the contraction's own rounding shows,
# so these compute as the JAX package does (``_apply_separable``): the
# (out, in) matrices applied over H, then over W, in f32; an fp8 input in
# bf16 (its DEFAULT-precision path) with the result cast back to the fp8
# dtype (``quant.to_f8``).


def _apply_separable(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray
                     ) -> torch.Tensor:
    from desenet_tpu_torch.quant import F8_DTYPES, to_f8

    dt = x.dtype
    cdt = torch.bfloat16 if dt == torch.bfloat16 or dt in F8_DTYPES \
        else torch.float32
    a = torch.from_numpy(mh).to(x.device, cdt)
    b = torch.from_numpy(mw).to(x.device, cdt)
    y = torch.matmul(a, x.to(cdt))  # (.., out_h, W)
    y = torch.matmul(y, b.t())  # (.., out_h, out_w)
    return to_f8(y, dt) if dt in F8_DTYPES else y.to(dt)


def resize_bilinear_separable(x: torch.Tensor, out_hw,
                              align_corners: bool = False) -> torch.Tensor:
    """``resize_bilinear`` as the JAX package computes it."""
    h, w = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[2:]) == (h, w):
        return x
    return _apply_separable(x, _linear_matrix(x.shape[2], h, align_corners),
                            _linear_matrix(x.shape[3], w, align_corners))


def adaptive_avg_pool_separable(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``adaptive_avg_pool`` as the JAX package computes it: the mean in
    f32 cast back for a 1x1 output, else the separable pool matrices."""
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    h, w = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (1, 1):
        from desenet_tpu_torch.quant import F8_DTYPES, to_f8

        m = x.float().mean(dim=(2, 3), keepdim=True)
        return to_f8(m, x.dtype) if x.dtype in F8_DTYPES else m.to(x.dtype)
    return _apply_separable(x, _adaptive_pool_matrix(x.shape[2], h),
                            _adaptive_pool_matrix(x.shape[3], w))


def upsample_nearest_repeat(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsample of NCHW x of any dtype (int8, fp8:
    ``F.interpolate`` takes neither) by repeating each pixel, as the JAX
    package's broadcast does; the result is channels_last in memory."""
    if scale == 1:
        return x
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(
        n, h, scale, w, scale, c)
    return y.reshape(n, h * scale, w * scale, c).permute(0, 3, 1, 2)


def broadcast_hw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """A (N, C, 1, 1) map broadcast to ``out_hw`` (the nearest resize of a
    1x1 source), materialized channels_last."""
    n, c = x.shape[:2]
    y = x.permute(0, 2, 3, 1).expand(n, int(out_hw[0]), int(out_hw[1]), c)
    return y.contiguous().permute(0, 3, 1, 2)
