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

from desenet_tpu_torch.parallel import spatial


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
    """torch.nn.AdaptiveAvgPool2d on NCHW x; of a band, the pool of the
    whole map on every rank (``_band_adaptive_pool``)."""
    if spatial.active():
        return _band_adaptive_pool(x, out_hw)
    return F.adaptive_avg_pool2d(x, out_hw)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(kernel=k, stride=1, padding=k//2) on NCHW x (the SPP pools);
    of a band, with its -inf halo (``spatial.max_pool_same``)."""
    if spatial.active():
        return spatial.max_pool_same(x, k)
    return F.max_pool2d(x, k, 1, k // 2)


# ---- bands of a height-sharded map (``parallel/spatial.py``) --------------
#
# A band's slice of the (out, in) H matrix names the input rows it needs:
# the pools sum the band's rows into every bin (``spatial_sum`` adds the
# ranks' partial sums), the resizes fetch the few rows past the band that
# its output rows read (``spatial.rows``). The contractions run in the
# band's dtype (f32 for f32 and bf16 under autocast, as matmuls go).


def _contract(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray
              ) -> torch.Tensor:
    a = torch.from_numpy(np.ascontiguousarray(mh)).to(x.device, x.dtype)
    b = torch.from_numpy(np.ascontiguousarray(mw)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(a, x), b.t())


def _band_adaptive_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The adaptive average pool of the whole map of the band ``x``, on
    every spatial rank: the band's partial bin sums (in at least f32),
    added over the ranks."""
    oh, ow = (out_hw, out_hw) if isinstance(out_hw, int) else out_hw
    ctx = spatial.current()
    starts, stops, h = spatial.band_of(ctx, x.shape[2])
    s, e = starts[ctx.me], stops[ctx.me]
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    if (oh, ow) == (1, 1):
        part = xa.sum((2, 3), keepdim=True) / float(h * x.shape[3])
    else:
        part = _contract(xa, _adaptive_pool_matrix(h, oh)[:, s:e],
                         _adaptive_pool_matrix(x.shape[3], ow))
    return spatial.spatial_sum(part).to(x.dtype)


def resize_bilinear_band(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``resize_bilinear(x, (H * scale, W * scale), align_corners=True)``;
    of a band, this rank's band of the resized map (``scale`` times its
    rows), from the rows the band's output rows read."""
    h, w = x.shape[2:]
    if not spatial.active():
        return resize_bilinear(x, (h * scale, w * scale), align_corners=True)
    ctx = spatial.current()
    starts, stops, h = spatial.band_of(ctx, h)
    m = _linear_matrix(h, h * scale, True)
    spans = []
    for s, e in zip(starts, stops):
        cols = np.nonzero(m[s * scale:e * scale].any(0))[0]
        spans.append((int(cols[0]), int(cols[-1]) + 1))
    a, b = spans[ctx.me]
    mh = m[starts[ctx.me] * scale:stops[ctx.me] * scale, a:b]
    return _contract(spatial.rows(x, spans), mh,
                     _linear_matrix(w, w * scale, True))


def resize_bilinear_onto(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The align_corners bilinear resize of ``y`` to ``x``'s size; where
    ``x`` is a band and ``y`` a whole (pooled) map, to ``x``'s band of the
    whole map's size."""
    if not spatial.active():
        return resize_bilinear(y, x.shape[2:], align_corners=True)
    ctx = spatial.current()
    starts, stops, h = spatial.band_of(ctx, x.shape[2])
    mh = _linear_matrix(y.shape[2], h, True)[starts[ctx.me]:stops[ctx.me]]
    return _contract(y, mh, _linear_matrix(y.shape[3], x.shape[3], True))


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
