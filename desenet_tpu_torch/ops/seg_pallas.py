"""Seg tail: bilinear 8x upsample + channel argmax to a uint8 class map.

Counterpart of ``desenet_tpu/ops/seg_pallas.py``. On a CUDA tensor
``upsample_argmax`` launches the hand-written kernel ``csrc/seg_tail.cu``
(kernel K2) or raises; on a CPU tensor it runs ``upsample_argmax_plain``,
the same arithmetic in PyTorch ops. Both read the interpolation taps from
``ops/resize._linear_matrix`` (the JAX kernel's matrices): two source
indices and two f32 weights per output row and column, y pass first, then
x, a strict ``>`` running argmax (the first channel wins ties, as
``jnp.argmax``). The full-resolution logits are never stored by the kernel.

The source holds two kernels and the wrapper picks one from the shape alone
(``pick_variant``; ``last_variant`` says which the last launch took).
``"span"``: one thread a source column and output row, making the run of
output pixels whose left tap is that column (``tap_runs``: 8 or 9 pixels at
scale 8 with ``align_corners``), stored 16 bytes at a time; it takes an
output width that is a multiple of 16, at most 512 source columns and runs
of at most 9 pixels. ``"pixel"``: one thread an output pixel, for every
other shape. Both give ``upsample_argmax_plain``'s map bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.ops.resize import _linear_matrix

launches = 0  # kernel launches made by upsample_argmax
last_variant = None  # "span" or "pixel": the kernel the last launch took
# seg_tail.cu's constants
SPAN_RUN = 9          # its longest run of pixels a column (kSpanRun)
SPAN_THREADS = 512    # its largest block (kSpanThreads)
SPAN_TILE_BYTES = 48 * 1024  # its shared-memory tile of output rows


@functools.lru_cache(maxsize=None)
def _taps_np(n_in: int, n_out: int, align_corners: bool):
    m = _linear_matrix(n_in, n_out, align_corners)
    idx = np.zeros((n_out, 2), np.int32)
    wts = np.zeros((n_out, 2), np.float32)
    for i, row in enumerate(m):
        nz = np.flatnonzero(row)
        idx[i] = (nz[0], nz[-1])
        wts[i] = (row[nz[0]], row[nz[-1]] if len(nz) > 1 else 0.0)
    return idx, wts


@functools.lru_cache(maxsize=64)
def seg_taps(n_in: int, n_out: int, align_corners: bool,
             device: torch.device):
    """(n_out, 2) int32 source indices and (n_out, 2) f32 weights of the 1-D
    linear interpolation ``_linear_matrix(n_in, n_out, align_corners)``, on
    ``device``. A row with one non-zero tap gets a second tap of weight 0."""
    idx, wts = _taps_np(n_in, n_out, align_corners)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wts).to(device))


@functools.lru_cache(maxsize=None)
def tap_runs(n_in: int, n_out: int, align_corners: bool):
    """The taps of one axis as the span kernel walks them: ``starts``
    ((n_in + 1,) int32: the output pixels whose first tap is source ``k`` are
    ``starts[k]`` up to ``starts[k + 1]``), the longest such run, and whether
    the kernel's reading of the second tap holds for every pixel: it is the
    next source (the last one is its own neighbour), or it carries weight 0
    and the pixel is the first of its run (it sits on source ``k``, which
    the kernel then reads twice) or lies in the last source's run."""
    idx, wts = _taps_np(n_in, n_out, align_corners)
    first = idx[:, 0]
    starts = np.searchsorted(first, np.arange(n_in + 1), "left").astype(
        np.int32)
    nxt = np.minimum(first + 1, n_in - 1)
    one_tap_ok = (np.arange(n_out) == starts[first]) | (first == n_in - 1)
    ok = bool(np.all(np.diff(first) >= 0)
              and np.all(np.where(wts[:, 1] == 0.0, one_tap_ok,
                                  idx[:, 1] == nxt)))
    return starts, int(np.diff(starts).max()), ok


@functools.lru_cache(maxsize=64)
def _tap_starts(n_in: int, n_out: int, align_corners: bool,
                device: torch.device):
    return torch.from_numpy(tap_runs(n_in, n_out, align_corners)[0]).to(device)


def span_config(w: int, wo: int, align_corners: bool):
    """(G, rpt) of the span kernel on ``w`` source and ``wo`` output
    columns: blocks of (w, G) threads that make G * rpt output rows each;
    None where it does not take the shape."""
    if wo % 16 or not 0 < w <= SPAN_THREADS:
        return None
    _, run, ok = tap_runs(w, wo, align_corners)
    if not ok or run > SPAN_RUN:
        return None
    g = max(1, 192 // w)
    rpt = min(8, SPAN_TILE_BYTES // (g * wo))
    return (g, rpt) if rpt >= 1 else None


def pick_variant(w: int, wo: int, align_corners: bool) -> str:
    """The kernel ``upsample_argmax`` launches on ``w`` source and ``wo``
    output columns: ``"span"`` where ``span_config`` takes the shape, else
    ``"pixel"``."""
    return "pixel" if span_config(w, wo, align_corners) is None else "span"


def upsample_argmax_plain(x: torch.Tensor, ys, wy, xs, wx) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: (B, h, w, C) -> (B, H, W)
    uint8, with the taps of ``seg_taps``."""
    xf = x.float()
    y0, y1 = ys[:, 0].long(), ys[:, 1].long()
    x0, x1 = xs[:, 0].long(), xs[:, 1].long()
    rows = xf[:, y0] * wy[:, 0, None, None] + xf[:, y1] * wy[:, 1, None, None]
    plane = rows[:, :, x0] * wx[:, 0, None] + rows[:, :, x1] * wx[:, 1, None]
    return plane.argmax(-1).to(torch.uint8)


def _check_logits(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected (B, h, w, C) logits, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16 logits, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upsample_argmax needs contiguous (B, h, w, C) logits")
    if not 0 < x.shape[3] <= 256:
        raise ValueError(f"{x.shape[3]} channels do not fit a uint8 class map")


def upsample_argmax_with(x: torch.Tensor, variant: str, scale: int = 8,
                         align_corners: bool = True) -> torch.Tensor:
    """``upsample_argmax`` on a CUDA tensor through the named kernel
    (``"span"`` or ``"pixel"``), for checks and timings that hold the two
    side by side; raises where the kernel does not take the shape."""
    global launches, last_variant
    _check_logits(x)
    if x.device.type != "cuda":
        raise ValueError(f"the {variant} kernel runs on CUDA, not {x.device}")
    b, h, w, c = x.shape
    ho, wo = h * scale, w * scale
    if variant == "span":
        cfg = span_config(w, wo, align_corners)
        if cfg is None:
            raise ValueError(f"the span kernel does not take {w} -> {wo} "
                             f"columns, align_corners {align_corners}")
    elif variant == "pixel":
        cfg = (0, 0)
    else:
        raise ValueError(f"no seg tail kernel {variant!r}")
    ys, wy = seg_taps(h, ho, align_corners, x.device)
    xs, wx = seg_taps(w, wo, align_corners, x.device)
    starts = _tap_starts(w, wo, align_corners, x.device)
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=x.device)
    stream, dev = _ext.stream_and_device(x)
    _ext.check(_ext.load().desenet_seg_tail(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ys.data_ptr(),
        wy.data_ptr(), xs.data_ptr(), wx.data_ptr(), starts.data_ptr(), b, h,
        w, c, ho, wo, int(variant == "span"), *cfg, out.data_ptr(), stream,
        dev),
        f"seg_tail kernel ({variant})")
    launches += 1
    last_variant = variant
    return out


def upsample_argmax(x: torch.Tensor, scale: int = 8,
                    align_corners: bool = True) -> torch.Tensor:
    """argmax_c(bilinear_resize(x, (h*scale, w*scale))) -> (B, H, W) uint8.

    x: contiguous (B, h, w, C) float32 or bfloat16 logits, the JAX
    function's NHWC layout (an NCHW ``channels_last`` tensor permuted with
    ``.permute(0, 2, 3, 1)`` is already that). The kernels read the taps the
    plain version reads and give its map bit for bit wherever the blended
    values hold no NaN; a NaN (an infinite logit times a weight of 0 at a
    one-tap pixel of its own row or column, or infinities of both signs in
    one blend) wins ``argmax`` in the plain version and never the kernels'
    strict ``>``."""
    _check_logits(x)
    b, h, w, c = x.shape
    if x.device.type == "cpu":
        return upsample_argmax_plain(
            x, *seg_taps(h, h * scale, align_corners, x.device),
            *seg_taps(w, w * scale, align_corners, x.device))
    if x.device.type != "cuda":
        raise ValueError(f"upsample_argmax runs on CPU or CUDA, not {x.device}")
    return upsample_argmax_with(
        x, pick_variant(w, w * scale, align_corners), scale, align_corners)
