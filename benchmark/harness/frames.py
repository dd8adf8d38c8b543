"""Synthetic camera frames, made on the device from the seed.

A frame is a smooth colour field (random 4x5 control points, bilinear) with
a number of solid rectangles of random colour and size on it, brought to
one exposure (each channel's mean 114 and spread 48, as a camera's
auto-exposure would), and a little pixel noise: texture at several scales
for the backbone, and edges for the heads. Every frame of a pool is
distinct. BGR uint8, as a camera or ``cv2.imread`` gives it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16  # frames drawn per call
EXPOSURE = (114.0, 48.0)  # each channel's mean and spread
RECTS = 12
SIDE = (0.04, 0.4)  # a rectangle's side: this plus up to that, of the frame
NOISE = 8.0  # pixel noise, +- this


def make_frames(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 BGR frames on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, h, 1)
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, w)
    for s in range(0, n, CHUNK):
        b = min(CHUNK, n - s)
        ctrl = torch.rand((b, 3, 4, 5), generator=g, device=device)
        img = F.interpolate(ctrl, size=(h, w), mode="bilinear",
                            align_corners=True) * 175.0 + 40.0
        r = torch.rand((b, RECTS, 7), generator=g, device=device)
        rh = (r[..., 0] * SIDE[1] + SIDE[0]) * h
        rw = (r[..., 1] * SIDE[1] + SIDE[0]) * w
        y0 = r[..., 2] * (h - rh)
        x0 = r[..., 3] * (w - rw)
        colour = r[..., 4:7] * 255.0
        for k in range(RECTS):  # later rectangles cover earlier ones
            inside = ((ys >= y0[:, k, None, None, None])
                      & (ys < (y0 + rh)[:, k, None, None, None])
                      & (xs >= x0[:, k, None, None, None])
                      & (xs < (x0 + rw)[:, k, None, None, None]))
            img = torch.where(inside, colour[:, k, :, None, None], img)
        mean = img.mean((2, 3), keepdim=True)
        std = img.std((2, 3), keepdim=True).clamp(min=1.0)
        img = (img - mean) / std * EXPOSURE[1] + EXPOSURE[0]
        img = img + (torch.rand((b, 3, h, w), generator=g, device=device)
                     - 0.5) * (2 * NOISE)
        out[s:s + b] = img.clamp(0, 255).round().to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def letterbox_rgb(frames_bgr, size: int, pad: int = 114):
    """numpy (n, h, w, 3) BGR frames no larger than ``size`` -> (n, size,
    size, 3) RGB, centred on a ``pad`` border, as the program's letterbox
    places an image that needs no resize (gain 1)."""
    import numpy as np

    n, h, w, _ = frames_bgr.shape
    if h > size or w > size or (h != size and w != size):
        raise ValueError(f"frames of {h}x{w} need a resize to {size}")
    top, left = (size - h) // 2, (size - w) // 2
    out = np.full((n, size, size, 3), pad, np.uint8)
    out[:, top:top + h, left:left + w] = frames_bgr[..., ::-1]
    return out


def letterbox_input(frames_bgr: torch.Tensor, size: int, pad: int = 114
                    ) -> torch.Tensor:
    """(n, h, w, 3) uint8 BGR frames on any device -> the network input
    (n, 3, size, size) float32 RGB in [0, 1], as ``letterbox_rgb`` places
    them."""
    n, h, w, _ = frames_bgr.shape
    if h > size or w > size or (h != size and w != size):
        raise ValueError(f"frames of {h}x{w} need a resize to {size}")
    top, left = (size - h) // 2, (size - w) // 2
    x = torch.full((n, 3, size, size), pad / 255.0, dtype=torch.float32,
                   device=frames_bgr.device)
    x[:, :, top:top + h, left:left + w] = frames_bgr.flip(-1).permute(
        0, 3, 1, 2).float() / 255.0
    return x
