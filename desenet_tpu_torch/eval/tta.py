"""Test-time augmentation: scales [1, 0.83, 0.67] with flips [none, lr,
none]; each variant runs the model at its own padded shape, and the decoded
predictions are mapped back and concatenated for one NMS pass.

The port's copy of ``desenet_tpu/eval/tta.py``, on NCHW tensors (the JAX
functions take NHWC).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops.resize import resize_bilinear

TTA_VARIANTS: Tuple[Tuple[float, str], ...] = (
    (1.0, ""), (0.83, "lr"), (0.67, ""),
)


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Resize NCHW ``x`` by ``ratio`` (the size truncated, bilinear without
    align_corners) and pad bottom and right to a multiple of ``gs`` with
    the ImageNet-mean gray 0.447 in ``x``'s dtype."""
    if ratio == 1.0:
        return x
    h, w = x.shape[2:]
    hs, ws = int(h * ratio), int(w * ratio)
    x = resize_bilinear(x, (hs, ws), align_corners=False)
    hp = math.ceil(hs / gs) * gs
    wp = math.ceil(ws / gs) * gs
    return F.pad(x, (0, wp - ws, 0, hp - hs), value=0.447)


def descale_pred(p: torch.Tensor, flip: str, scale: float,
                 img_hw: Tuple[int, int]) -> torch.Tensor:
    """Undo the scale, then the flip, on a (B, A, 5+nc) decode."""
    xy = p[..., 0:2] / scale
    wh = p[..., 2:4] / scale
    if flip == "ud":
        xy = torch.stack([xy[..., 0], img_hw[0] - xy[..., 1]], -1)
    elif flip == "lr":
        xy = torch.stack([img_hw[1] - xy[..., 0], xy[..., 1]], -1)
    return torch.cat([xy, wh, p[..., 4:]], -1)


def _flip(x: torch.Tensor, flip: str) -> torch.Tensor:
    if flip == "lr":
        return x.flip(3)
    if flip == "ud":
        return x.flip(2)
    return x


def _cat(dec) -> torch.Tensor:
    """A decode, or the per-scale list of one (``decode_cat=False``), as one
    (B, A, 5+nc) tensor."""
    return torch.cat(list(dec), 1) if isinstance(dec, (list, tuple)) else dec


def forward_augment(model, x: torch.Tensor, plain=None) -> torch.Tensor:
    """The variants' decodes mapped back and concatenated: (B, sum A, 5+nc),
    ready for NMS. ``plain``: ``model(x)``'s output where the caller already
    has it; the identity variant takes it instead of a second forward."""
    return forward_augment_joint(model, x, with_seg=False, plain=plain)[0]


@torch.inference_mode()
def forward_augment_joint(model, x: torch.Tensor, with_seg: bool = True,
                          plain=None):
    """Joint TTA on NCHW ``x`` in [0, 1]: (the decodes concatenated, as
    ``forward_augment``; the seg logits of the variants averaged in f32 on
    ``x``'s grid, or None without ``with_seg``). Each variant's logits lose
    their stride padding, are resized back (bilinear, no align_corners) and
    unflipped. The seg average needs full-resolution logits
    (``seg_upsample=True``); a 1/8-resolution head raises ValueError."""
    img_hw = tuple(x.shape[2:])
    gs = max(model.spec.det_strides)
    mf = (torch.channels_last
          if x.is_contiguous(memory_format=torch.channels_last)
          and not x.is_contiguous() else torch.contiguous_format)
    outs, segs = [], []
    for scale, flip in TTA_VARIANTS:
        if (scale, flip) == (1.0, "") and plain is not None:
            xi, ((dec, _), seg) = x, plain
        else:
            xi = scale_img(_flip(x, flip), scale, gs).contiguous(
                memory_format=mf)
            (dec, _), seg = model(xi)
        outs.append(descale_pred(_cat(dec), flip, scale, img_hw))
        if not with_seg:
            continue
        if tuple(seg.shape[2:]) != tuple(xi.shape[2:]):
            raise ValueError(
                "seg TTA needs full-resolution seg logits; build the model "
                f"with seg_upsample=True (got seg {tuple(seg.shape[2:])} for "
                f"input {tuple(xi.shape[2:])})")
        if scale != 1.0:
            hs, ws = int(img_hw[0] * scale), int(img_hw[1] * scale)
            seg = resize_bilinear(seg[:, :, :hs, :ws], img_hw,
                                  align_corners=False)
        segs.append(_flip(seg, flip).float())
    dec = torch.cat(outs, 1)
    if not with_seg:
        return dec, None
    return dec, torch.stack(segs).mean(0)
