"""Box geometry for the serving path and the detection loss.

Counterpart of ``desenet_tpu/ops/boxes.py`` (what the served program and
the training loss use, and the JAX package's other public helpers:
``xyxy2xywh``, ``xywhn2xyxy``, ``xyxy2xywhn``, ``xyn2xy``, ``clip_coords``,
``scale_coords``, ``wh_iou``, ``bbox_ioa``) plus ``np_scale_coords``,
copied from ``desenet_tpu/eval/validator.py`` because that module imports
JAX. Boxes live in the last axis of size 4, on torch tensors.
"""

from __future__ import annotations

import math

import torch


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [cx,cy,w,h]."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """[cx,cy,w,h] -> [x1,y1,x2,y2]."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xywhn2xyxy(x: torch.Tensor, w=640, h=640, padw=0,
               padh=0) -> torch.Tensor:
    """Normalized [cx,cy,w,h] -> pixel [x1,y1,x2,y2], plus the letterbox
    pad offset."""
    cx, cy, bw, bh = x.unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh],
                       -1)


def xyxy2xywhn(x: torch.Tensor, w=640, h=640, clip: bool = False,
               eps: float = 0.0) -> torch.Tensor:
    """Pixel [x1,y1,x2,y2] -> normalized [cx,cy,w,h], clipped to the
    image (less ``eps``) first where ``clip``."""
    if clip:
        x = clip_coords(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([((x1 + x2) / 2) / w, ((y1 + y2) / 2) / h,
                        (x2 - x1) / w, (y2 - y1) / h], -1)


def xyn2xy(x: torch.Tensor, w=640, h=640, padw=0, padh=0) -> torch.Tensor:
    """Normalized point coordinates [x, y] -> pixel ones."""
    xs, ys = x.unbind(-1)
    return torch.stack([w * xs + padw, h * ys + padh], -1)


def clip_coords(boxes: torch.Tensor, shape) -> torch.Tensor:
    """xyxy boxes clipped to an image of ``shape`` (h, w)."""
    h, w = shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                        y2.clamp(0, h)], -1)


def scale_coords(img1_shape, coords: torch.Tensor, img0_shape,
                 ratio_pad=None) -> torch.Tensor:
    """xyxy ``coords`` from the letterboxed ``img1_shape`` (h, w) back to
    the native ``img0_shape`` (h, w), clipped to it. The gain is the
    smaller of the two ratios and the pad half the leftover, unless
    ``ratio_pad`` = ((gain, _), (padw, padh)) gives them."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    coords = coords - torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                                   dtype=coords.dtype, device=coords.device)
    return clip_coords(coords / gain, img0_shape)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (w, h) pairs centred at the origin: (N,2),(M,2) ->
    (N,M)."""
    wh1, wh2 = wh1[:, None], wh2[None]
    inter = torch.minimum(wh1, wh2).prod(2)
    return inter / (wh1.prod(2) + wh2.prod(2) - inter)


def bbox_ioa(box1: torch.Tensor, box2: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Intersection over box2's area: (4,),(N,4) -> (N,)."""
    iw = (torch.minimum(box1[2], box2[:, 2])
          - torch.maximum(box1[0], box2[:, 0])).clamp(min=0)
    ih = (torch.minimum(box1[3], box2[:, 3])
          - torch.maximum(box1[1], box2[:, 1])).clamp(min=0)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + eps
    return iw * ih / area2


def box_iou(box1: torch.Tensor, box2: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU matrix between xyxy boxes: (N,4),(M,4) -> (N,M)."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:4]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:4]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = ((box1[:, 2] - box1[:, 0]).clamp(min=0)
             * (box1[:, 3] - box1[:, 1]).clamp(min=0))
    area2 = ((box2[:, 2] - box2[:, 0]).clamp(min=0)
             * (box2[:, 3] - box2[:, 1]).clamp(min=0))
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def _clip0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, None)`` with its gradient: half at ``x == 0``, where
    ``clamp`` passes the whole gradient and ``relu`` none."""
    return torch.maximum(x, x.new_zeros(()))


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, x1y1x2y2: bool = True,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU between (..., 4) boxes, which
    broadcast (the detection loss calls it with ``CIoU=True`` on xywh)."""
    if x1y1x2y2:
        b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
        b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    else:  # xywh -> xyxy
        b1x1, b1x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1y1, b1y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2x1, b2x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2y1, b2y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = (_clip0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             * _clip0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)))

    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if not (GIoU or DIoU or CIoU):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # convex height
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
                + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if DIoU:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def np_scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Letterbox-inverse rescale of xyxy coords, numpy, in place."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            (img1_shape[1] - img0_shape[1] * gain) / 2,
            (img1_shape[0] - img0_shape[0] * gain) / 2,
        )
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    coords[:, [0, 2]] -= pad[0]
    coords[:, [1, 3]] -= pad[1]
    coords[:, :4] /= gain
    coords[:, [0, 2]] = coords[:, [0, 2]].clip(0, img0_shape[1])
    coords[:, [1, 3]] = coords[:, [1, 3]].clip(0, img0_shape[0])
    return coords
