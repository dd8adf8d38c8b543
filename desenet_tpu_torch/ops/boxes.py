"""Box geometry for the serving path and the detection loss.

Counterpart of ``desenet_tpu/ops/boxes.py`` (what the served program and
the training loss use) plus ``np_scale_coords``, copied from
``desenet_tpu/eval/validator.py`` because that module imports JAX. Boxes
live in the last axis of size 4.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """[cx,cy,w,h] -> [x1,y1,x2,y2]."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


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
