"""Host-side image and label augmentation (numpy and cv2), deterministic by
construction: every random op takes an explicit ``np.random.Generator``.

The port's own copy of ``desenet_tpu/data/augment.py``: the letterbox,
HSV jitter, the random perspective warp with seg polygons, flips, mixup,
cutout, histogram equalization and label replication, with the same draws
in the same order, so one generator gives the same bytes in either package.
Images are HWC RGB uint8. Det labels inside augmentation are (n, 5)
[cls, x1, y1, x2, y2] pixels; seg labels a list of (cls_id, (k, 2) float32
pixel polygon). cv2 is imported inside the functions that call it; the
letterbox pads with numpy and needs cv2 only to resize, so the serving
path runs without cv2 on inputs at the network size.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

PAD_VALUE = 114  # gray fill used by letterbox / mosaic / warps


def letterbox(img: np.ndarray, new_shape=640,
              color=(PAD_VALUE, PAD_VALUE, PAD_VALUE), auto: bool = False,
              scale_fill: bool = False, scaleup: bool = True,
              stride: int = 32):
    """Aspect-preserving resize of an (h, w, 3) image into a ``new_shape``
    canvas (a side, or (h, w)), centered on a ``color`` pad; with
    ``scaleup=False`` the image is only ever shrunk, with ``auto`` the pad
    is the least that reaches a ``stride`` multiple, with ``scale_fill``
    the image is stretched to the canvas. Returns (img, (rw, rh), (dw, dh))
    as the JAX package's function; ``auto`` defaults to False here (the
    serving and validation callers' setting)."""
    shape = img.shape[:2]  # (h, w)
    if isinstance(new_shape, (int, np.integer)):
        new_shape = (int(new_shape), int(new_shape))
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    dw /= 2
    dh /= 2
    if (shape[1], shape[0]) != new_unpad:
        import cv2

        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    if top or bottom or left or right:
        h, w = img.shape[:2]
        out = np.empty((h + top + bottom, w + left + right) + img.shape[2:],
                       img.dtype)
        out[...] = np.asarray(color, img.dtype) if img.ndim == 3 else color[0]
        out[top:top + h, left:left + w] = img
        img = out
    return img, ratio, (dw, dh)


def augment_hsv(img: np.ndarray, rng: np.random.Generator,
                hgain=0.5, sgain=0.5, vgain=0.5) -> np.ndarray:
    """LUT-based random HSV jitter (in place, RGB uint8)."""
    if hgain == 0 and sgain == 0 and vgain == 0:
        return img
    import cv2

    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB, dst=img)
    return img


def box_candidates(before: np.ndarray, after: np.ndarray,
                   wh_thr=2.0, ar_thr=20.0, area_thr=0.1, eps=1e-16):
    """Keep boxes that survive a geometric transform (4,n) xyxy arrays."""
    w1, h1 = before[2] - before[0], before[3] - before[1]
    w2, h2 = after[2] - after[0], after[3] - after[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (
        (w2 > wh_thr)
        & (h2 > wh_thr)
        & (w2 * h2 / (w1 * h1 + eps) > area_thr)
        & (ar < ar_thr)
    )


def random_perspective(
    img: np.ndarray,
    det: np.ndarray,
    seg: List[Tuple[int, np.ndarray]],
    rng: np.random.Generator,
    degrees=10.0,
    translate=0.1,
    scale=0.1,
    shear=10.0,
    perspective=0.0,
    border=(0, 0),
):
    """Compose center/perspective/rotation-scale/shear/translation into one
    3x3 matrix; warp image, re-fit det boxes (corner transform + min/max +
    candidate filter), transform seg polygons pointwise by the same M."""
    import cv2

    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height),
                                      borderValue=(PAD_VALUE,) * 3)
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                                 borderValue=(PAD_VALUE,) * 3)

    if len(det):
        n = len(det)
        xy = np.ones((n * 4, 3))
        xy[:, :2] = det[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(det[:, 1:5].T * s, new.T, area_thr=0.10)
        det = det[keep]
        det[:, 1:5] = new[keep]

    new_seg = []
    for cls_id, pts in seg:
        p = np.concatenate([pts, np.ones((len(pts), 1), pts.dtype)], axis=1)
        p = p @ M.T
        p = p[:, :2] / p[:, 2:3] if perspective else p[:, :2]
        new_seg.append((cls_id, p.astype(np.float32)))

    return img, det, new_seg


def flip_ud(img, det, seg):
    """Vertical flip; det is normalized xywh [cls,x,y,w,h], seg pixel polys."""
    img = np.flipud(img)
    h = img.shape[0]
    if len(det):
        det[:, 2] = 1 - det[:, 2]
    seg = [(c, np.stack([p[:, 0], h - p[:, 1]], axis=1)) for c, p in seg]
    return img, det, seg


def flip_lr(img, det, seg):
    img = np.fliplr(img)
    w = img.shape[1]
    if len(det):
        det[:, 1] = 1 - det[:, 1]
    seg = [(c, np.stack([w - p[:, 0], p[:, 1]], axis=1)) for c, p in seg]
    return img, det, seg


def mixup(img1, det1, seg1, img2, det2, seg2, rng: np.random.Generator):
    """MixUp two samples (beta(8, 8) ratio). Seg polygon lists are
    concatenated (rasterization resolves overlaps)."""
    r = rng.beta(8.0, 8.0)
    img = (img1.astype(np.float32) * r
           + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    det = np.concatenate([det1, det2], 0) if len(det1) or len(det2) else det1
    return img, det, list(seg1) + list(seg2)


def cutout(img: np.ndarray, det: np.ndarray, rng: np.random.Generator):
    """Random occlusion cutouts with obscured-label removal."""
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + \
        [0.03125] * 16
    for s in scales:
        mh, mw = int(rng.uniform(0, h * s)), int(rng.uniform(0, w * s))
        cx, cy = int(rng.uniform(0, w)), int(rng.uniform(0, h))
        x1, y1 = max(cx - mw // 2, 0), max(cy - mh // 2, 0)
        x2, y2 = min(w, x1 + mw), min(h, y1 + mh)
        img[y1:y2, x1:x2] = [int(rng.uniform(64, 191)) for _ in range(3)]
        if len(det) and s > 0.03:
            box = np.array([x1, y1, x2, y2], np.float32)
            b = det[:, 1:5]
            iw = np.clip(np.minimum(box[2], b[:, 2]) - np.maximum(box[0], b[:, 0]), 0, None)
            ih = np.clip(np.minimum(box[3], b[:, 3]) - np.maximum(box[1], b[:, 1]), 0, None)
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) + 1e-16
            det = det[iw * ih / area < 0.60]
    return img, det


def hist_equalize(img: np.ndarray, clahe: bool = True, bgr: bool = True):
    """Histogram equalization on the Y channel."""
    import cv2

    yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV if bgr else cv2.COLOR_RGB2YUV)
    if clahe:
        c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        yuv[:, :, 0] = c.apply(yuv[:, :, 0])
    else:
        yuv[:, :, 0] = cv2.equalizeHist(yuv[:, :, 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR if bgr else cv2.COLOR_YUV2RGB)


def replicate_labels(img: np.ndarray, det: np.ndarray,
                     rng: np.random.Generator):
    """Duplicate the smallest-half boxes elsewhere in the image.
    det: (n,5) [cls, x1,y1,x2,y2] pixels."""
    h, w = img.shape[:2]
    if not len(det):
        return img, det
    boxes = det[:, 1:5]
    x1, y1, x2, y2 = boxes.T
    s = ((x2 - x1) + (y2 - y1)) / 2
    for i in s.argsort()[: len(s) // 2]:
        x1b, y1b, x2b, y2b = (int(v) for v in boxes[i])
        bh, bw = y2b - y1b, x2b - x1b
        yc = int(rng.uniform(0, max(h - bh, 1)))
        xc = int(rng.uniform(0, max(w - bw, 1)))
        img[yc:yc + bh, xc:xc + bw] = img[y1b:y2b, x1b:x2b]
        det = np.concatenate(
            [det, [[det[i, 0], xc, yc, xc + bw, yc + bh]]], 0
        ).astype(det.dtype)
    return img, det




def denorm_boxes(xywhn: np.ndarray, w, h, padw=0.0, padh=0.0) -> np.ndarray:
    """Normalized xywh -> pixel xyxy with offset."""
    out = np.empty_like(xywhn)
    out[:, 0] = w * (xywhn[:, 0] - xywhn[:, 2] / 2) + padw
    out[:, 1] = h * (xywhn[:, 1] - xywhn[:, 3] / 2) + padh
    out[:, 2] = w * (xywhn[:, 0] + xywhn[:, 2] / 2) + padw
    out[:, 3] = h * (xywhn[:, 1] + xywhn[:, 3] / 2) + padh
    return out


def denorm_polys(seg, w, h, padw=0.0, padh=0.0):
    """Normalized polygon points -> pixel coords."""
    return [
        (c, np.stack([w * p[:, 0] + padw, h * p[:, 1] + padh], axis=1)
            .astype(np.float32))
        for c, p in seg
    ]
