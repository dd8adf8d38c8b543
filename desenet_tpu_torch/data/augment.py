"""Host-side letterbox and label denormalisation for the serving and
validation paths.

The port's own copy of what those paths take from
``desenet_tpu/data/augment.py`` (which imports cv2 at module level):
``letterbox`` with ``auto=False`` and the gray pad of 114, and the
normalised-label helpers. The pad is numpy, and cv2 is imported only when the
image actually needs resizing, so an input that is already the network size
(or only needs padding) runs without cv2. The training augmentations
(mosaic, HSV, perspective, flips) are not here: they belong to the training
slice.
"""

from __future__ import annotations

import numpy as np

PAD_VALUE = 114  # gray fill used by letterbox


def letterbox(img: np.ndarray, new_shape=640, scaleup: bool = True):
    """Aspect-preserving resize of an (h, w, 3) image into a ``new_shape``
    canvas (a side, or (h, w)), centered on a gray pad; with
    ``scaleup=False`` the image is only ever shrunk. Returns
    (img, (rw, rh), (dw, dh)) as the JAX package's function."""
    shape = img.shape[:2]  # (h, w)
    if isinstance(new_shape, (int, np.integer)):
        new_shape = (int(new_shape), int(new_shape))
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    if (shape[1], shape[0]) != new_unpad:
        import cv2

        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    if top or bottom or left or right:
        h, w = img.shape[:2]
        out = np.full((h + top + bottom, w + left + right) + img.shape[2:],
                      PAD_VALUE, img.dtype)
        out[top:top + h, left:left + w] = img
        img = out
    return img, (r, r), (dw, dh)


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
