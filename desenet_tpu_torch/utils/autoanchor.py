"""Anchor auto-tuning.

The port's own copy of ``desenet_tpu/utils/autoanchor.py``:
- check_anchor_order: anchor-area vs stride monotonicity;
- check_anchors: BPR >= 0.98 gate, else re-cluster;
- kmean_anchors: whitened k-means (hand-rolled Lloyd's, no scipy) and a
  1000-generation genetic mutation on the ratio-metric fitness.

All numpy, the same draws in the same order, so the same seed and dataset
give the same anchors. Returns new anchors instead of mutating a module:
the engine rebuilds the model with them.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

LOGGER = logging.getLogger("desenet_tpu_torch")


def check_anchor_order(anchors: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """anchors (nl, na, 2) pixel units. Returns anchors with scale order
    matching stride order (flipped if necessary)."""
    anchors = np.asarray(anchors, np.float32)
    a = anchors.prod(-1).reshape(-1)
    da = a[-1] - a[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        LOGGER.info("autoanchor: reversing anchor order")
        anchors = anchors[::-1].copy()
    return anchors


def _ratio_metric(k: np.ndarray, wh: np.ndarray):
    """x (n, k): min-ratio metric; best (n,): best anchor per label."""
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)
    return x, x.max(1)


def anchor_fitness(k: np.ndarray, wh: np.ndarray, thr: float) -> float:
    _, best = _ratio_metric(k, wh)
    return float((best * (best > thr)).mean())


def dataset_wh(shapes: np.ndarray, det_labels, img_size: int,
               scale_rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-label wh in pixels after long-side resize (and an optional
    0.9-1.1x jitter, as check_anchors draws). shapes: (n, 2) (w, h)."""
    s = img_size * shapes / shapes.max(1, keepdims=True)
    if scale_rng is not None:
        s = s * scale_rng.uniform(0.9, 1.1, size=(len(shapes), 1))
    whs = [
        l[:, 3:5] * si for si, l in zip(s, det_labels) if len(l)
    ]
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def _lloyd_kmeans(pts: np.ndarray, n: int, iters: int = 30,
                  seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means on whitened points."""
    rng = np.random.default_rng(seed)
    k = pts[rng.choice(len(pts), n, replace=len(pts) < n)]
    for _ in range(iters):
        d = ((pts[:, None] - k[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(n):
            sel = pts[assign == j]
            if len(sel):
                k[j] = sel.mean(0)
            else:
                k[j] = pts[rng.integers(len(pts))]
    return k


def kmean_anchors(
    shapes: np.ndarray,
    det_labels,
    n: int = 9,
    img_size: int = 640,
    thr: float = 4.0,
    gen: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """K-means + GA anchor evolution. Returns (n, 2) anchors sorted by area."""
    thr = 1.0 / thr
    wh0 = dataset_wh(shapes, det_labels, img_size)
    tiny = int((wh0 < 3.0).any(1).sum())
    if tiny:
        LOGGER.warning(
            "autoanchor: %d of %d labels are < 3 px", tiny, len(wh0)
        )
    wh = wh0[(wh0 >= 2.0).any(1)]
    if len(wh) < n:
        raise ValueError(
            f"need >= {n} labels for {n} anchors, got {len(wh)}")

    sigma = wh.std(0)
    k = _lloyd_kmeans(wh / sigma, n, seed=seed) * sigma

    rng = np.random.default_rng(seed)
    f = anchor_fitness(k, wh, thr)
    sh, mp, s = k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random() * rng.standard_normal(sh)
                 * s + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    LOGGER.info("autoanchor: evolved fitness %.4f", f)
    return k.astype(np.float32)


def check_anchors(
    dataset,
    anchors: np.ndarray,
    strides: Sequence[int],
    thr: float = 4.0,
    imgsz: int = 640,
    seed: int = 0,
) -> Tuple[np.ndarray, bool]:
    """BPR gate + optional re-clustering. anchors (nl, na, 2) pixels.
    Returns (possibly-new anchors, changed?)."""
    anchors = np.asarray(anchors, np.float32)
    wh = dataset_wh(dataset.shapes, dataset.det_labels, imgsz,
                    np.random.default_rng(seed))
    if not len(wh):
        return anchors, False
    flat = anchors.reshape(-1, 2)
    x, best = _ratio_metric(flat, wh)
    aat = float((x > 1.0 / thr).sum(1).mean())
    bpr = float((best > 1.0 / thr).mean())
    LOGGER.info("autoanchor: anchors/target = %.2f, BPR = %.4f", aat, bpr)
    if bpr >= 0.98:
        return anchors, False
    LOGGER.info("autoanchor: BPR < 0.98, re-clustering anchors...")
    try:
        new = kmean_anchors(dataset.shapes, dataset.det_labels,
                            n=flat.shape[0], img_size=imgsz, thr=thr,
                            seed=seed)
    except ValueError as e:
        LOGGER.warning("autoanchor: %s", e)
        return anchors, False
    new_bpr = float((_ratio_metric(new, wh)[1] > 1.0 / thr).mean())
    if new_bpr > bpr:
        out = new.reshape(anchors.shape)
        out = check_anchor_order(out, strides)
        LOGGER.info(
            "autoanchor: new anchors (BPR %.4f): %s", new_bpr,
            np.round(out.reshape(-1, 2)).astype(int).tolist(),
        )
        return out, True
    LOGGER.info("autoanchor: original anchors better, keeping them")
    return anchors, False
