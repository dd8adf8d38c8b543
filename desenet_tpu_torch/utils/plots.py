"""Visualization: box and label annotation, seg overlays, training mosaics,
label statistics, schedules, evolution and results curves, feature maps.

The port's copy of ``desenet_tpu/utils/plots.py``. numpy, torch and the
standard library at module level; cv2 is imported inside the functions that
draw or write images, matplotlib inside those that plot. Seg logits are
NCHW here (the JAX functions take NHWC); ``visualize_model_features``
returns its maps NHWC, as the JAX package captures them.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

HEX_PALETTE = (
    "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
    "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
    "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
)


class Colors:
    def __init__(self):
        self.palette = [self.hex2rgb(f"#{c}") for c in HEX_PALETTE]
        self.n = len(self.palette)

    def __call__(self, i, bgr=False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c

    @staticmethod
    def hex2rgb(h):
        return tuple(int(h[1 + i:1 + i + 2], 16) for i in (0, 2, 4))


colors = Colors()


def label_colormap(n: int = 256) -> np.ndarray:
    """VOC-style label colormap (bit-shuffle), the values imgviz gives."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _np(x) -> np.ndarray:
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class Annotator:
    """Box and label drawing on a BGR uint8 image (cv2)."""

    def __init__(self, im: np.ndarray, line_width: Optional[int] = None):
        if not im.data.contiguous:
            raise ValueError("Annotator needs a contiguous image "
                             "(np.ascontiguousarray)")
        self.im = im
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)

    def box_label(self, box, label: str = "", color=(128, 128, 128),
                  txt_color=(255, 255, 255)):
        import cv2

        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(self.im, p1, p2, color, self.lw, cv2.LINE_AA)
        if label:
            tf = max(self.lw - 1, 1)
            wt, ht = cv2.getTextSize(label, 0, self.lw / 3, tf)[0]
            outside = p1[1] - ht - 3 >= 0
            p2 = (p1[0] + wt, p1[1] - ht - 3 if outside else p1[1] + ht + 3)
            cv2.rectangle(self.im, p1, p2, color, -1, cv2.LINE_AA)
            cv2.putText(self.im, label,
                        (p1[0], p1[1] - 2 if outside else p1[1] + ht + 2),
                        0, self.lw / 3, txt_color, tf, cv2.LINE_AA)

    def result(self):
        return self.im


class SegAnnotator:
    """Class-id mask -> paletted colour image or overlay."""

    def __init__(self, alpha: float = 0.5):
        self.cmap = label_colormap()
        self.alpha = alpha

    def mask_to_color(self, mask: np.ndarray) -> np.ndarray:
        """(H, W) int mask -> (H, W, 3) RGB colour image."""
        return self.cmap[mask.astype(np.int64) % 256]

    def overlay(self, im_bgr: np.ndarray, mask: np.ndarray) -> np.ndarray:
        color = self.mask_to_color(mask)[:, :, ::-1]  # RGB -> BGR
        fg = mask > 0
        out = im_bgr.copy()
        out[fg] = (im_bgr[fg] * (1 - self.alpha)
                   + color[fg] * self.alpha).astype(np.uint8)
        return out

    def save_mask(self, mask: np.ndarray, path: str):
        import cv2

        cv2.imwrite(path, self.mask_to_color(mask)[:, :, ::-1])


def plot_images(
    images: np.ndarray,  # (B, H, W, 3) RGB uint8 or float in [0, 1]
    det_targets: Optional[np.ndarray],  # (N, 6+) [img, cls, xywhn, (conf)]
    seg_masks: Optional[np.ndarray],  # (B, H, W) int
    paths: Optional[Sequence[str]],
    fname: str = "images.jpg",
    seg_fname: Optional[str] = None,
    names: Optional[Dict[int, str]] = None,
    max_size: int = 1920,
    max_subplots: int = 16,
):
    """Mosaic grid of a batch with its boxes (jpg), and of its seg masks
    (paletted jpg) where ``seg_fname`` is given."""
    import cv2

    imgs = _np(images)
    if imgs.dtype != np.uint8:
        imgs = (imgs * 255).astype(np.uint8)
    bs, h, w = imgs.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))

    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    seg_mosaic = (np.zeros((ns * h, ns * w), np.int32)
                  if seg_masks is not None else None)
    for i in range(bs):
        x, y = (i % ns) * w, (i // ns) * h
        mosaic[y:y + h, x:x + w] = imgs[i][:, :, ::-1]  # RGB -> BGR
        if seg_mosaic is not None:
            seg_mosaic[y:y + h, x:x + w] = seg_masks[i]
        ann = Annotator(np.ascontiguousarray(mosaic))
        mosaic = ann.im
        if det_targets is not None and len(det_targets):
            ti = det_targets[det_targets[:, 0] == i]
            for row in ti:
                cls = int(row[1])
                bx = row[2:6]
                conf = row[6] if row.shape[0] > 6 else None
                x1 = (bx[0] - bx[2] / 2) * w + x
                y1 = (bx[1] - bx[3] / 2) * h + y
                x2 = (bx[0] + bx[2] / 2) * w + x
                y2 = (bx[1] + bx[3] / 2) * h + y
                label = names.get(cls, str(cls)) if names else str(cls)
                if conf is not None:
                    label += f" {conf:.2f}"
                ann.box_label((x1, y1, x2, y2), label, colors(cls, bgr=True))
        if paths is not None and i < len(paths):
            cv2.putText(mosaic, os.path.basename(str(paths[i]))[:40],
                        (x + 5, y + 20), 0, 0.5, (220, 220, 220), 1)
    scale = max_size / max(mosaic.shape[:2])
    if scale < 1:
        mosaic = cv2.resize(mosaic, (int(mosaic.shape[1] * scale),
                                     int(mosaic.shape[0] * scale)))
    cv2.imwrite(fname, mosaic)
    if seg_mosaic is not None and seg_fname:
        SegAnnotator().save_mask(seg_mosaic, seg_fname)


def output_to_target(nms_out) -> np.ndarray:
    """Fixed-shape NMS output -> plot-target rows [img, cls, x, y, w, h,
    conf] in pixel xywh (the caller normalizes)."""
    rows = []
    boxes = _np(nms_out.boxes)
    scores = _np(nms_out.scores)
    classes = _np(nms_out.classes)
    nums = _np(nms_out.num)
    for i in range(len(nums)):
        for j in range(int(nums[i])):
            x1, y1, x2, y2 = boxes[i, j]
            rows.append([i, classes[i, j], (x1 + x2) / 2, (y1 + y2) / 2,
                         x2 - x1, y2 - y1, scores[i, j]])
    return np.asarray(rows) if rows else np.zeros((0, 7))


def segoutput_to_target(seg_logits, out_hw) -> np.ndarray:
    """NCHW seg logits (B, C, H, W) -> argmax class ids (B, H', W') uint8,
    nearest-resized to ``out_hw``."""
    pred = np.argmax(_np(seg_logits), axis=1).astype(np.uint8)
    if pred.shape[1:3] == tuple(out_hw):
        return pred
    import cv2

    return np.stack([cv2.resize(p, (out_hw[1], out_hw[0]),
                                interpolation=cv2.INTER_NEAREST)
                     for p in pred])


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_labels(det_labels, names=None, save_dir: str = ""):
    """Label statistics: class histogram and box centre and size
    scatters."""
    plt = _pyplot()
    rows = (np.concatenate([l for l in det_labels if len(l)], 0)
            if any(len(l) for l in det_labels) else np.zeros((0, 5)))
    fig, ax = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = ax.ravel()
    if len(rows):
        classes = rows[:, 0].astype(int)
        nc = int(classes.max()) + 1
        ax[0].bar(range(nc), np.bincount(classes, minlength=nc),
                  color="#3477eb")
        ax[0].set_xlabel("class")
        if names and len(names) == nc:
            ax[0].set_xticks(range(nc), list(names), rotation=90, fontsize=7)
        ax[1].scatter(rows[:, 1], rows[:, 2], s=3, alpha=0.3)
        ax[1].set_xlabel("x")
        ax[1].set_ylabel("y")
        ax[2].scatter(rows[:, 3], rows[:, 4], s=3, alpha=0.3)
        ax[2].set_xlabel("width")
        ax[2].set_ylabel("height")
        ax[3].hist2d(rows[:, 3], rows[:, 4], bins=50)
        ax[3].set_xlabel("width")
        ax[3].set_ylabel("height")
    out = os.path.join(save_dir, "labels.jpg")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_lr_scheduler(lr_fn, epochs: int, save_dir: str = ""):
    """LR-schedule curve; ``lr_fn``: epoch -> lr."""
    plt = _pyplot()
    ys = [float(lr_fn(e)) for e in range(epochs)]
    plt.figure()
    plt.plot(ys, ".-", label="LR")
    plt.xlabel("epoch")
    plt.ylabel("LR")
    plt.grid()
    out = os.path.join(save_dir, "LR.png")
    plt.savefig(out, dpi=200)
    plt.close()
    return out


def plot_evolve(csv_path: str, out_path: Optional[str] = None):
    """Hyperparameter-evolution scatter grid of an evolve.csv."""
    import csv as _csv

    plt = _pyplot()
    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        return None
    keys = list(rows[0].keys())
    fit_key = "fitness" if "fitness" in keys else keys[0]
    fit = np.array([float(r[fit_key]) for r in rows])
    hyp_keys = [k for k in keys if k != fit_key]
    ncols = 5
    nrows_ = math.ceil(len(hyp_keys) / ncols)
    fig, axes = plt.subplots(nrows_, ncols, figsize=(3 * ncols, 2.5 * nrows_),
                             tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for ax, k in zip(axes, hyp_keys):
        vals = np.array([float(r[k]) for r in rows])
        ax.scatter(vals, fit, c=fit, cmap="viridis", s=12)
        ax.set_title(k, fontsize=8)
    for ax in axes[len(hyp_keys):]:
        ax.axis("off")
    out = out_path or os.path.join(os.path.dirname(csv_path), "evolve.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def feature_visualization(x: np.ndarray, module_type: str, stage: int,
                          n: int = 32, save_dir: str = "runs/features"):
    """Grid of up to ``n`` channel maps of image 0 of one NHWC activation,
    saved as ``stage{stage}_{module_type}.png``."""
    x = np.asarray(x, np.float32)
    if x.ndim != 4:
        return None
    plt = _pyplot()
    c = min(n, x.shape[-1])
    cols = 8
    rows_ = math.ceil(c / cols)
    fig, axes = plt.subplots(rows_, cols, figsize=(cols * 1.5, rows_ * 1.5),
                             tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for i in range(c):
        axes[i].imshow(x[0, :, :, i], cmap="gray")
        axes[i].axis("off")
    for ax in axes[c:]:
        ax.axis("off")
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, f"stage{stage}_{module_type}.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def feature_maps(model, x: torch.Tensor) -> List[tuple]:
    """Each module row's output of one forward of ``model`` (a ``DeSeNet``)
    on NCHW ``x``, as (name, NHWC float32 array) in the JAX package's order:
    rows named ``l{i}`` (the outer repeats of a row ``l{i}s{j}``), sorted by
    name, 4-D outputs only (a tuple output gives its first element)."""
    seen = {}
    hooks = []

    def keep(name):
        def hook(_m, _inp, out):
            seen[name] = out[0] if isinstance(out, (tuple, list)) else out
        return hook

    for ls, m in zip(model.spec.layers, model.model):
        if isinstance(m, torch.nn.Identity):  # Upsample, Concat
            continue
        if ls.n > 1 and isinstance(m, torch.nn.Sequential):
            for j, sub in enumerate(m):
                hooks.append(sub.register_forward_hook(keep(f"l{ls.i}s{j}")))
        else:
            hooks.append(m.register_forward_hook(keep(f"l{ls.i}")))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return [(k, v.permute(0, 2, 3, 1).float().cpu().numpy())
            for k, v in sorted(seen.items(), key=lambda kv: kv[0] + "/")
            if isinstance(v, torch.Tensor) and v.dim() == 4]


def visualize_model_features(model, x: torch.Tensor,
                             save_dir: str = "runs/features",
                             max_layers: int = 32) -> List[np.ndarray]:
    """Dump a feature-map grid per layer (``feature_maps``, at most
    ``max_layers``) into ``save_dir``; returns the layers' NHWC arrays."""
    outs = []
    for name, arr in feature_maps(model, x)[:max_layers]:
        feature_visualization(arr, name, len(outs), save_dir=save_dir)
        outs.append(arr)
    return outs


def plot_results(csv_path: str, out_path: Optional[str] = None):
    """results.csv -> training curves png."""
    import csv as _csv

    plt = _pyplot()
    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        return
    keys = [k for k in rows[0] if k != "epoch"]
    epochs = [float(r["epoch"]) for r in rows]
    n = len(keys)
    ncols = 4
    nrows = math.ceil(n / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows),
                             tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for ax, k in zip(axes, keys):
        vals = [float(r[k]) if r[k] != "" else np.nan for r in rows]
        ax.plot(epochs, vals, marker=".")
        ax.set_title(k, fontsize=9)
    for ax in axes[n:]:
        ax.axis("off")
    out = out_path or os.path.join(os.path.dirname(csv_path), "results.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
