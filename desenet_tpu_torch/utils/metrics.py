"""Evaluation metrics (host-side numpy): detection mAP family, confusion
matrix, segmentation pixAcc/mIoU, and the joint model-selection fitness.

The port's own copy of ``desenet_tpu/utils/metrics.py`` (numpy only;
matplotlib imported inside ``ConfusionMatrix.plot``):
- ap_per_class / compute_ap: per-class PR curves, 101-point COCO
  interpolation, operating point at max mean-F1;
- fitness / fitness_det_seg: [P,R,mAP50,mAP] x [0,0,.1,.9] and
  [P,R,mAP50,mAP,mIoU] x [0,0,.1,.2,.7];
- ConfusionMatrix with background FP/FN rows;
- seg pixAcc counts only target>0 pixels; mIoU histograms exclude class 0.
"""

from __future__ import annotations

import numpy as np


def fitness(x: np.ndarray) -> np.ndarray:
    w = np.asarray([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def fitness_det_seg(x: np.ndarray, miou: float) -> np.ndarray:
    w = np.asarray([0.0, 0.0, 0.1, 0.2, 0.7])
    xm = np.expand_dims(np.append(x[:, :4], miou), 0)
    return (xm * w).sum(1)


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """AP from one PR curve via 101-pt interpolation."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") \
        else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
):
    """Returns (p, r, ap, f1, unique_classes) at the max-F1 operating point.

    tp: (n, n_iou) bool/int TP flags per detection per IoU threshold.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = int((target_cls == c).sum())
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32)


def np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU (N,4),(M,4) xyxy -> (N,M) in numpy."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-16)


def match_predictions(
    detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray
) -> np.ndarray:
    """Per-image TP matrix vs IoU thresholds.

    detections: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5) [cls,x1,y1,x2,y2].
    Returns (N, len(iouv)) bool.
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if labels.shape[0] == 0 or detections.shape[0] == 0:
        return correct
    iou = np_box_iou(labels[:, 1:], detections[:, :4])
    cls_match = labels[:, 0:1] == detections[None, :, 5]
    # match once at iouv[0], then grade each match against every threshold —
    # the original implementation's matrix construction
    li, di = np.where((iou >= iouv[0]) & cls_match)
    if li.shape[0]:
        m = np.stack([li, di, iou[li, di]], axis=1)
        if li.shape[0] > 1:
            m = m[m[:, 2].argsort()[::-1]]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
        correct[m[:, 1].astype(int)] = m[:, 2:3] >= iouv[None, :].reshape(1, -1)
    return correct


class ConfusionMatrix:
    """Detection confusion matrix incl. background FP/FN rows."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (N,6) [xyxy,conf,cls]; labels (M,5) [cls,xyxy]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = np_box_iou(labels[:, 1:], detections[:, :4])
        li, di = np.where(iou > self.iou_thres)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1 = matches[:, 0].astype(int), matches[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1  # background FP
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FN
        else:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1

    def plot(self, normalize: bool = True, save_dir: str = "", names=()):
        try:
            import matplotlib.pyplot as plt

            arr = self.matrix / (
                (self.matrix.sum(0).reshape(1, -1) + 1e-6) if normalize else 1
            )
            fig, ax = plt.subplots(figsize=(12, 9), tight_layout=True)
            im = ax.imshow(arr, cmap="Blues")
            ticks = list(names) + ["background"]
            if 0 < len(names) == self.nc:
                ax.set_xticks(range(self.nc + 1), ticks, rotation=90)
                ax.set_yticks(range(self.nc + 1), ticks)
            if self.nc < 30:
                for y in range(arr.shape[0]):
                    for x in range(arr.shape[1]):
                        if arr[y, x] >= 0.005:
                            ax.text(x, y, f"{arr[y, x]:.2f}", ha="center",
                                    va="center", fontsize=8)
            fig.colorbar(im)
            ax.set_xlabel("True")
            ax.set_ylabel("Predicted")
            import os

            fig.savefig(os.path.join(save_dir, "confusion_matrix.png"), dpi=250)
            plt.close(fig)
        except Exception as e:  # noqa: BLE001 — plotting is best-effort
            print(f"WARNING: ConfusionMatrix plot failure: {e}")


# ---------------------------------------------------------------------------
# segmentation metrics


def batch_pix_accuracy(pred_cls: np.ndarray, target: np.ndarray):
    """pixAcc counting only target>0 pixels. pred_cls: (B,H,W) argmaxed class
    ids; target: (B,H,W). The original implementation adds 1 to both;
    equivalent formulation here."""
    labeled = target > 0
    correct = ((pred_cls == target) & labeled).sum()
    total = labeled.sum()
    if correct > total:
        raise ValueError("correct must be <= labeled")
    return int(correct), int(total)


def batch_intersection_union(pred_cls: np.ndarray, target: np.ndarray,
                             nclass: int):
    """Histogram intersection/union over classes 1..nclass-1 (class 0
    excluded). Returns (inter, union) arrays of length
    nclass-1."""
    nbins = nclass - 1
    pred = pred_cls.astype(np.int32)
    targ = target.astype(np.int32)
    intersection = pred * (pred == targ)  # class id where correct, else 0
    area_inter = np.histogram(intersection, bins=nbins, range=(1, nclass))[0]
    area_pred = np.histogram(pred, bins=nbins, range=(1, nclass))[0]
    area_lab = np.histogram(targ, bins=nbins, range=(1, nclass))[0]
    area_union = area_pred + area_lab - area_inter
    if not (area_inter <= area_union).all():
        raise ValueError("inter must be <= union")
    return area_inter.astype(np.int64), area_union.astype(np.int64)


class SegMetrics:
    """Running pixAcc / mIoU accumulator."""

    def __init__(self, nclass: int):
        self.nclass = nclass
        self.reset()

    def reset(self):
        self.total_correct = 0
        self.total_label = 0
        self.total_inter = np.zeros(self.nclass - 1, np.int64)
        self.total_union = np.zeros(self.nclass - 1, np.int64)

    def update(self, pred_cls: np.ndarray, target: np.ndarray):
        c, l = batch_pix_accuracy(pred_cls, target)
        i, u = batch_intersection_union(pred_cls, target, self.nclass)
        self.total_correct += c
        self.total_label += l
        self.total_inter += i
        self.total_union += u

    @property
    def pix_acc(self) -> float:
        return self.total_correct / (self.total_label + 2e-16)

    @property
    def ious(self) -> np.ndarray:
        return self.total_inter / (self.total_union + 2e-16)

    @property
    def miou(self) -> float:
        return float(self.ious.mean()) if len(self.ious) else 0.0
