"""COCO bbox evaluation, the protocol of ``pycocotools.cocoeval.COCOeval``
for bbox: 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision, area ranges all/small/medium/large, maxDets 1/10/100, greedy
score-ordered matching with crowd and ignore handling, the 12-number
summary.

The port's copy of ``desenet_tpu/eval/coco.py`` (numpy and the standard
library only). ``cli/val.py --save-json`` re-scores its exported predictions
with it. Ground truth: a COCO ``instances_*.json`` dict (images,
annotations, categories); predictions: the exported list of {image_id,
category_id, bbox [x, y, w, h], score} records
(``eval/validator.py:_append_json``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 iscrowd: Sequence[bool]) -> np.ndarray:
    """IoU between det and gt boxes in COCO xywh. For crowd gt the
    denominator is the det area alone (a det fully inside a crowd region
    counts as a perfect match)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx, dy, dw, dh = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    gx, gy, gw, gh = gts[:, 0], gts[:, 1], gts[:, 2], gts[:, 3]
    ix = (np.minimum(dx[:, None] + dw[:, None], gx[None] + gw[None])
          - np.maximum(dx[:, None], gx[None])).clip(0)
    iy = (np.minimum(dy[:, None] + dh[:, None], gy[None] + gh[None])
          - np.maximum(dy[:, None], gy[None])).clip(0)
    inter = ix * iy
    da = (dw * dh)[:, None]
    ga = (gw * gh)[None]
    crowd = np.asarray(iscrowd, bool)[None]
    union = np.where(crowd, da + np.zeros_like(ga), da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOGt:
    """Minimal ground-truth container over an instances-format dict."""

    def __init__(self, data):
        if isinstance(data, str):
            with open(data) as f:
                data = json.load(f)
        self.img_ids = [im["id"] for im in data.get("images", [])]
        self.cat_ids = sorted(c["id"] for c in data.get("categories", []))
        self.anns = defaultdict(list)  # (img_id, cat_id) -> [ann]
        for a in data.get("annotations", []):
            a = dict(a)
            a.setdefault("iscrowd", 0)
            a.setdefault("ignore", 0)
            a.setdefault("area", float(a["bbox"][2] * a["bbox"][3]))
            self.anns[(a["image_id"], a["category_id"])].append(a)


class COCOEval:
    """Greedy-matching bbox evaluator (COCO protocol)."""

    def __init__(self, gt: COCOGt, preds: List[dict],
                 img_ids: Optional[Sequence] = None):
        self.gt = gt
        self.img_ids = list(img_ids) if img_ids is not None else gt.img_ids
        self.cat_ids = gt.cat_ids
        self.dets = defaultdict(list)
        for p in preds:
            self.dets[(p["image_id"], p["category_id"])].append(p)
        self._eval_imgs = {}
        self._iou_cache = {}
        self.stats = None

    # -- per-image matching ------------------------------------------------
    def _img_cat_base(self, img_id, cat_id, max_det):
        """Area-range-independent work, computed once per (img, cat): score-
        sorted detections and their IoU matrix vs gts in ORIGINAL gt order
        (pycocotools computeIoU does the same hoisting)."""
        key = (img_id, cat_id, max_det)
        hit = self._iou_cache.get(key)
        if hit is not None:
            return hit
        gts = self.gt.anns.get((img_id, cat_id), [])
        dts = self.dets.get((img_id, cat_id), [])
        d_order = np.argsort([-d["score"] for d in dts], kind="stable")
        dts = [dts[i] for i in d_order][:max_det]
        g_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
        iscrowd0 = [bool(g["iscrowd"]) for g in gts]
        ious0 = box_iou_xywh(d_boxes, g_boxes, iscrowd0)
        hit = (gts, dts, d_boxes, iscrowd0, ious0)
        self._iou_cache[key] = hit
        return hit

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts, dts, d_boxes, iscrowd0, ious0 = self._img_cat_base(
            img_id, cat_id, max_det)
        if not gts and not dts:
            return None
        g_ignore = np.array([
            bool(g["ignore"]) or bool(g["iscrowd"])
            or not (area_rng[0] <= g["area"] <= area_rng[1])
            for g in gts
        ], dtype=bool)  # explicit: an empty list would default to float64
        # gt order: real gts first, ignored last (matching prefers real);
        # the cached IoU columns are permuted to match
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = [iscrowd0[i] for i in g_order]
        ious = ious0[:, g_order] if len(gts) else ious0

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_m = np.zeros((T, D), dtype=np.int64)  # 1+gt index or 0
        gt_m = np.zeros((T, G), dtype=np.int64)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(D):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(G):
                    if gt_m[ti, gi] and not iscrowd[gi]:
                        continue  # taken (crowds may match repeatedly)
                    if best > -1 and not g_ignore[best] and g_ignore[gi]:
                        break  # rest are ignored; keep the real match
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best = gi
                if best == -1:
                    continue
                dt_m[ti, di] = best + 1
                gt_m[ti, best] = di + 1
        d_ignore = np.zeros((T, D), bool)
        d_area_out = np.array([
            not (area_rng[0] <= b[2] * b[3] <= area_rng[1]) for b in d_boxes
        ], bool) if D else np.zeros(0, bool)
        for ti in range(T):
            matched_ignored = np.array([
                g_ignore[dt_m[ti, di] - 1] if dt_m[ti, di] else False
                for di in range(D)
            ], bool)
            # unmatched dets outside the area range are ignored, as are dets
            # matched to ignored gts
            d_ignore[ti] = matched_ignored | ((dt_m[ti] == 0) & d_area_out)
        return {
            "scores": np.array([d["score"] for d in dts], float),
            "matched": dt_m > 0,
            "d_ignore": d_ignore,
            "n_gt": int((~g_ignore).sum()),
        }

    # -- accumulation ------------------------------------------------------
    def evaluate(self):
        for area_name, rng in AREA_RNG.items():
            for cat in self.cat_ids:
                for img in self.img_ids:
                    self._eval_imgs[(img, cat, area_name)] = \
                        self._evaluate_img(img, cat, rng, MAX_DETS[-1])

    def accumulate(self):
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, area_name in enumerate(AREA_RNG):
                per_img = [self._eval_imgs.get((img, cat, area_name))
                           for img in self.img_ids]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                n_gt = sum(e["n_gt"] for e in per_img)
                if n_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in per_img])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["matched"][:, :max_det] for e in per_img], axis=1
                    )[:, order]
                    ign = np.concatenate(
                        [e["d_ignore"][:, :max_det] for e in per_img], axis=1
                    )[:, order]
                    tp = np.cumsum(matched & ~ign, axis=1).astype(float)
                    fp = np.cumsum(~matched & ~ign, axis=1).astype(float)
                    for ti in range(T):
                        rec = tp[ti] / n_gt
                        prec = tp[ti] / np.maximum(tp[ti] + fp[ti], 1e-12)
                        self.recall[ti, ki, ai, mi] = rec[-1] if len(rec) else 0
                        # precision envelope (monotone non-increasing)
                        pr = prec.copy()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rec, REC_THRS, side="left")
                        q = np.zeros(R)
                        valid = idx < len(pr)
                        q[valid] = pr[idx[valid]]
                        self.precision[ti, :, ki, ai, mi] = q

    def _summ(self, ap=True, iou=None, area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[[int(np.argmin(np.abs(IOU_THRS - iou)))]]
        else:
            s = self.recall[:, :, ai, mi]
            if iou is not None:
                s = s[[int(np.argmin(np.abs(IOU_THRS - iou)))]]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self, quiet=False):
        self.stats = np.array([
            self._summ(True),
            self._summ(True, iou=0.5),
            self._summ(True, iou=0.75),
            self._summ(True, area="small"),
            self._summ(True, area="medium"),
            self._summ(True, area="large"),
            self._summ(False, max_det=1),
            self._summ(False, max_det=10),
            self._summ(False, max_det=100),
            self._summ(False, area="small"),
            self._summ(False, area="medium"),
            self._summ(False, area="large"),
        ])
        if not quiet:
            names = [
                ("Average Precision", "0.50:0.95", "all", 100),
                ("Average Precision", "0.50", "all", 100),
                ("Average Precision", "0.75", "all", 100),
                ("Average Precision", "0.50:0.95", "small", 100),
                ("Average Precision", "0.50:0.95", "medium", 100),
                ("Average Precision", "0.50:0.95", "large", 100),
                ("Average Recall", "0.50:0.95", "all", 1),
                ("Average Recall", "0.50:0.95", "all", 10),
                ("Average Recall", "0.50:0.95", "all", 100),
                ("Average Recall", "0.50:0.95", "small", 100),
                ("Average Recall", "0.50:0.95", "medium", 100),
                ("Average Recall", "0.50:0.95", "large", 100),
            ]
            for (name, iou, area, md), v in zip(names, self.stats):
                kind = "(AP)" if "Precision" in name else "(AR)"
                print(f" {name} {kind} @[ IoU={iou:9s} | area={area:>6s} | "
                      f"maxDets={md:3d} ] = {v:.3f}")
        return self.stats


def evaluate_coco(anno, pred_json, img_ids=None, quiet=False):
    """Run the full protocol; returns the 12 summary stats
    (stats[0]=mAP@0.5:0.95, stats[1]=mAP@0.5) like COCOeval.stats."""
    gt = anno if isinstance(anno, COCOGt) else COCOGt(anno)
    if isinstance(pred_json, str):
        with open(pred_json) as f:
            preds = json.load(f)
    else:
        preds = pred_json
    ev = COCOEval(gt, preds, img_ids=img_ids)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(quiet=quiet)
