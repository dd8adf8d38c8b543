"""The comparison that decides ``correct`` for the served cells.

The reference decode and seg logits (``reference/desenet.py``, float32,
TF32 off) judge what the program served: boxes, scores, classes and counts
after NMS, and the seg class map. Two numbers are held to limits over the
sampled images: ``det_gap``, the larger of the ``QUANTILE`` quantile of
every served detection's ``det_explain`` gap and every kept detection's
``det_cover`` gap, and the widest breach of NMS's own rules; and
``seg_gap``, the widest gap over every pixel. Per detection:

- ``det_explain``: every served detection must be one of the reference's
  anchors: for a detection p, the least over anchors a of
  ``max(|score_p - score_ref(a, class_p)|, box_gap(p, a))``, where
  ``box_gap`` is the largest coordinate difference over the anchor box's
  longer side (at least 16 pixels; random weights make some boxes a pixel
  wide, where IoU says nothing).
- NMS's rules: ``conf_thres - score_p`` and, between two served boxes of
  one class, ``IoU - iou_thres`` (floored at 0; taken where the boxes are
  as NMS saw them, not after clipping to a frame), the widest of them.
- ``det_cover``: every detection the reference keeps must be served, or
  suppressed by a served box: for a kept r, the least of ``score_r -
  conf_thres`` (how far it is from not being a candidate) and, over served
  p, the larger of ``score_r - score_ref(r, class_p)`` (how far p's class
  is from r's best; 0 for r's own class) and the less of ``box_gap(p, r)``
  (a served twin) and ``iou_thres - IoU(p, r)`` (how far p is from
  suppressing it), floored at 0; where ``max_det`` rows were served, also
  ``score_r - lowest served score`` (how far it is from being cut off).
- ``seg_gap``: for every pixel, how far the reference's logit of the served
  class lies below its best logit, at full resolution.

A near-tie flips a choice either way without a large gap: that is why each
number measures a distance to a decision boundary and not a count of
differences. The detection gaps are taken at a high quantile and not at
their widest: bf16 rounding puts a rare detection of tens of thousands as
far off as the fp8 control puts a typical one, while a fault or a lower
precision moves many (a moved box in NMS, an image left out: the tests).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.desenet import seg_upsample

MIN_SIDE = 16.0  # pixels: box_gap's least scale
QUANTILE = 0.999  # of the per-detection gaps, for det_gap


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 4) x (m, 4) xyxy -> (n, m), in the inputs' dtype."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    area_a = ((a[:, 2] - a[:, 0]).clamp(min=0)
              * (a[:, 3] - a[:, 1]).clamp(min=0))
    area_b = ((b[:, 2] - b[:, 0]).clamp(min=0)
              * (b[:, 3] - b[:, 1]).clamp(min=0))
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def box_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 4) x (m, 4) xyxy -> (n, m): the largest coordinate difference
    over the longer side of b (at least ``MIN_SIDE``)."""
    side = torch.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]).clamp(
        min=MIN_SIDE)
    return (a[:, None, :] - b[None, :, :]).abs().amax(-1) / side[None, :]


def reference_nms(decode: torch.Tensor, conf_thres: float, iou_thres: float,
                  max_det: int) -> List[dict]:
    """Single-label greedy NMS per image of a (B, A, 5 + nc) decode, in
    float64: candidates where ``obj > conf`` and ``obj * best cls > conf``;
    highest score first, ties to the lower anchor; a pick drops every
    candidate of its class with IoU above ``iou_thres``; at most
    ``max_det`` picks. Returns per image boxes (xyxy), scores, classes,
    every class's score of the kept anchors, and the candidate count."""
    out = []
    for d in decode.double():
        obj = d[:, 4]
        conf = d[:, 5:] * obj[:, None]
        best, cls = conf.max(1)
        cand = torch.nonzero((obj > conf_thres) & (best > conf_thres))[:, 0]
        sc = best[cand]
        order = torch.sort(-sc, stable=True).indices
        cand, sc, cl = cand[order], sc[order], cls[cand][order]
        boxes = xywh2xyxy(d[cand, :4])
        over = ((iou(boxes, boxes) > iou_thres)
                & (cl[:, None] == cl[None, :])).cpu().numpy()
        removed = np.zeros(len(cand), bool)
        keep = []
        for i in range(len(cand)):
            if removed[i]:
                continue
            keep.append(i)
            if len(keep) == max_det:
                break
            removed |= over[i]
        k = torch.as_tensor(keep, dtype=torch.long, device=d.device)
        out.append({"boxes": boxes[k], "scores": sc[k], "classes": cl[k],
                    "class_scores": conf[cand[k]],
                    "candidates": int(len(cand))})
    return out


def _gaps_one(served: dict, decode: torch.Tensor, kept: dict, to_frame,
              conf_thres: float, iou_thres: float, max_det: int,
              rule_iou: bool):
    """One image's per-detection explain and cover gaps and its widest
    breach of NMS's rules (module docstring)."""
    dev = decode.device
    boxes = torch.as_tensor(served["boxes"], dtype=torch.float64, device=dev)
    scores = torch.as_tensor(served["scores"], dtype=torch.float64,
                             device=dev)
    classes = torch.as_tensor(served["classes"], device=dev).long()
    d = decode.double()
    obj = d[:, 4]
    ref_boxes = to_frame(xywh2xyxy(d[:, :4]))
    explain = torch.zeros(0, dtype=torch.float64, device=dev)
    if len(boxes):
        ref_sc = d[:, 5:][:, classes].t() * obj[None, :]  # (n, A)
        g = torch.maximum((ref_sc - scores[:, None]).abs(),
                          box_gap(boxes, ref_boxes))
        explain = g.min(1).values
    cover = torch.zeros(0, dtype=torch.float64, device=dev)
    kb = to_frame(kept["boxes"])
    if len(kb):
        g = (kept["scores"] - conf_thres).clamp(min=0)
        if len(boxes) >= max_det:
            g = torch.minimum(g, (kept["scores"] - scores.min()).clamp(min=0))
        if len(boxes):
            flip = kept["scores"][:, None] - kept["class_scores"][:, classes]
            reach = torch.minimum(box_gap(boxes, kb).t(),
                                  (iou_thres - iou(kb, boxes)).clamp(min=0))
            g = torch.minimum(g, torch.maximum(flip, reach).min(1).values)
        cover = g
    rule = float((conf_thres - scores).clamp(min=0).max()) if len(scores) \
        else 0.0
    if rule_iou and len(boxes) > 1:
        o = iou(boxes, boxes) - iou_thres
        same = classes[:, None] == classes[None, :]
        o = torch.where(same & ~torch.eye(len(boxes), dtype=torch.bool,
                                          device=dev), o, -1.0)
        rule = max(rule, float(o.max().clamp(min=0)))
    return explain, cover, rule


def judge(served: Sequence[dict], decode: torch.Tensor, logits: torch.Tensor,
          conf_thres: float, iou_thres: float, max_det: int,
          to_frame=None, crop=None, rule_iou: bool = True) -> dict:
    """The numbers over a block of images.

    served: per image ``boxes`` (n, 4) xyxy, ``scores``, ``classes`` as
    served, and ``seg`` the served class map; decode (B, A, 5 + nc) and
    logits (B, C, h, w) the reference's for the same images. ``to_frame``
    maps network-input xyxy boxes to the frame the program served them in
    (default: the same), ``crop`` (top, bottom, left, right) the part of
    the network input the served map covers. Also returns the gaps
    ``det_gap`` is taken from, the reference's candidate and kept
    counts."""
    to_frame = to_frame or (lambda b: b)
    kept = reference_nms(decode, conf_thres, iou_thres, max_det)
    gaps, ru, sg = [], 0.0, 0.0
    for i, s in enumerate(served):
        e, c, r = _gaps_one(s, decode[i], kept[i], to_frame, conf_thres,
                            iou_thres, max_det, rule_iou)
        gaps += [e.cpu().numpy(), c.cpu().numpy()]
        ru = max(ru, r)
    for i in range(len(served)):
        up = seg_upsample(logits[i:i + 1])[0]
        if crop is not None:
            t, b, l, r = crop
            up = up[:, t:up.shape[1] - b, l:up.shape[2] - r]
        seg = torch.as_tensor(np.asarray(served[i]["seg"]),
                              device=up.device).long()
        if seg.shape != up.shape[1:]:
            sg = np.inf
            continue
        gap = up.max(0).values - up.gather(0, seg.clamp(0, up.shape[0] - 1)
                                           [None])[0]
        bad = (seg < 0) | (seg >= up.shape[0])
        sg = max(sg, float(torch.where(bad, np.inf, gap).max()))
    gaps = np.concatenate(gaps)
    return {"det_gap": det_gap(gaps, ru), "seg_gap": sg, "det_gaps": gaps,
            "det_rule": ru, "candidates": [k["candidates"] for k in kept],
            "kept": [len(k["scores"]) for k in kept]}


def det_gap(gaps: np.ndarray, rule: float) -> float:
    """``det_gap`` of per-detection gaps and the widest rule breach."""
    q = float(np.quantile(gaps, QUANTILE)) if len(gaps) else 0.0
    return max(q, rule)
