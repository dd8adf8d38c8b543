"""Fused candidate selection + greedy NMS over all anchors, no top-k cap.

Counterpart of ``desenet_tpu/ops/nms_fused.py``. As there, the prep runs
as tensor ops outside the kernel: score = obj * max cls, set to -1 unless
``obj > conf_thres`` and ``best > conf_thres`` (and the class is allowed);
xyxy boxes offset by ``cls * max_wh`` so one class-agnostic pass is
per-class NMS. The greedy selection over the six (B, A) planes is kernel
K1: on a CUDA tensor ``greedy_select`` launches ``csrc/nms_fused.cu`` or
raises; on a CPU tensor it runs ``greedy_select_plain``.

Selection semantics (both versions): per image, pick the highest score
(lowest anchor index on ties), write the row [x1, y1, x2, y2, score, cls],
drop every candidate with IoU > ``iou_thres`` against it, where
``area = max(x2-x1, 0) * max(y2-y1, 0)`` and
``iou = inter / (barea + area - inter + 1e-9)``; stop after ``max_det``
picks or when no score > 0 is left. Rows after the last pick are zero.
With ``return_index`` each version also gives the anchor index of every
pick ((B, max_det) int32, in the decode's order; -1 after the last pick):
a ``Segment`` model's masks gather their coefficients there.

``nms_planes`` scores the ``nc`` class columns after objectness: a
``Detect`` decode's every column from 5 on (``nc=None``), a ``Segment``
decode's columns 5 to 5+nc, its mask coefficients left out.

The kernel chooses between two paths on the device, per image, by the
candidate count alone (``last_paths`` holds the path each image of the last
launch took). Up to ``CAND_CAP`` candidates (and ``max_det`` up to
``KEPT_CAP``) it compacts them, sorts them once by (score descending, anchor
ascending) and walks them in that order with the walk kernel K3 uses
(``PATH_ORDERED``); ``greedy_select_ordered_plain`` is that in PyTorch ops
and gives ``greedy_select_plain``'s rows on every input. Above either cap it
runs an argmax loop over the anchors (``PATH_ARGMAX``).

With tracing on (``utils/profiling``), ``fused_select_nms`` counts the
images K1 is handed (``k1.images``) and their candidates
(``k1.candidates``, summed on the device).
"""

from __future__ import annotations

import torch

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.ops import nms_pallas
from desenet_tpu_torch.ops.boxes import xywh2xyxy
from desenet_tpu_torch.ops.nms_pallas import (KEPT_CAP, PATH_ARGMAX,
                                              PATH_ORDERED)
from desenet_tpu_torch.utils import profiling

launches = 0  # kernel launches made by greedy_select
# (B,) int32 on the card, per image of the last launch: PATH_ORDERED or
# PATH_ARGMAX (reading it waits for the kernel)
last_paths = None
# nms_fused.cu's constants
CAND_CAP = 4096   # candidates an image the ordered path takes (kCandCap)
LOOP_CAP = nms_pallas.SMEM_CAP  # anchors the argmax loop keeps in shared memory


def greedy_select_plain(x1, y1, x2, y2, score, cls, max_det: int,
                        iou_thres: float, return_index: bool = False):
    """The kernel's selection in PyTorch ops, all images advancing together:
    six (B, A) f32 planes -> (B, max_det, 6) rows (and, with
    ``return_index``, the picks' anchors)."""
    b, a = score.shape
    out = score.new_zeros((b, max_det, 6))
    index = torch.full((b, max_det), -1, dtype=torch.int32,
                       device=score.device)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    sc = score.clone()
    img = torch.arange(b, device=score.device)
    anchor = torch.arange(a, device=score.device)
    for k in range(max_det):
        m, j = sc.max(1)  # first index of the max on ties
        live = m > 0
        if not bool(live.any()):
            break
        bx1, by1, bx2, by2 = x1[img, j], y1[img, j], x2[img, j], y2[img, j]
        row = torch.stack([bx1, by1, bx2, by2, m, cls[img, j]], -1)
        out[:, k] = torch.where(live[:, None], row, 0.0)
        index[:, k] = torch.where(live, j.to(torch.int32), -1)
        iw = (torch.minimum(bx2[:, None], x2)
              - torch.maximum(bx1[:, None], x1)).clamp(min=0)
        ih = (torch.minimum(by2[:, None], y2)
              - torch.maximum(by1[:, None], y1)).clamp(min=0)
        inter = iw * ih
        iou = inter / (area[img, j][:, None] + area - inter + 1e-9)
        drop = (iou > iou_thres) | (anchor[None] == j[:, None])
        sc = torch.where(live[:, None] & drop, -1.0, sc)
    return (out, index) if return_index else out


def greedy_select_ordered_plain(x1, y1, x2, y2, score, cls, max_det: int,
                                iou_thres: float,
                                chunk: int = nms_pallas.CHUNK,
                                surv: int = nms_pallas.SURV,
                                return_index: bool = False):
    """The kernel's ordered path in PyTorch ops, image by image: the
    candidates (score > 0) compacted, sorted once by (score descending,
    anchor ascending), walked by ``nms_pallas.greedy_nms_ordered_plain`` in
    rounds of ``chunk`` with ``surv`` survivors settled a round, the picks
    written as rows. Same arguments and result as ``greedy_select_plain``."""
    b, _ = score.shape
    out = score.new_zeros((b, max_det, 6))
    index = torch.full((b, max_det), -1, dtype=torch.int32,
                       device=score.device)
    for im in range(b):
        cand = torch.nonzero(score[im] > 0).flatten()  # anchor order
        order = torch.sort(score[im, cand], descending=True, stable=True)[1]
        j = cand[order]
        if len(j) == 0:
            continue
        boxes = torch.stack([x1[im, j], y1[im, j], x2[im, j], y2[im, j]], -1)
        idx, sc = nms_pallas.greedy_nms_ordered_plain(
            boxes[None], score[im, j][None], iou_thres, max_det, chunk, surv)
        n = int((sc[0] > 0).sum())
        k = idx[0, :n].long()
        out[im, :n] = torch.cat(
            [boxes[k], sc[0, :n, None], cls[im, j[k], None]], -1)
        index[im, :n] = j[k].to(torch.int32)
    return (out, index) if return_index else out


def greedy_select(x1, y1, x2, y2, score, cls, max_det: int,
                  iou_thres: float, return_index: bool = False):
    """Greedy NMS selection over six contiguous (B, A) float32 planes on one
    device -> (B, max_det, 6) float32 rows [x1, y1, x2, y2, score, cls];
    with ``return_index`` also (B, max_det) int32, each pick's anchor (-1
    after the last)."""
    global launches, last_paths
    planes = (x1, y1, x2, y2, score, cls)
    for p in planes:
        if p.dim() != 2 or p.shape != score.shape:
            raise ValueError("greedy_select needs six (B, A) planes of one "
                             f"shape, got {[tuple(q.shape) for q in planes]}")
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("greedy_select needs contiguous float32 planes")
        if p.device != score.device:
            raise ValueError("greedy_select planes lie on different devices")
    if score.device.type == "cpu":
        return greedy_select_plain(*planes, max_det, iou_thres, return_index)
    if score.device.type != "cuda":
        raise ValueError(f"greedy_select runs on CPU or CUDA, not "
                         f"{score.device}")
    b, a = score.shape
    out = torch.empty((b, max_det, 6), dtype=torch.float32,
                      device=score.device)
    scratch = torch.empty((b, 3, a) if a > LOOP_CAP else (0,),
                          dtype=torch.float32, device=score.device)
    paths = torch.empty((b,), dtype=torch.int32, device=score.device)
    index = (torch.empty((b, max_det), dtype=torch.int32, device=score.device)
             if return_index else None)
    stream, dev = _ext.stream_and_device(score)
    _ext.check(_ext.load().desenet_nms_fused(
        *(p.data_ptr() for p in planes), b, a, max_det, float(iou_thres),
        scratch.data_ptr(), out.data_ptr(), paths.data_ptr(),
        None if index is None else index.data_ptr(), stream, dev),
        "nms_fused kernel")
    launches += 1
    last_paths = paths
    return (out, index) if return_index else out


def nms_planes(prediction: torch.Tensor, conf_thres: float,
               agnostic: bool = False, classes=None, max_wh: float = 4096.0,
               nc=None):
    """The prep: (B, A, 5+nc) decode (a Segment's (B, A, 5+nc+nm), with
    its ``nc`` given) -> the six (B, A) f32 planes x1, y1, x2, y2
    (class-offset), score (-1 where not a candidate), cls."""
    p = prediction.float()
    obj = p[..., 4]
    scores = p[..., 5:] if nc is None else p[..., 5:5 + nc]
    cls_conf = scores * obj[..., None]  # conf = obj * cls
    best_conf, best_cls_i = cls_conf.max(-1)
    ok = (obj > conf_thres) & (best_conf > conf_thres)
    if classes is not None:
        allowed = torch.zeros(cls_conf.shape[-1], dtype=torch.bool,
                              device=p.device)
        allowed[list(classes)] = True
        ok = ok & allowed[best_cls_i]
    score = torch.where(ok, best_conf, -1.0)
    best_cls = best_cls_i.float()
    box = xywh2xyxy(p[..., :4])
    offset = 0.0 if agnostic else best_cls * max_wh
    x1, y1, x2, y2 = (box[..., i] + offset for i in range(4))
    return tuple(v.contiguous() for v in (x1, y1, x2, y2, score, best_cls))


def fused_select_nms(prediction: torch.Tensor, conf_thres: float,
                     iou_thres: float, max_det: int, agnostic: bool = False,
                     classes=None, max_wh: float = 4096.0, nc=None,
                     return_index: bool = False):
    """Single-label NMS over the full (B, A, 5+nc) decode, no top-k cap
    (``nc`` as ``nms_planes``).

    Returns (boxes (B, max_det, 4) xyxy, scores (B, max_det),
    classes (B, max_det), valid (B, max_det) bool) with invalid rows zeroed
    (class -1), as the JAX function; with ``return_index`` also each
    pick's anchor ((B, max_det) int32, -1 in invalid rows)."""
    planes = nms_planes(prediction, conf_thres, agnostic, classes, max_wh,
                        nc)
    if profiling.tracing():
        profiling.count("k1.images", planes[4].shape[0])
        profiling.count("k1.candidates", (planes[4] > 0).sum())
    out = greedy_select(*planes, max_det, iou_thres, return_index)
    if return_index:
        out, index = out
    out_scores = out[..., 4]
    valid = out_scores > 0.0
    out_cls_off = out[..., 5]
    off = torch.zeros_like(out_cls_off) if agnostic else out_cls_off * max_wh
    out_boxes = torch.where(valid[..., None], out[..., :4] - off[..., None],
                            0.0)
    out_cls = torch.where(valid, out_cls_off, -1.0)
    out_scores = torch.where(valid, out_scores, 0.0)
    if return_index:
        return out_boxes, out_scores, out_cls, valid, index
    return out_boxes, out_scores, out_cls, valid
