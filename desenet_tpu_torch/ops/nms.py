"""Fixed-shape, on-device non-max suppression.

Counterpart of ``desenet_tpu/ops/nms.py``. Two routes, chosen as the JAX
package chooses on its TPU:

- single-label predictions in one array (the served program) go to the
  fused select+NMS (``ops/nms_fused.py``, kernel K1 on the card), with no
  pre_topk cap;
- everything else (multi-label, the validation path, and lists of
  per-scale arrays) reduces the candidates to a static top-``pre_topk`` set
  and runs batched greedy NMS over it (``ops/nms_pallas.py``, kernel K3 on
  the card).

The top-k set is ordered by descending score and, on equal scores, by
ascending flat index, as ``jax.lax.top_k`` orders it: K3 breaks ties by
position in that set. ``torch.topk`` promises no order among equal values on
CUDA, so the selection is a stable descending sort.

``backend="xla"`` (the JAX package's name for its portable formulation)
takes neither kernel: every prediction goes through the top-``pre_topk``
selection and then ``_greedy_nms``, ``max_det`` rounds of argmax and IoU
suppression in plain PyTorch ops, which ``torch.export`` can trace. Only
the serving export (``tools/export_model.py``) asks for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from desenet_tpu_torch.ops.boxes import xywh2xyxy
from desenet_tpu_torch.ops.nms_fused import fused_select_nms
from desenet_tpu_torch.ops.nms_pallas import greedy_nms_pallas

MAX_WH = 4096  # class-offset multiplier
# the JAX package's shipped pre_topk values (desenet_tpu/ops/nms.py)
PRE_TOPK_PRODUCTION = 1024
PRE_TOPK_VAL = 16384


class NMSOutput(NamedTuple):
    boxes: torch.Tensor  # (B, max_det, 4) xyxy
    scores: torch.Tensor  # (B, max_det)
    classes: torch.Tensor  # (B, max_det) float class ids
    valid: torch.Tensor  # (B, max_det) bool
    num: torch.Tensor  # (B,) int32 number of valid detections


def _top_k(scores: torch.Tensor, k: int):
    """(B, N) -> the top-k (values, indices) per row, descending, equal
    values by ascending index (``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7
             ) -> torch.Tensor:
    """IoU of (B, 1, 4) xyxy boxes against (B, K, 4) -> (B, K), the JAX
    package's ``ops/boxes.box_iou`` arithmetic."""
    inter = (torch.minimum(a[..., 2:], b[..., 2:])
             - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0).prod(-1)

    def area(x):
        return ((x[..., 2] - x[..., 0]).clamp(min=0)
                * (x[..., 3] - x[..., 1]).clamp(min=0))

    return inter / (area(a) + area(b) - inter + eps)


def _greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                max_det: int):
    """Greedy NMS of the JAX package's ``_greedy_nms``, batched: ``max_det``
    rounds, each taking the live candidate of the highest score (the first
    of equal ones) and suppressing it and every candidate above
    ``iou_thres`` with it. boxes (B, K, 4) class-offset xyxy, scores (B, K)
    with -1 where not a candidate. Returns keep indices (B, max_det) int64
    and the keep mask (B, max_det).

    Under ``torch.export`` the rounds are one ``while_loop`` (a higher-order
    op of the graph: unrolled, the 300 rounds take tens of seconds to
    export and load); in eager calls a Python loop over the same round."""
    b, k = scores.shape
    pos = torch.arange(k, device=scores.device)
    cols = torch.arange(max_det, device=scores.device)

    def round_(i, live, picks, oks):
        j = live.argmax(1)
        ok = live.gather(1, j[:, None])[:, 0] > 0.0
        iou = _box_iou(boxes.gather(1, j[:, None, None].expand(-1, 1, 4)),
                       boxes)
        suppress = (iou > iou_thres) | (pos == j[:, None])
        live = torch.where(ok[:, None] & suppress, -1.0, live)
        at = cols == i
        return (i + 1, live, torch.where(at, j[:, None], picks),
                torch.where(at, ok[:, None], oks))

    # a fresh row-major copy: the loop's carried state keeps its strides
    # round to round (a top-k slice of one image counts as contiguous with
    # the sorted row's stride)
    dev = scores.device
    carry = (torch.zeros((), dtype=torch.int64, device=dev),
             scores.clone(memory_format=torch.contiguous_format),
             torch.zeros((b, max_det), dtype=torch.int64, device=dev),
             torch.zeros((b, max_det), dtype=torch.bool, device=dev))
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        carry = while_loop(lambda i, *_: i < max_det, round_, carry)
    else:
        for i in range(max_det):
            carry = round_(i, *carry[1:])
    return carry[2], carry[3]


def _prep_candidates(pred: torch.Tensor, conf_thres: float, pre_topk: int,
                     multi_label: bool, classes=None):
    """Candidate selection, batched: (B, A, 5+nc) f32 -> the top-pre_topk
    boxes (B, K, 4) xyxy, scores (B, K) (-1 where not a candidate) and
    float classes (B, K). The class filter runs before suppression:
    multi-label drops the (anchor, class) pair, single-label drops the row
    whose best class (over all classes) is excluded."""
    nc = pred.shape[2] - 5
    obj = pred[..., 4]
    cand = obj > conf_thres
    box = xywh2xyxy(pred[..., :4])
    cls_conf = pred[..., 5:] * obj[..., None]  # conf = obj * cls
    allowed = None
    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=pred.device)
        allowed[list(classes)] = True
    if multi_label and nc > 1:
        keep = cand[..., None] & (cls_conf > conf_thres)
        if allowed is not None:
            keep = keep & allowed
        flat = torch.where(keep, cls_conf, -1.0).flatten(1)  # (B, A*nc)
        top_scores, top_flat = _top_k(flat, pre_topk)
        anchor_idx = top_flat // nc
        cls_idx = (top_flat % nc).float()
    else:
        best_conf, best_cls_i = cls_conf.max(-1)
        row_ok = cand & (best_conf > conf_thres)
        if allowed is not None:
            row_ok = row_ok & allowed[best_cls_i]
        top_scores, anchor_idx = _top_k(
            torch.where(row_ok, best_conf, -1.0), pre_topk)
        cls_idx = best_cls_i.gather(1, anchor_idx).float()
    top_boxes = box.gather(1, anchor_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, cls_idx


def _merge_scale_candidates(per_scale, pre_topk: int):
    """Merge per-scale candidate sets into the global top-pre_topk. Each
    scale contributed its own exact top set, so the union holds the global
    one and the final selection is exact."""
    boxes = torch.cat([p[0] for p in per_scale], 1)
    scores = torch.cat([p[1] for p in per_scale], 1)
    cls = torch.cat([p[2] for p in per_scale], 1)
    top_scores, idx = _top_k(scores, min(pre_topk, scores.shape[1]))
    return (boxes.gather(1, idx[..., None].expand(-1, -1, 4)), top_scores,
            cls.gather(1, idx))


def non_max_suppression(
    prediction,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_topk: int = PRE_TOPK_PRODUCTION,
    multi_label: bool = False,
    agnostic: bool = False,
    classes=None,
    backend: str = "auto",
) -> NMSOutput:
    """Batched fixed-shape NMS.

    prediction: a (B, A, 5+nc) decode in pixel xywh + obj + cls (the Detect
    head's output), or a list of per-scale (B, A_s, 5+nc) decodes (Detect
    built with ``decode_cat=False``): candidate selection then runs per
    scale and only the top sets are merged. ``classes`` is a sequence of
    allowed class ids. ``backend``: ``"auto"`` takes K1 or K3 (the module
    docstring says which), ``"xla"`` the top-k selection and
    ``_greedy_nms`` in plain PyTorch ops."""
    if backend not in ("auto", "xla"):
        raise ValueError(f"backend {backend!r}: 'auto' or 'xla'")
    preds = (list(prediction) if isinstance(prediction, (list, tuple))
             else [prediction])
    classes = tuple(classes) if classes is not None else None
    if backend == "auto" and not multi_label and len(preds) == 1:
        boxes, scores, cls, valid = fused_select_nms(
            preds[0], conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, agnostic=agnostic, classes=classes,
            max_wh=MAX_WH)
        return NMSOutput(boxes, scores, cls, valid,
                         valid.sum(1).to(torch.int32))

    nc = preds[0].shape[2] - 5
    per_pair = nc if multi_label else 1
    pre_topk = min(pre_topk, sum(p.shape[1] for p in preds) * per_pair)
    per_scale = [
        _prep_candidates(p.float(), conf_thres,
                         min(pre_topk, p.shape[1] * per_pair), multi_label,
                         classes)
        for p in preds]
    if len(per_scale) == 1:
        top_boxes, top_scores, cls_idx = per_scale[0]
    else:
        top_boxes, top_scores, cls_idx = _merge_scale_candidates(per_scale,
                                                                 pre_topk)
    offset = 0.0 if agnostic else float(MAX_WH)
    nms_boxes = top_boxes + cls_idx[..., None] * offset
    if backend == "xla":
        idx, keep_ok = _greedy_nms(nms_boxes, top_scores, iou_thres, max_det)
    else:
        keep_idx, keep_sc = greedy_nms_pallas(nms_boxes, top_scores,
                                              iou_thres, max_det)
        keep_ok = keep_sc > 0.0
        idx = keep_idx.long()
    out_boxes = torch.where(
        keep_ok[..., None],
        top_boxes.gather(1, idx[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(keep_ok, top_scores.gather(1, idx), 0.0)
    out_cls = torch.where(keep_ok, cls_idx.gather(1, idx), -1.0)
    return NMSOutput(out_boxes, out_scores, out_cls, keep_ok,
                     keep_ok.sum(1).to(torch.int32))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_thres: float = 0.45,
                max_det: int = 300, agnostic: bool = False):
    """Class-aware greedy NMS on explicit (K, 4) / (K,) / (K,) candidates
    (scores <= 0 are invalid). Returns keep indices (max_det,) into the
    candidates and a keep mask (max_det,); indices where the mask is False
    are 0."""
    offset = 0.0 if agnostic else float(MAX_WH)
    nms_boxes = boxes.float() + classes.float()[:, None] * offset
    sc = torch.where(scores > 0, scores.float(), -1.0)
    keep_idx, keep_sc = greedy_nms_pallas(nms_boxes[None], sc[None],
                                          iou_thres, max_det)
    return keep_idx[0], keep_sc[0] > 0.0
