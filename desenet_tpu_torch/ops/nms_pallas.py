"""Batched greedy NMS over a pre-selected (B, K) candidate set.

Counterpart of ``desenet_tpu/ops/nms_pallas.py``. On a CUDA tensor
``greedy_nms_pallas`` launches the hand-written kernel ``csrc/nms_greedy.cu``
(kernel K3) or raises; on a CPU tensor it runs ``greedy_nms_plain``.

Selection semantics (both versions, the JAX kernel's): per image, pick the
highest live score (lowest index on ties); if it is > 0, record its index
and score and drop every candidate with IoU > ``iou_thres`` against it (and
itself), where ``area = max(x2-x1, 0) * max(y2-y1, 0)`` and
``iou = inter / (barea + area - inter + 1e-9)``; stop after ``max_det``
picks or when no score > 0 is left. Rows after the last pick hold index 0
and score -1.
"""

from __future__ import annotations

import torch

from desenet_tpu_torch.ops import _ext

launches = 0  # kernel launches made by greedy_nms_pallas
SMEM_CAP = 24576  # candidates per image kept in shared memory (nms_greedy.cu)


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thres: float, max_det: int):
    """The kernel's selection in PyTorch ops, all images advancing together:
    boxes (B, K, 4), scores (B, K) f32 -> keep_idx (B, max_det) int32,
    keep_scores (B, max_det) f32."""
    b, k = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    live = scores.clone()
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32,
                           device=scores.device)
    keep_sc = torch.full((b, max_det), -1.0, device=scores.device)
    img = torch.arange(b, device=scores.device)
    cand = torch.arange(k, device=scores.device)
    for i in range(max_det):
        best, j = live.max(1)  # first index of the max on ties
        ok = best > 0
        if not bool(ok.any()):
            break
        keep_idx[:, i] = torch.where(ok, j, 0).to(torch.int32)
        keep_sc[:, i] = torch.where(ok, best, -1.0)
        bx1, by1, bx2, by2 = x1[img, j], y1[img, j], x2[img, j], y2[img, j]
        iw = (torch.minimum(bx2[:, None], x2)
              - torch.maximum(bx1[:, None], x1)).clamp(min=0)
        ih = (torch.minimum(by2[:, None], y2)
              - torch.maximum(by1[:, None], y1)).clamp(min=0)
        inter = iw * ih
        iou = inter / (area[img, j][:, None] + area - inter + 1e-9)
        drop = (iou > iou_thres) | (cand[None] == j[:, None])
        live = torch.where(ok[:, None] & drop, -1.0, live)
    return keep_idx, keep_sc


def greedy_nms_pallas(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thres: float, max_det: int):
    """boxes (B, K, 4) xyxy (class offset applied), scores (B, K) with
    invalid candidates at <= 0, on one device. Returns (keep_idx
    (B, max_det) int32, keep_scores (B, max_det) f32, valid where > 0)."""
    global launches
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.dim() != 2 or \
            tuple(boxes.shape[:2]) != tuple(scores.shape):
        raise ValueError(f"greedy_nms_pallas needs boxes (B, K, 4) and "
                         f"scores (B, K), got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError("greedy_nms_pallas: boxes and scores lie on "
                         "different devices")
    if scores.shape[1] == 0:
        raise ValueError("greedy_nms_pallas needs at least one candidate")
    boxes = boxes.float().contiguous()
    scores = scores.float().contiguous()
    if scores.device.type == "cpu":
        return greedy_nms_plain(boxes, scores, iou_thres, max_det)
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_nms_pallas runs on CPU or CUDA, not "
                         f"{scores.device}")
    b, k = scores.shape
    keep_idx = torch.empty((b, max_det), dtype=torch.int32,
                           device=scores.device)
    keep_sc = torch.empty((b, max_det), dtype=torch.float32,
                          device=scores.device)
    scratch = torch.empty((b, 2, k) if k > SMEM_CAP else (0,),
                          dtype=torch.float32, device=scores.device)
    stream, dev = _ext.stream_and_device(scores)
    _ext.check(_ext.load().desenet_nms_greedy(
        boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres),
        scratch.data_ptr(), keep_idx.data_ptr(), keep_sc.data_ptr(), stream,
        dev), "nms_greedy kernel")
    launches += 1
    return keep_idx, keep_sc
