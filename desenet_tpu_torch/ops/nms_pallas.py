"""Batched greedy NMS over a pre-selected (B, K) candidate set.

Counterpart of ``desenet_tpu/ops/nms_pallas.py``. On a CUDA tensor
``greedy_nms_pallas`` launches the hand-written kernel ``csrc/nms_greedy.cu``
(kernel K3) or raises; on a CPU tensor it runs ``greedy_nms_plain``.

Selection semantics (every version, the JAX kernel's): per image, pick the
highest live score (lowest index on ties); if it is > 0, record its index
and score and drop every candidate with IoU > ``iou_thres`` against it (and
itself), where ``area = max(x2-x1, 0) * max(y2-y1, 0)`` and
``iou = inter / (barea + area - inter + 1e-9)``; stop after ``max_det``
picks or when no score > 0 is left. Rows after the last pick hold index 0
and score -1.

The kernel has two paths and chooses on the device, per image. Where the
live scores are non-increasing by index (``scores_ordered``; the validation
path's stable descending sort gives that order) it walks the live prefix
once, ``CHUNK`` candidates at a time: each against the kept list, the
survivors (``SURV`` a round) among themselves through a bit mask that one
warp scans, the picks appended. ``greedy_nms_ordered_plain`` is that walk in
PyTorch ops, with the same chunks, and gives ``greedy_nms_plain``'s answer
on every ordered set. Any other order (``batched_nms``' explicit candidates)
takes the kernel's argmax loop over the compacted live candidates.
``last_paths`` holds the path each image of the last launch took.
"""

from __future__ import annotations

import torch

from desenet_tpu_torch.ops import _ext

launches = 0  # kernel launches made by greedy_nms_pallas
# (B,) int32 on the card, per image of the last launch: PATH_ORDERED or
# PATH_ARGMAX (reading it waits for the kernel)
last_paths = None
PATH_ORDERED, PATH_ARGMAX = 0, 1
# csrc/nms_walk.cuh's constants (kLoopCap, kThreads, kSurv, kKeptCap)
SMEM_CAP = 16384  # candidates per image the argmax loop keeps in shared memory
CHUNK = 1024      # candidates a round of the ordered walk tests (kThreads)
SURV = 512        # survivors a round settles (kSurv)
KEPT_CAP = 2048   # largest max_det the ordered walk takes (kKeptCap)


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


def scores_ordered(scores: torch.Tensor) -> torch.Tensor:
    """(B, K) scores -> (B,) bool, the kernel's test for its ordered walk:
    no live score (> 0) is larger than the score before it. The live
    candidates are then a prefix, in (score descending, index ascending)
    order."""
    nxt, prev = scores[:, 1:], scores[:, :-1]
    return ~((nxt > 0) & ~(prev >= nxt)).any(1)


def _covers(p, parea, q, qarea, iou_thres: float):
    """IoU > iou_thres of kept boxes ``p`` (..., 4) against candidates ``q``,
    broadcast; the kept box's area in the ``barea`` place."""
    iw = (torch.minimum(p[..., 2], q[..., 2])
          - torch.maximum(p[..., 0], q[..., 0])).clamp(min=0)
    ih = (torch.minimum(p[..., 3], q[..., 3])
          - torch.maximum(p[..., 1], q[..., 1])).clamp(min=0)
    inter = iw * ih
    return inter / (parea + qarea - inter + 1e-9) > iou_thres


def greedy_nms_ordered_plain(boxes: torch.Tensor, scores: torch.Tensor,
                             iou_thres: float, max_det: int,
                             chunk: int = CHUNK, surv: int = SURV):
    """The kernel's ordered walk in PyTorch ops, image by image, for sets
    that pass ``scores_ordered`` (raises on others): the live prefix in
    rounds of ``chunk`` candidates, each (a) tested against the kept list,
    (b) the first ``surv`` survivors' upper-triangular cover mask, (c) a
    scan of the mask in order, (d) the picks appended; a round that leaves
    more than ``surv`` survivors resumes behind the last one taken. Same
    arguments and results as ``greedy_nms_plain``."""
    if not bool(scores_ordered(scores).all()):
        raise ValueError("greedy_nms_ordered_plain needs live scores that are "
                         "non-increasing by index")
    b, _ = scores.shape
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32,
                           device=scores.device)
    keep_sc = torch.full((b, max_det), -1.0, device=scores.device)
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    for im in range(b):
        n_live = int((scores[im] > 0).sum())
        kept = []  # candidate indices, in pick order
        pos = 0
        while pos < n_live and len(kept) < max_det:
            c = min(chunk, n_live - pos)
            q, qa = boxes[im, pos:pos + c], area[im, pos:pos + c]
            alive = torch.ones(c, dtype=torch.bool, device=scores.device)
            if kept:
                kk = torch.tensor(kept, device=scores.device)
                alive = ~_covers(boxes[im, kk][:, None], area[im, kk][:, None],
                                 q[None], qa[None], iou_thres).any(0)
            sj = (torch.nonzero(alive).flatten() + pos)
            pos = pos + c if len(sj) <= surv else int(sj[surv - 1]) + 1
            sj = sj[:surv]
            sb, sa = boxes[im, sj], area[im, sj]
            mask = _covers(sb[:, None], sa[:, None], sb[None], sa[None],
                           iou_thres).triu(1)
            removed = torch.zeros(len(sj), dtype=torch.bool,
                                  device=scores.device)
            for a in range(len(sj)):
                if len(kept) == max_det:
                    break
                if not bool(removed[a]):
                    kept.append(int(sj[a]))
                    removed |= mask[a]
        if kept:
            kk = torch.tensor(kept, device=scores.device)
            keep_idx[im, :len(kept)] = kk.to(torch.int32)
            keep_sc[im, :len(kept)] = scores[im, kk]
    return keep_idx, keep_sc


def greedy_nms_pallas(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thres: float, max_det: int):
    """boxes (B, K, 4) xyxy (class offset applied), scores (B, K) with
    invalid candidates at <= 0, on one device. Returns (keep_idx
    (B, max_det) int32, keep_scores (B, max_det) f32, valid where > 0)."""
    global launches, last_paths
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
    scratch = torch.empty((b, 3, k) if k > SMEM_CAP else (0,),
                          dtype=torch.float32, device=scores.device)
    paths = torch.empty((b,), dtype=torch.int32, device=scores.device)
    stream, dev = _ext.stream_and_device(scores)
    _ext.check(_ext.load().desenet_nms_greedy(
        boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres),
        scratch.data_ptr(), keep_idx.data_ptr(), keep_sc.data_ptr(),
        paths.data_ptr(), stream, dev), "nms_greedy kernel")
    launches += 1
    last_paths = paths
    return keep_idx, keep_sc
