"""The served cells' comparison: the reference forward over the same inputs
the program was given, in float32 with TF32 off and in blocks of images,
then ``judge.judge`` on what the program served."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.desenet import forward
from benchmark.reference.judge import det_gap, judge
from benchmark.reference.precision import no_tf32

BLOCK = 16  # images a reference forward


def reference_outputs(cfg: dict, sd: dict, x: torch.Tensor):
    """(decode, 1/8 logits) of float (B, 3, H, W) images in [0, 1], in
    blocks of ``BLOCK``."""
    decs, segs = [], []
    with no_tf32(), torch.inference_mode():
        for s in range(0, x.shape[0], BLOCK):
            d, g = forward(cfg, sd, x[s:s + BLOCK])
            decs.append(d)
            segs.append(g)
    return torch.cat(decs), torch.cat(segs)


def _fold(total: dict, nums: dict) -> None:
    """Add a block's judgement to the run's: the gaps pooled, the widest
    rule breach and seg gap kept; ``det_gap`` over all of them."""
    total["gaps"] = np.concatenate([total.get("gaps", np.zeros(0)),
                                    nums["det_gaps"]])
    total["rule"] = max(total.get("rule", 0.0), nums["det_rule"])
    total["seg_gap"] = max(total.get("seg_gap", 0.0), nums["seg_gap"])


def _checks(total: dict) -> dict:
    return {"det_gap": det_gap(total["gaps"], total["rule"]),
            "seg_gap": total["seg_gap"]}


def judge_batches(conf: dict, sd: dict, inputs: dict, outs: dict, dev,
                  conf_thres: float, iou_thres: float, max_det: int):
    """``inputs[k]``: the (B, H, W, 3) uint8 RGB batch the program's call k
    was given; ``outs[k]``: that call's ``run_batch`` result (boxes,
    scores, classes, num, seg). Returns (the widest of each number over
    every batch, ``det_gap`` over all their detections; per call the
    reference's candidate and kept counts)."""
    checks, counts = {}, {}
    for k, batch in inputs.items():
        x = torch.from_numpy(batch).to(dev).permute(0, 3, 1, 2).float() / 255
        dec, seg = reference_outputs(conf["model"], sd, x)
        boxes, scores, classes, num, seg_cls = outs[k]
        served = [{"boxes": boxes[i, :num[i]], "scores": scores[i, :num[i]],
                   "classes": classes[i, :num[i]], "seg": seg_cls[i]}
                  for i in range(len(batch))]
        nums = judge(served, dec, seg, conf_thres, iou_thres, max_det)
        _fold(checks, nums)
        counts[k] = {"candidates": nums["candidates"], "kept": nums["kept"],
                     "anchors": int(dec.shape[1])}
    return _checks(checks), counts


def judge_frames(conf: dict, sd: dict, frames: np.ndarray, served: list,
                 dev, conf_thres: float, iou_thres: float, max_det: int):
    """Requests served one frame each (``Predictor.__call__``): ``frames``
    (N, h, w, 3) uint8 BGR as sent, ``served`` per request the boxes,
    scores, classes and native-size mask the program answered. The
    reference letterboxes each frame itself (gain 1, centred on the pad)
    and undoes it: boxes shifted back and clipped to the frame, the seg
    map cropped to it."""
    from benchmark.harness.frames import letterbox_input

    size = conf["imgsz"]
    n, h, w, _ = frames.shape
    top, left = (size - h) // 2, (size - w) // 2
    shift = torch.tensor([left, top, left, top], dtype=torch.float64,
                         device=dev)
    hi = torch.tensor([w, h, w, h], dtype=torch.float64, device=dev)

    def to_frame(b):
        return torch.minimum((b - shift).clamp(min=0), hi)

    checks, cand = {}, []
    for s in range(0, n, BLOCK):
        x = letterbox_input(torch.from_numpy(frames[s:s + BLOCK]).to(dev),
                            size)
        dec, seg = reference_outputs(conf["model"], sd, x)
        nums = judge(served[s:s + BLOCK], dec, seg, conf_thres, iou_thres,
                     max_det, to_frame=to_frame,
                     crop=(top, size - h - top, left, size - w - left),
                     rule_iou=False)
        _fold(checks, nums)
        cand += nums["candidates"]
    return _checks(checks), cand
