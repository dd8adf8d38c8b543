"""The comparison that decides ``correct`` for the instance-segmentation
cell: the reference (``reference/v7seg.py``, float32, TF32 off, in blocks
of images) over the inputs the program was given, then two numbers held
to limits over the sampled images.

- ``det_gap``: as the DeSeNet cells define it (``reference/judge.py``:
  every served detection's explain gap, every kept one's cover gap, their
  ``QUANTILE``, and NMS's widest rule breach), on the decode's first
  5 + nc columns, the boxes, objectness and classes.
- ``mask_gap``: for each served box j of an image, take the reference's
  coefficients ``c`` at the anchor the program says the box came from and
  the reference's prototypes ``P``, ``v = c . P`` at every proto pixel,
  and the reference's bit ``v > 0`` inside the served box's crop (v7.0's
  ``crop_mask``), 0 outside it. A pixel's ratio is ``|v|`` over
  ``sum_k |c_k P_k|`` at that pixel: how far it lies from the decision,
  in units of the dot product's own terms, whose size sets how far
  rounding can move it. ``mask_gap`` is the largest ratio over the
  pixels inside a crop where the served bit and the reference's differ,
  0 where no bit differs. A bit that bf16 rounding flips reads a few
  hundredths; a negated coefficient, a wrong prototype or another box's
  mask reads tenths and more. It reads ``FAULT``, which no rounding
  makes, for any of:

  - a set bit outside the served box's crop (the program crops with the
    box it serves), in a row ``j >= num``, or of an anchor outside the
    decode;
  - an anchor whose reference row is another detection: the served box
    and score further from that row's than ``ANCHOR_REACH`` by
    ``det_explain``'s gap (``reference/judge.py``), so the masks cannot
    be built from a neighbouring or another scale's anchor unseen, even
    where that anchor's mask would be the same;
  - a box that flips more than half of its crop's decided pixels (ratio
    at least ``DECIDED``, where the program's rounding flips none), at
    least ``MIN_DECIDED`` of them: a whole mask inverted, which the
    largest ratio alone misses where every pixel of the crop lies near
    the decision (a crop on the flat letterbox pad). A box with fewer
    decided pixels reads at most its ``reach``, as rounding could.

  Box error is ``det_gap``'s to judge.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.judge import (MIN_SIDE, _gaps_one, det_gap,
                                       reference_nms, xywh2xyxy)
from benchmark.reference.precision import no_tf32
from benchmark.reference.v7seg import crop, forward, mask_logits, segment_row

BLOCK = 16  # images a reference forward
FAULT = 1e6  # mask_gap of a fault no rounding can make
# Where these three sit, from 14 seeds of the cell on an H100 (PERF.md
# section 2): bf16 rounding put a served box at most 0.0051 from its
# anchor's row, where a shift of every anchor by one read FAULT in every
# image alone; it flipped at most one pixel of a box at a ratio of 0.1 or
# more (0.1016), where every one of 236,185 boxes had 8 such pixels or
# more, so each of them inverted reads FAULT.
ANCHOR_REACH = 0.1  # det_explain's gap from a box to its own anchor's row
DECIDED = 0.1  # the ratio from which rounding seldom flips a bit
MIN_DECIDED = 8  # decided pixels a box needs to be judged as a whole


def reference_outputs(cfg: dict, sd: dict, x: torch.Tensor):
    """(decode, prototypes) of float (B, 3, H, W) images in [0, 1], in
    float32 with TF32 off."""
    with no_tf32(), torch.inference_mode():
        return forward(cfg, sd, x)


def box_readings(proto: torch.Tensor, decode: torch.Tensor, nc: int,
                 served: dict, anchors, bits, num: int, img_hw):
    """One image's readings box by box: the reference's (nm, hp, wp)
    prototypes and (A, 5 + nc + nm) decode; ``served`` the boxes (n, 4)
    xyxy, scores and classes as served, their anchors (n,), and the
    served (max_det, hp, wp / 8) packed bits with ``num`` boxes. None
    where the image shows a fault box by box cannot: a set bit in a row
    ``j >= num``, an anchor outside the decode. Else (n,) tensors:

    - ``gap``: the largest ratio (module docstring) over the crop's pixels
      whose bit differs, 0 where none does;
    - ``outside``: a set bit outside the box's crop;
    - ``anchor``: the served box's gap to the reference's row at its
      anchor, ``det_explain``'s gap at that one anchor (``reference/
      judge.py``): the larger of the score's difference and ``box_gap``;
    - ``decided``: the crop's pixels whose ratio is at least ``DECIDED``,
      ``flipped`` those of them whose bit differs;
    - ``reach``: the crop's largest ratio, what the box reads with every
      bit of its crop inverted."""
    dev = proto.device
    nm, hp, wp = proto.shape
    bits = np.asarray(bits)
    if num < len(bits) and bits[num:].any():
        return None
    a = torch.as_tensor(np.asarray(anchors[:num]), device=dev).long()
    if bool(((a < 0) | (a >= decode.shape[0])).any()):
        return None
    got = torch.from_numpy(np.unpackbits(
        bits[:num], axis=-1, bitorder="little")).to(dev).bool()
    box = torch.as_tensor(np.asarray(served["boxes"][:num]),
                          dtype=torch.float64, device=dev)
    score = torch.as_tensor(np.asarray(served["scores"][:num]),
                            dtype=torch.float64, device=dev)
    cls = torch.as_tensor(np.asarray(served["classes"][:num]),
                          device=dev).long()
    rows = decode[a].double()
    coef = rows[:, 5 + nc:5 + nc + nm]
    with no_tf32():
        v = mask_logits(proto.double(), coef)
        terms = mask_logits(proto.double().abs(), coef.abs())
    inside = crop(box, hp, wp, img_hw)
    ratio = torch.where(terms > 0, v.abs() / terms, FAULT)
    differ = (got != ((v > 0) & inside)) & inside
    decided = (ratio >= DECIDED) & inside
    ref_box = xywh2xyxy(rows[:, :4])
    side = torch.maximum(ref_box[:, 2] - ref_box[:, 0],
                         ref_box[:, 3] - ref_box[:, 1]).clamp(min=MIN_SIDE)
    ref_score = rows[:, 4] * rows.gather(1, 5 + cls[:, None])[:, 0]
    flat = (num, -1)
    return {
        "gap": torch.where(differ, ratio, 0.0).view(flat).amax(1),
        "outside": (got & ~inside).view(flat).any(1),
        "anchor": torch.maximum((ref_score - score).abs(),
                                (box - ref_box).abs().amax(1) / side),
        "decided": decided.view(flat).sum(1),
        "flipped": (decided & differ).view(flat).sum(1),
        "reach": torch.where(inside, ratio, 0.0).view(flat).amax(1),
    }


def mask_gap_one(proto: torch.Tensor, decode: torch.Tensor, nc: int,
                 served: dict, anchors, bits, num: int, img_hw) -> float:
    """``mask_gap`` of one image (``box_readings``' arguments): ``FAULT``
    where a box's bits lie outside its crop, its anchor's row is another
    detection (``anchor`` above ``ANCHOR_REACH``), or it flips more than
    half of its decided pixels, at least ``MIN_DECIDED`` of them; else the
    largest ``gap``."""
    if num == 0:
        return 0.0 if not np.asarray(bits).any() else FAULT
    r = box_readings(proto, decode, nc, served, anchors, bits, num, img_hw)
    if r is None or bool(r["outside"].any()) or bool(
            (r["anchor"] > ANCHOR_REACH).any()) or bool(
            ((r["decided"] >= MIN_DECIDED)
             & (2 * r["flipped"] > r["decided"])).any()):
        return FAULT
    return float(r["gap"].max())


def judge_batches(conf: dict, sd: dict, inputs: dict, outs: dict, dev,
                  conf_thres: float, iou_thres: float, max_det: int,
                  each_image=None):
    """``inputs[k]``: the (B, H, W, 3) uint8 RGB batch of the program's
    call k; ``outs[k]``: that call's ``run_batch`` result (boxes, scores,
    classes, num, mask bits, anchors). Returns ({"det_gap", "mask_gap"}
    over every batch; per call the reference's candidate and kept counts
    an image, the anchors, and the served boxes' crop pixels).
    ``each_image``, where given, is called with ``mask_gap_one``'s
    arguments for every image (``control_instseg.py``'s readings)."""
    cfg = conf["model"]
    nc = segment_row(cfg)["nc"]
    gaps, rule, mgap, counts = [], 0.0, 0.0, {}
    for k, batch in inputs.items():
        boxes, scores, classes, num, bits, anchors = outs[k]
        img_hw = batch.shape[1:3]
        cand, kept, crop_px = [], [], 0
        for s in range(0, len(batch), BLOCK):
            x = torch.from_numpy(batch[s:s + BLOCK]).to(dev).permute(
                0, 3, 1, 2).float() / 255
            dec, proto = reference_outputs(cfg, sd, x)
            det = dec[..., :5 + nc]
            ref_kept = reference_nms(det, conf_thres, iou_thres, max_det)
            for i in range(len(x)):
                g = s + i
                n = int(num[g])
                served = {"boxes": boxes[g, :n], "scores": scores[g, :n],
                          "classes": classes[g, :n]}
                e, c, r = _gaps_one(served, det[i], ref_kept[i],
                                    lambda b: b, conf_thres, iou_thres,
                                    max_det, True)
                gaps += [e.cpu().numpy(), c.cpu().numpy()]
                rule = max(rule, r)
                args = (proto[i], dec[i], nc, served, anchors[g], bits[g], n,
                        img_hw)
                mgap = max(mgap, mask_gap_one(*args))
                if each_image is not None:
                    each_image(*args)
                hp, wp = proto.shape[2:]
                if n:
                    inside = crop(torch.as_tensor(boxes[g, :n],
                                                  dtype=torch.float64),
                                  hp, wp, img_hw)
                    crop_px += int(inside.sum())
            cand += [r_["candidates"] for r_ in ref_kept]
            kept += [len(r_["scores"]) for r_ in ref_kept]
        counts[k] = {"candidates": cand, "kept": kept,
                     "anchors": int(dec.shape[1]), "crop_px": crop_px,
                     "served": int(np.asarray(num).sum())}
    return ({"det_gap": det_gap(np.concatenate(gaps), rule),
             "mask_gap": mgap}, counts)
