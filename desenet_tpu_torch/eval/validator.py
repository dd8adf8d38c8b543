"""Joint validation: detection mAP + segmentation mIoU.

Counterpart of ``desenet_tpu/eval/validator.py``: conf 0.001 / IoU 0.6
multi-label NMS over the top ``PRE_TOPK_VAL`` candidates (kernel K3 on the
card), native-space coordinate rescale, 10-threshold TP matching, 101-point
AP; seg logits -> argmax -> pixAcc/mIoU with class 0 excluded. The metrics
are ``desenet_tpu_torch.utils.metrics`` (numpy only).

The device step (uint8 -> ``x / 255`` in the model dtype, forward, decode,
NMS, seg argmax) runs on the validator's device; only the fixed-shape NMS
outputs and the (B, H, W) uint8 class maps come back to the host. The timing
split is host-to-device staging / device step / host metrics.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.eval.tta import forward_augment_joint
from desenet_tpu_torch.utils.metrics import (
    ConfusionMatrix,
    SegMetrics,
    ap_per_class,
    match_predictions,
)
from desenet_tpu_torch.models.build import (mask_coefficients,
                                            require_seg_head)
from desenet_tpu_torch.ops import PRE_TOPK_VAL, non_max_suppression
from desenet_tpu_torch.ops.boxes import np_scale_coords


def np_xywh2xyxy(x):
    y = np.empty_like(x)
    y[:, 0] = x[:, 0] - x[:, 2] / 2
    y[:, 1] = x[:, 1] - x[:, 3] / 2
    y[:, 2] = x[:, 0] + x[:, 2] / 2
    y[:, 3] = x[:, 1] + x[:, 3] / 2
    return y


def _model_device_dtype(model, device):
    """(device, input dtype): the model's compute dtype where it has one
    (an int8 model keeps f32 parameters), else its parameters'."""
    p = next(model.parameters())
    dtype = getattr(model, "compute_dtype", None) or p.dtype
    return torch.device(device) if device is not None else p.device, dtype


def _to_input(img_u8: torch.Tensor, dtype, device) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> NCHW in [0, 1] in the model dtype, in the
    channels_last memory format on the card."""
    mf = (torch.channels_last if device.type == "cuda"
          else torch.contiguous_format)
    x = img_u8.permute(0, 3, 1, 2).to(dtype)
    return x.contiguous(memory_format=mf) / 255


class Validator:
    """``model``: a port ``DeSeNet`` (or an ``eval.ensemble.EnsembleModel``
    of them) in eval mode with full-resolution seg logits
    (``seg_upsample=True``) and a seg head (ValueError otherwise), already
    on ``device`` (default: where its parameters are) in its compute dtype.
    ``augment``: test-time augmentation (``eval.tta.forward_augment_joint``)
    in the device step."""

    def __init__(
        self,
        model,
        nc: int,
        se_nc: int,
        conf_thres: float = 0.001,
        iou_thres: float = 0.6,
        max_det: int = 300,
        pre_topk: Optional[int] = None,
        single_cls: bool = False,
        plots: bool = False,
        save_dir: str = "",
        names: Optional[Dict[int, str]] = None,
        augment: bool = False,
        save_txt: bool = False,
        save_conf: bool = False,
        save_json: bool = False,
        save_hybrid: bool = False,
        class_map: Optional[Sequence[int]] = None,
        device=None,
    ):
        if hasattr(model, "spec"):
            require_seg_head(model.spec, "Validator")
            if mask_coefficients(model.spec):
                raise NotImplementedError(
                    "Validator: a Segment model (instance masks) has no "
                    "validation in the port (no mask mAP)")
        self.model = model
        self.device, self.dtype = _model_device_dtype(model, device)
        self.nc = nc
        self.se_nc = se_nc
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.pre_topk = PRE_TOPK_VAL if pre_topk is None else pre_topk
        self.single_cls = single_cls
        self.plots = plots
        self.save_dir = save_dir
        self.names = names or {i: str(i) for i in range(nc)}
        self.augment = augment
        self.save_txt = save_txt
        self.save_conf = save_conf
        self.save_json = save_json
        # ground-truth boxes injected pre-NMS as conf-1.0 candidates for
        # auto-labelling; metrics are then not meaningful
        self.save_hybrid = save_hybrid
        self.class_map = list(class_map) if class_map is not None else None
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.jdict = []

    @torch.inference_mode()
    def eval_step(self, img_u8: torch.Tensor, tgts: torch.Tensor,
                  tmask: torch.Tensor):
        """The device step: (B, H, W, 3) uint8, (B, M, 5) targets
        [cls, xywhn] and (B, M) mask on the device -> (NMSOutput,
        (B, H, W) uint8 seg class map)."""
        x = _to_input(img_u8, self.dtype, self.device)
        if self.augment:
            # the det variants concatenated before NMS, their seg logits
            # averaged (eval/tta.py)
            dec, seg = forward_augment_joint(self.model, x)
        else:
            (dec, _), seg = self.model(x)
        if self.save_hybrid:
            h, w = x.shape[2:]
            box = tgts[..., 1:5] * torch.tensor([w, h, w, h],
                                                dtype=torch.float32,
                                                device=tgts.device)
            obj = tmask.float()[..., None]
            onehot = F.one_hot(tgts[..., 0].long(), self.nc).float()
            rows = torch.cat([box, obj, onehot], -1)
            dec = (list(dec) + [rows] if isinstance(dec, list)
                   else torch.cat([dec, rows.to(dec.dtype)], 1))
        nms = non_max_suppression(
            dec, conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det, pre_topk=self.pre_topk,
            multi_label=not self.single_cls and self.nc > 1,
            agnostic=self.single_cls)
        seg_cls = seg.argmax(1).to(torch.uint8)
        return nms, seg_cls

    def _save_one_txt(self, predn, shape0, path):
        """Per-image normalized-xywh prediction txt."""
        label_dir = os.path.join(self.save_dir, "labels")
        os.makedirs(label_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(str(path)))[0]
        gn = np.asarray([shape0[1], shape0[0], shape0[1], shape0[0]],
                        np.float64)
        with open(os.path.join(label_dir, stem + ".txt"), "a") as f:
            for *xyxy, conf, cls in predn.tolist():
                xywh = [
                    (xyxy[0] + xyxy[2]) / 2 / gn[0],
                    (xyxy[1] + xyxy[3]) / 2 / gn[1],
                    (xyxy[2] - xyxy[0]) / gn[2],
                    (xyxy[3] - xyxy[1]) / gn[3],
                ]
                row = [cls, *xywh, conf] if self.save_conf else [cls, *xywh]
                f.write(" ".join(f"{v:g}" for v in row) + "\n")

    def _append_json(self, predn, path):
        """COCO-format prediction records."""
        stem = os.path.splitext(os.path.basename(str(path)))[0]
        image_id = int(stem) if stem.isnumeric() else stem
        for *xyxy, conf, cls in predn.tolist():
            cid = (self.class_map[int(cls)] if self.class_map is not None
                   else int(cls))
            self.jdict.append({
                "image_id": image_id,
                "category_id": cid,
                "bbox": [round(xyxy[0], 3), round(xyxy[1], 3),
                         round(xyxy[2] - xyxy[0], 3),
                         round(xyxy[3] - xyxy[1], 3)],
                "score": round(conf, 5),
            })

    def run(self, loader) -> Dict[str, float]:
        """Validate over ``loader``'s batches (dicts with the
        ``desenet_tpu_torch.data`` collate keys: image, det_targets, det_mask,
        seg_labels, shapes and optionally paths)."""
        stats = []
        seen = 0
        self.jdict = []
        seg_m = SegMetrics(self.se_nc)
        cm = ConfusionMatrix(nc=self.nc) if self.plots else None
        dt = [0.0, 0.0, 0.0]

        for batch in loader:
            t0 = time.perf_counter()
            img = torch.from_numpy(np.asarray(batch["image"])).to(self.device)
            tgts = torch.from_numpy(
                np.asarray(batch["det_targets"], np.float32)).to(self.device)
            tmask = torch.from_numpy(np.asarray(batch["det_mask"])).to(
                self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            nms, seg_cls = self.eval_step(img, tgts, tmask)
            boxes = nms.boxes.cpu().numpy()
            scores = nms.scores.cpu().numpy()
            classes = nms.classes.cpu().numpy()
            nums = nms.num.cpu().numpy()
            seg_cls = seg_cls.cpu().numpy()
            t2 = time.perf_counter()

            seg_m.update(seg_cls, batch["seg_labels"])

            h, w = batch["image"].shape[1:3]
            for si in range(len(nums)):
                seen += 1
                n = int(nums[si])
                tmask_i = batch["det_mask"][si]
                tg = batch["det_targets"][si][tmask_i]  # (m, 5) cls, xywhn
                tcls = tg[:, 0].tolist()
                shapes = batch["shapes"][si]
                shape0 = shapes[0] if shapes is not None else (h, w)
                rp = shapes[1] if shapes is not None else None

                if n == 0:
                    if len(tg):
                        stats.append((np.zeros((0, 10), bool), np.zeros(0),
                                      np.zeros(0), tcls))
                    continue

                pred = np.concatenate(
                    [boxes[si, :n], scores[si, :n, None],
                     classes[si, :n, None]], axis=1).astype(np.float64)
                if self.single_cls:
                    pred[:, 5] = 0
                predn = pred.copy()
                np_scale_coords((h, w), predn[:, :4], shape0, rp)

                if len(tg):
                    tbox = np_xywh2xyxy(tg[:, 1:5]) * [w, h, w, h]
                    np_scale_coords((h, w), tbox, shape0, rp)
                    labelsn = np.concatenate([tg[:, 0:1], tbox], axis=1)
                    correct = match_predictions(predn, labelsn, self.iouv)
                    if cm is not None:
                        cm.process_batch(predn, labelsn)
                else:
                    correct = np.zeros((n, 10), bool)
                stats.append((correct, pred[:, 4], pred[:, 5], tcls))

                path = batch.get("paths", [None] * len(nums))[si]
                if self.save_txt and path and self.save_dir:
                    self._save_one_txt(predn, shape0, path)
                if self.save_json and path:
                    self._append_json(predn, path)
            dt[0] += t1 - t0
            dt[1] += t2 - t1
            dt[2] += time.perf_counter() - t2

        out = {
            "mp": 0.0, "mr": 0.0, "map50": 0.0, "map": 0.0,
            "miou": seg_m.miou, "pix_acc": seg_m.pix_acc, "seen": seen,
            "per_class": {},
        }
        if stats:
            flat = [np.concatenate([np.atleast_1d(np.asarray(s[i]))
                                    for s in stats], 0) for i in range(4)]
            if len(flat[0]) and flat[0].any():
                p, r, ap, _, ap_class = ap_per_class(flat[0], flat[1],
                                                     flat[2], flat[3])
                ap50, apm = ap[:, 0], ap.mean(1)
                out.update(mp=float(p.mean()), mr=float(r.mean()),
                           map50=float(ap50.mean()), map=float(apm.mean()))
                for i, c in enumerate(ap_class):
                    out["per_class"][int(c)] = dict(
                        p=float(p[i]), r=float(r[i]), ap50=float(ap50[i]),
                        ap=float(apm[i]))
        if cm is not None and self.save_dir:
            cm.plot(save_dir=self.save_dir, names=list(self.names.values()))
        if self.save_json and self.jdict and self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "predictions.json"),
                      "w") as f:
                json.dump(self.jdict, f)
        out["speed_ms"] = tuple(x / max(seen, 1) * 1e3 for x in dt)
        return out


@torch.inference_mode()
def seg_metrics(model, n_segcls: int, loader, device=None,
                on_batch=None) -> SegMetrics:
    """Seg head alone over ``loader``: the running pixAcc / mIoU
    accumulator, with ``on_batch(metrics)`` called after each batch."""
    device, dtype = _model_device_dtype(model, device)
    m = SegMetrics(n_segcls)
    for batch in loader:
        img = torch.from_numpy(np.asarray(batch["image"])).to(device)
        _, seg = model(_to_input(img, dtype, device))
        m.update(seg.argmax(1).to(torch.uint8).cpu().numpy(),
                 batch["seg_labels"])
        if on_batch is not None:
            on_batch(m)
    return m


def seg_validation(model, n_segcls: int, loader, device=None) -> float:
    """Running-mIoU eval of the seg head alone over ``loader``."""
    return seg_metrics(model, n_segcls, loader, device).miou
