"""High-level inference API: ``Predictor`` and ``Detections``.

Counterpart of ``desenet_tpu/api.py`` without int8, multi-device or the
space-to-depth stem:

    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.utils.convert import load_npz_state_dict
    pred = Predictor("yolov5s_seg", load_npz_state_dict("sd.npz"))
    res = pred([bgr_array, "img.jpg"])
    res.xyxy[0]      # (n, 6) [x1, y1, x2, y2, conf, cls] at native pixels
    res.masks[0]     # (H0, W0) uint8 seg class ids at native resolution
    res.to_dicts()

The device program is the JAX package's: uint8 images widened in the
compute dtype (``x / 255``), the model with the one-conv FusedFocus stem
and 1/8-resolution seg logits, single-label NMS (kernel K1 on the card) and
the seg tail (kernel K2). Like the JAX package's, it needs a model with a
seg head.
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from desenet_tpu_torch.data.augment import letterbox
from desenet_tpu_torch.models import (build_model, config_path,
                                     require_seg_head)
from desenet_tpu_torch.ops import non_max_suppression, np_scale_coords
from desenet_tpu_torch.ops.seg_pallas import upsample_argmax
from desenet_tpu_torch.utils.convert import load_state_dict


class Detections:
    """Result container: per-image boxes and seg masks, numpy."""

    def __init__(self, imgs_bgr, xyxy, masks, names, se_names):
        self.imgs = imgs_bgr  # native BGR images
        self.xyxy = xyxy  # list of (n, 6) [x1,y1,x2,y2,conf,cls]
        self.masks = masks  # list of (H0, W0) class-id masks
        self.names = names
        self.se_names = se_names
        self.n = len(imgs_bgr)

    def to_dicts(self) -> List[List[dict]]:
        return [[dict(xmin=float(r[0]), ymin=float(r[1]), xmax=float(r[2]),
                      ymax=float(r[3]), confidence=float(r[4]),
                      cls=int(r[5]), name=self.names[int(r[5])])
                 for r in d]
                for d in self.xyxy]

    def __len__(self):
        return self.n

    def __repr__(self):
        return (f"Detections({self.n} images, dets per image "
                f"{[len(d) for d in self.xyxy]})")


class Predictor:
    """Serve a ``DeSeNet`` config with given weights.

    cfg: a bundled config name (``"yolov5s_seg"``), a .json/.yaml path or a
    config dict. state_dict: torch-named weights, from
    ``models.init_weights``, ``utils.convert.state_dict_from_jax`` or
    ``utils.convert.load_npz_state_dict``; Focus-layout stem weights are
    rearranged for the FusedFocus stem at load. ``half=True`` runs bf16
    weights and activations (NMS and decode stay f32). ``fuse_focus=False``
    serves the reference's slice-concat Focus stem instead (the same
    function; for A/B). Raises ValueError for a config with no seg head."""

    def __init__(self, cfg, state_dict: Mapping[str, torch.Tensor],
                 imgsz: int = 640, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 half: bool = True, device="cuda",
                 names: Optional[Sequence[str]] = None,
                 se_names: Optional[Sequence[str]] = None,
                 fuse_focus: bool = True):
        if isinstance(cfg, str):
            cfg = config_path(cfg)
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if half else torch.float32
        model, self.spec = build_model(cfg, seg_upsample=False,
                                       fuse_focus=fuse_focus)
        require_seg_head(self.spec, "Predictor")
        load_state_dict(model, state_dict)
        # NCHW in the channels_last memory format on the card (cuDNN's NHWC
        # kernels); the default layout on the CPU
        self._mf = (torch.channels_last if self.device.type == "cuda"
                    else torch.contiguous_format)
        self.model = model.to(self.device, self.dtype,
                              memory_format=self._mf)
        self.imgsz = imgsz
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.names = list(names) if names else [
            str(i) for i in range(self.spec.de_nc)]
        self.se_names = list(se_names) if se_names else [
            str(i) for i in range(self.spec.se_nc)]

    @torch.inference_mode()
    def infer(self, img_u8: torch.Tensor):
        """The device program: (B, H, W, 3) uint8 RGB on the device ->
        (NMSOutput, (B, H, W) uint8 seg class map)."""
        x = img_u8.permute(0, 3, 1, 2).to(self.dtype)
        x = x.contiguous(memory_format=self._mf) / 255
        (dec, _), seg = self.model(x)
        nms = non_max_suppression(dec, conf_thres=self.conf_thres,
                                  iou_thres=self.iou_thres,
                                  max_det=self.max_det)
        seg_cls = upsample_argmax(seg.permute(0, 2, 3, 1).contiguous(),
                                  scale=8, align_corners=True)
        return nms, seg_cls

    @staticmethod
    def _to_bgr(im) -> np.ndarray:
        """path / ndarray (BGR HWC) / PIL image -> BGR uint8."""
        if isinstance(im, (str, os.PathLike)):
            import cv2

            out = cv2.imread(str(im))
            if out is None:
                raise FileNotFoundError(f"image not found or unreadable: {im}")
            return out
        if hasattr(im, "mode"):  # PIL
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])
        arr = np.asarray(im)
        if arr.dtype != np.uint8:
            arr = (arr * 255).clip(0, 255).astype(np.uint8)
        return arr

    def __call__(self, inputs: Union[str, np.ndarray, Sequence]) -> Detections:
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        imgs0 = [self._to_bgr(im) for im in inputs]
        rgb = [np.ascontiguousarray(
            letterbox(im, self.imgsz)[0]
            [:, :, ::-1]) for im in imgs0]
        h, w = rgb[0].shape[:2]
        batch = torch.from_numpy(np.stack(rgb)).to(self.device)
        nms, seg_cls = self.infer(batch)

        boxes = nms.boxes.cpu().numpy()
        scores = nms.scores.cpu().numpy()
        classes = nms.classes.cpu().numpy()
        nums = nms.num.cpu().numpy()
        seg_np = seg_cls.cpu().numpy()

        xyxy, masks = [], []
        for i, im0 in enumerate(imgs0):
            n = int(nums[i])
            d = np.concatenate(
                [boxes[i, :n], scores[i, :n, None], classes[i, :n, None]],
                axis=1).astype(np.float64)
            if n:
                np_scale_coords((h, w), d[:, :4], im0.shape[:2])
            xyxy.append(d)
            # undo letterbox on the mask: crop the pad, nearest-resize
            gain = min(h / im0.shape[0], w / im0.shape[1])
            pw = int(round((w - im0.shape[1] * gain) / 2))
            ph = int(round((h - im0.shape[0] * gain) / 2))
            m = seg_np[i][ph:h - ph or None, pw:w - pw or None]
            if m.shape != im0.shape[:2]:
                import cv2

                m = cv2.resize(m, (im0.shape[1], im0.shape[0]),
                               interpolation=cv2.INTER_NEAREST)
            masks.append(m)
        return Detections(imgs0, xyxy, masks, names=self.names,
                          se_names=self.se_names)
