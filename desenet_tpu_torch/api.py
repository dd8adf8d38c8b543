"""High-level inference API: ``Predictor`` and ``Detections``.

Counterpart of ``desenet_tpu/api.py``:

    from desenet_tpu_torch.api import Predictor, load_predictor
    from desenet_tpu_torch.utils.convert import load_npz_state_dict
    pred = Predictor("yolov5s_seg", load_npz_state_dict("sd.npz"))
    pred = load_predictor("runs/train/exp/best")   # a checkpoint directory
    res = pred([bgr_array, "img.jpg"])
    res.xyxy[0]      # (n, 6) [x1, y1, x2, y2, conf, cls] at native pixels
    res.masks[0]     # (H0, W0) uint8 seg class ids at native resolution
    res.to_dicts(), res.pandas(), res.save("out/"), res.crop("out/crops")

The device program is the JAX package's: uint8 images widened in the
compute dtype (``x / 255``), the model with the one-conv FusedFocus stem
and 1/8-resolution seg logits, single-label NMS (kernel K1 on the card) and
the seg tail (kernel K2). Like the JAX package's, it needs a model with a
seg head. On the card each replica is ``DeSeNet.fuse()``'d once placed:
every conv whose BN runs is followed by one pass of BN, SiLU and shortcut
(``ops/conv_epilogue.py``), and a bf16 replica's FusedFocus stem takes
the uint8 batch as uploaded, widening it inside its conv, BN and SiLU
(``ops/stem_pallas.served_stem``); on the CPU the model runs unfused on
the widened batch.

``Predictor(..., stem_s2d=True)`` serves the JAX package's phase-layout
stem (``models/layers.py`` ``PhaseStemA``/``PhaseStemB``): the host packs
each batch in space-to-depth-4 layout (``native.assemble_batch_s2d4``,
(B, H/4, W/4, 48) uint8) and the first two layers run as a 3x3 conv of
48 input channels and a 2x2 conv of 4 x 32, at the H/4 grid. ``None``
(the default) means off in the port; the JAX package turns it on only on
a TPU. A config whose stem it cannot rewrite (``build._check_stem_s2d``)
and ``int8=True`` build the standard stem, and ``Predictor.stem_s2d``
says which was built.

``Predictor(..., int8=True, calib=[images])`` serves the int8 W8A8
program instead (``quant.quantize_for_inference``: calibrated on the
letterboxed ``calib`` images, every conv the int8 kernel of
``ops/int8_conv.py`` on the card): full-resolution logits argmaxed on the
device, as the JAX package's int8 program does, so no seg tail; NMS stays
K1.

``Predictor(..., n_devices=N)`` serves over N devices, as the JAX
package's data-parallel ``Predictor`` does over a 1-D mesh: one replica of
the model on each of ``cuda:0`` to ``cuda:N-1`` (N replicas on the CPU
for ``device="cpu"``), each batch padded to a multiple of N by repeating
its last image and split in N slices, each slice uploaded from pinned
memory and every replica's program (forward, K1, K2) queued before any
result is copied back, with the intent that the cards overlap (not yet
measured on two cards); the padded rows are dropped. Every replica holds
the same weights, so the results are those of one device.

``run_batch`` brings its results back by one path on every device: one
fresh host tensor an output, each replica's outputs copied into its rows.
On the card the tensors are pinned, from PyTorch's caching host
allocator, and every replica's copies are queued before one wait a
replica; their blocks go back to the allocator's cache when the arrays
are dropped, so no buffer is reused while a caller holds results. On the
CPU the tensors are pageable and each replica's copies run in turn. The
arrays it returns are views of those tensors: on the CPU, copies of the
program's outputs. ``__call__``'s masks are copies, so a ``Detections``
holds no batch's pinned block.

A model with a ``Segment`` row (YOLOv5 v7.0's instance segmentation,
``yolov5x_v7seg``) serves instance masks in place of the seg map: the
forward gives the decode and the prototypes, K1 also returns each kept
box's anchor (``ops/nms_fused.py``, the class scores read from columns 5
to 5+nc), and ``ops/mask_assembly.py`` (its kernel on the card) packs each
kept box's mask at the prototypes' resolution, 1/4 of the input, as v7.0's
``process_mask(..., upsample=False)``; no seg tail runs. ``run_batch``
then returns (boxes, scores, classes, num, masks (B, max_det, H/4, W/32)
uint8 bits, anchors (B, max_det) int32) and ``__call__`` each box's mask,
unpacked, at the frame's size. A box's anchor is the row of the model's
decode it came from (its level, anchor shape and grid cell; -1 past
``num``): it tells which cell fired, and indexes the decode (the
model's first output) for the box's 32 mask coefficients or its other
classes' scores. The
int8 program takes no such model.

With tracing on (``utils/profiling``), ``__call__`` records the spans
``predict.call`` (``predict.letterbox``, ``predict.stack``, then
``run_batch``'s, then ``predict.post``), ``run_batch`` records
``predict.run_batch`` around ``predict.pin``, ``predict.upload``,
``predict.infer`` (a replica each, attr ``replica``) and one
``predict.download`` a replica (on the card the wait for that replica's
copies, on the CPU the copies) and adds the results' bytes to the
counters ``download.pinned_bytes`` (copied into pinned memory: on the
card) and ``download.pageable_bytes`` (copied into pageable memory: on
the CPU), and ``infer`` records ``infer.forward``,
``infer.nms`` (K1 with its prep) and ``infer.seg_tail`` (K2), or for a
``Segment`` model ``infer.masks`` (the mask assembly, which counts
``masks.images`` and ``masks.kept``; the forward's device span
``forward.proto`` times Proto).
"""

from __future__ import annotations

import copy
import os
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from desenet_tpu_torch import native
from desenet_tpu_torch.data.augment import letterbox
from desenet_tpu_torch.models import (build_model, config_path,
                                     mask_coefficients, parse_config,
                                     require_seg_head)
from desenet_tpu_torch.ops import non_max_suppression, np_scale_coords
from desenet_tpu_torch.ops.mask_assembly import assemble_masks
from desenet_tpu_torch.ops.nms import MAX_WH, NMSOutput
from desenet_tpu_torch.ops.nms_fused import fused_select_nms
from desenet_tpu_torch.ops.seg_pallas import upsample_argmax
from desenet_tpu_torch.parallel.mesh import Mesh, pad_batch_for_mesh
from desenet_tpu_torch.utils.convert import load_state_dict
from desenet_tpu_torch.utils.general import save_one_box
from desenet_tpu_torch.utils.plots import Annotator, SegAnnotator, colors
from desenet_tpu_torch.utils.profiling import count, span


class Detections:
    """Result container: per-image boxes and seg masks, numpy."""

    def __init__(self, imgs_bgr, xyxy, masks, names, se_names, times=None):
        self.imgs = imgs_bgr  # native BGR images
        self.xyxy = xyxy  # list of (n, 6) [x1,y1,x2,y2,conf,cls]
        # list of (H0, W0) class-id masks, or of a Segment model's (n, H0,
        # W0) 0/1 masks, one a box
        self.masks = masks
        self.names = names
        self.se_names = se_names
        self.n = len(imgs_bgr)
        self.times = times or {}

    @property
    def xywh(self) -> List[np.ndarray]:
        out = []
        for d in self.xyxy:
            o = d.copy()
            o[:, 0] = (d[:, 0] + d[:, 2]) / 2
            o[:, 1] = (d[:, 1] + d[:, 3]) / 2
            o[:, 2] = d[:, 2] - d[:, 0]
            o[:, 3] = d[:, 3] - d[:, 1]
            out.append(o)
        return out

    @staticmethod
    def _normalized(imgs, dets) -> List[np.ndarray]:
        out = []
        for im, d in zip(imgs, dets):
            h, w = im.shape[:2]
            o = d.copy()
            o[:, [0, 2]] /= w
            o[:, [1, 3]] /= h
            out.append(o)
        return out

    @property
    def xyxyn(self) -> List[np.ndarray]:
        """Boxes normalized by the native image size."""
        return self._normalized(self.imgs, self.xyxy)

    @property
    def xywhn(self) -> List[np.ndarray]:
        return self._normalized(self.imgs, self.xywh)

    def pandas(self, kind: str = "xyxy"):
        """Per-image DataFrames; ``kind`` in {xyxy, xyxyn, xywh, xywhn}.
        Needs pandas."""
        import pandas as pd

        cols = {
            "xyxy": ["xmin", "ymin", "xmax", "ymax"],
            "xyxyn": ["xmin", "ymin", "xmax", "ymax"],
            "xywh": ["xcenter", "ycenter", "width", "height"],
            "xywhn": ["xcenter", "ycenter", "width", "height"],
        }[kind]
        return [pd.DataFrame(
            [[*r[:4], r[4], int(r[5]), self.names[int(r[5])]] for r in d],
            columns=cols + ["confidence", "class", "name"])
            for d in getattr(self, kind)]

    def tolist(self) -> List["Detections"]:
        """One Detections an image."""
        return [Detections([self.imgs[i]], [self.xyxy[i]], [self.masks[i]],
                           self.names, self.se_names, self.times)
                for i in range(self.n)]

    def to_dicts(self) -> List[List[dict]]:
        return [[dict(xmin=float(r[0]), ymin=float(r[1]), xmax=float(r[2]),
                      ymax=float(r[3]), confidence=float(r[4]),
                      cls=int(r[5]), name=self.names[int(r[5])])
                 for r in d]
                for d in self.xyxy]

    def render(self) -> List[np.ndarray]:
        """Annotated BGR images: boxes and the seg overlay (cv2)."""
        seg_ann = SegAnnotator()
        out = []
        for im, d, m in zip(self.imgs, self.xyxy, self.masks):
            if m.ndim == 3:  # instance masks: their union as class 1
                m = (m.max(0) if len(m) else
                     np.zeros(im.shape[:2], np.uint8))
            ann = Annotator(np.ascontiguousarray(im))
            for *xyxy, conf, c in d:
                ann.box_label(xyxy, f"{self.names[int(c)]} {conf:.2f}",
                              colors(int(c), True))
            out.append(seg_ann.overlay(ann.result(), m))
        return out

    def save(self, save_dir: str = "runs/predict"):
        """``render``'s images as ``image{i}.jpg`` in ``save_dir``."""
        import cv2

        os.makedirs(save_dir, exist_ok=True)
        for i, im in enumerate(self.render()):
            cv2.imwrite(os.path.join(save_dir, f"image{i}.jpg"), im)
        return save_dir

    def crop(self, save_dir: str = "runs/predict/crops"):
        """Every box cut out (``utils.general.save_one_box``) as
        ``{name}_{k}.jpg`` in ``save_dir``."""
        os.makedirs(save_dir, exist_ok=True)
        k = 0
        for im, d in zip(self.imgs, self.xyxy):
            for *xyxy, conf, c in d:
                save_one_box(xyxy, im, file=os.path.join(
                    save_dir, f"{self.names[int(c)]}_{k}.jpg"))
                k += 1
        return save_dir

    def __len__(self):
        return self.n

    def __repr__(self):
        return (f"Detections({self.n} images, dets per image "
                f"{[len(d) for d in self.xyxy]})")


def _largest_stride(spec, imgsz: int) -> int:
    """The model's largest output stride; ValueError where ``imgsz`` is no
    multiple of it."""
    stride = max(spec.det_strides, default=32)
    if imgsz % stride:
        raise ValueError(f"imgsz {imgsz} is not a multiple of the model's "
                         f"largest stride {stride}")
    return stride


class Predictor:
    """Serve a ``DeSeNet`` config with given weights.

    cfg: a bundled config name (``"yolov5s_seg"``), a .json/.yaml path or a
    config dict. state_dict: torch-named weights, from
    ``models.init_weights``, ``utils.convert.state_dict_from_jax`` or
    ``utils.convert.load_npz_state_dict``; Focus-layout stem weights are
    rearranged for the FusedFocus stem at load. ``half=True`` runs bf16
    weights and activations (NMS and decode stay f32). ``fuse_focus=False``
    serves the reference's slice-concat Focus stem instead (the same
    function; for A/B). ``nc``, ``se_nc`` and ``anchors`` override the
    config's. Raises ValueError for a config with no seg head, and for an
    ``imgsz`` that is no multiple of the model's largest stride (64 for a
    P6 model such as ``yolov5x6_seg``, 32 for the P5 ones).

    ``int8=True``: the int8 W8A8 program, calibrated on ``calib`` (a few
    representative images: paths, BGR arrays or PIL images; ValueError
    without them), per-channel activation scales and bias correction (the
    JAX package's defaults); its parameters stay f32 and ``half`` sets the
    dtype of its input and fp pieces.

    ``stem_s2d``: the phase-layout stem (module docstring); None or False
    the standard one.

    ``n_devices``: replicas on that many devices (module docstring);
    ValueError with more than ``torch.cuda.device_count()`` on the card.
    ``bake_weights``: accepted for the JAX package's signature and has no
    effect. There it chooses between weights compiled into each program
    and weights passed to it; eager PyTorch holds one copy of the weights
    a replica either way."""

    def __init__(self, cfg, state_dict: Mapping[str, torch.Tensor],
                 imgsz: int = 640, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 half: bool = True, device="cuda",
                 names: Optional[Sequence[str]] = None,
                 se_names: Optional[Sequence[str]] = None,
                 fuse_focus: bool = True, nc: Optional[int] = None,
                 se_nc: Optional[int] = None,
                 anchors: Optional[Sequence] = None, int8: bool = False,
                 calib: Optional[Sequence] = None, n_devices: int = 1,
                 bake_weights: bool = True, stem_s2d: Optional[bool] = None):
        if isinstance(cfg, str):
            cfg = config_path(cfg)
        self.device = torch.device(device)
        self.n_devices = max(1, int(n_devices))
        del bake_weights  # no effect (class docstring)
        if self.device.type == "cuda" and self.n_devices > 1:
            avail = torch.cuda.device_count()
            if self.n_devices > avail:
                raise ValueError(f"n_devices={n_devices} but only {avail} "
                                 "devices are visible")
            devices = [torch.device("cuda", i) for i in range(self.n_devices)]
            self.device = devices[0]
        else:
            if self.device.type == "cuda" and self.device.index is None:
                # held by index: a kernel launch on another card (another
                # replica's, another Predictor's) leaves that card current
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            devices = [self.device] * self.n_devices
        self.dtype = torch.bfloat16 if half else torch.float32
        self.int8 = int8
        # NCHW in the channels_last memory format on the card (cuDNN's NHWC
        # kernels); the default layout on the CPU
        self._mf = (torch.channels_last if self.device.type == "cuda"
                    else torch.contiguous_format)
        if int8:
            if mask_coefficients(parse_config(cfg, nc=nc, se_nc=se_nc)):
                raise ValueError("int8=True: the int8 program takes no "
                                 "Segment model (instance masks)")
            if not calib:
                raise ValueError(
                    "int8=True needs calib=[...]: a few representative "
                    "images (paths/arrays/PIL)")
            from desenet_tpu_torch.quant import quantize_for_inference

            # checked before calibrating, whose forward a wrong size breaks
            stride = _largest_stride(parse_config(
                cfg, nc=nc, se_nc=se_nc, anchors=anchors), imgsz)
            lb = [letterbox(self._to_bgr(im), imgsz, auto=False,
                            stride=stride)[0] for im in calib]
            cal = torch.from_numpy(np.stack(
                [np.ascontiguousarray(x[:, :, ::-1]) for x in lb])).permute(
                    0, 3, 1, 2).float() / 255.0
            self.model, self.spec, _ = quantize_for_inference(
                cfg, state_dict, [cal], device=self.device,
                compute_dtype=self.dtype, nc=nc, se_nc=se_nc,
                anchors=anchors, fuse_focus=fuse_focus)
            stem_s2d = False
        else:
            kw = dict(nc=nc, se_nc=se_nc, seg_upsample=False,
                      anchors=anchors, fuse_focus=fuse_focus)
            try:
                model, self.spec = build_model(cfg, stem_s2d=bool(stem_s2d),
                                               **kw)
            except ValueError:  # a stem the phase layout cannot rewrite
                if not stem_s2d:
                    raise
                stem_s2d = False
                model, self.spec = build_model(cfg, **kw)
            _largest_stride(self.spec, imgsz)
            load_state_dict(model, state_dict)
            self.model = model.to(self.device, self.dtype,
                                  memory_format=self._mf)
        require_seg_head(self.spec, "Predictor")
        self.nm = mask_coefficients(self.spec)  # 0: the semantic seg map
        self.stem_s2d = bool(stem_s2d)
        self.imgsz = imgsz
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.names = list(names) if names else [
            str(i) for i in range(self.spec.de_nc)]
        self.se_names = list(se_names) if se_names else [
            str(i) for i in range(self.spec.se_nc)]
        self._place_replicas(devices)
        if not int8:  # the int8 program has its own epilogue
            for dev, model in self._replicas:
                if dev.type == "cuda":
                    model.fuse()

    def _place_replicas(self, devices: Sequence[torch.device]) -> None:
        """One replica of the model on each of ``devices`` (a device named
        twice takes two slices of each batch on one replica)."""
        models = {self.device: self.model}
        for d in devices:
            d = torch.device(d)
            if d not in models:
                models[d] = copy.deepcopy(self.model).to(d)
        self._replicas = [(torch.device(d), models[torch.device(d)])
                          for d in devices]

    @torch.inference_mode()
    def infer(self, img_u8: torch.Tensor, model=None):
        """The device program: (B, H, W, 3) uint8 RGB on the device, or
        with ``stem_s2d`` its (B, H/4, W/4, 48) space-to-depth-4 packing ->
        (NMSOutput, (B, H, W) uint8 seg class map), or for a ``Segment``
        model (NMSOutput, (B, max_det, H/4, W/32) uint8 mask bits, (B,
        max_det) int32 anchors of the kept boxes); ``model`` a replica
        (the first by default). A card replica whose row 0 can take the
        uint8 batch (``DeSeNet.uint8_refusal``: ``fuse()``'d, bf16, the
        standard stem) gets its channels_last view, and row 0 widens it;
        any other gets it widened here."""
        model = model or self.model
        with span("infer.forward"):
            x = img_u8.permute(0, 3, 1, 2)
            if not (x.is_cuda and model.uint8_refusal(x) is None):
                x = x.to(self.dtype).contiguous(memory_format=self._mf) / 255
            (dec, _), seg = model(x)
        if self.nm:
            return self._instance_masks(dec, seg, x.shape[2:])
        with span("infer.nms"):
            nms = non_max_suppression(dec, conf_thres=self.conf_thres,
                                      iou_thres=self.iou_thres,
                                      max_det=self.max_det)
        if self.int8:  # the int8 program emits full-resolution logits
            return nms, seg.argmax(1).to(torch.uint8)
        with span("infer.seg_tail"):
            seg_cls = upsample_argmax(seg.permute(0, 2, 3, 1).contiguous(),
                                      scale=8, align_corners=True)
        return nms, seg_cls

    def _instance_masks(self, dec, proto, img_hw):
        """K1 with each pick's anchor, then the kept boxes' masks."""
        nc = self.spec.de_nc
        with span("infer.nms"):
            *res, index = fused_select_nms(
                dec, self.conf_thres, self.iou_thres, self.max_det,
                max_wh=MAX_WH, nc=nc, return_index=True)
            nms = NMSOutput(*res, res[3].sum(1).to(torch.int32))
        with span("infer.masks"):
            masks = assemble_masks(dec, index, nms.boxes, nms.num, proto, nc,
                                   tuple(img_hw))
        return nms, masks, index

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
        with span("predict.call", n=len(inputs)):
            with span("predict.letterbox"):
                imgs0 = [self._to_bgr(im) for im in inputs]
                rgb = [np.ascontiguousarray(
                    letterbox(im, self.imgsz)[0]
                    [:, :, ::-1]) for im in imgs0]
            # the network input's size, before any packing: with stem_s2d
            # the batch is (B, H/4, W/4, 48), and the letterbox is undone
            # from H, W
            h, w = rgb[0].shape[:2]
            with span("predict.stack"):
                batch = (native.assemble_batch_s2d4(rgb) if self.stem_s2d
                         else np.stack(rgb))
            boxes, scores, classes, nums, seg_np, *_ = self.run_batch(batch)

            with span("predict.post"):
                xyxy, masks = [], []
                for i, im0 in enumerate(imgs0):
                    n = int(nums[i])
                    d = np.concatenate(
                        [boxes[i, :n], scores[i, :n, None],
                         classes[i, :n, None]], axis=1).astype(np.float64)
                    if n:
                        np_scale_coords((h, w), d[:, :4], im0.shape[:2])
                    xyxy.append(d)
                    if self.nm:
                        masks.append(_frame_masks(seg_np[i, :n],
                                                  im0.shape[:2]))
                        continue
                    # undo letterbox on the mask: crop the pad,
                    # nearest-resize
                    gain = min(h / im0.shape[0], w / im0.shape[1])
                    pw = int(round((w - im0.shape[1] * gain) / 2))
                    ph = int(round((h - im0.shape[0] * gain) / 2))
                    m = seg_np[i][ph:h - ph or None, pw:w - pw or None]
                    if m.shape != im0.shape[:2]:
                        import cv2

                        m = cv2.resize(m, (im0.shape[1], im0.shape[0]),
                                       interpolation=cv2.INTER_NEAREST)
                    else:  # still a view of the batch's (pinned) seg map
                        m = m.copy()
                    masks.append(m)
        return Detections(imgs0, xyxy, masks, names=self.names,
                          se_names=self.se_names)

    def run_batch(self, batch: np.ndarray):
        """The device program over the replicas on a (B, H, W, 3) uint8
        batch (with ``stem_s2d`` a (B, H/4, W/4, 48) one): padded to a
        multiple of the replica count (``pad_batch_for_mesh``: the last
        image repeated), a slice a replica, all queued before any copy to
        the host. Returns numpy (boxes, scores, classes, num, seg classes)
        of the B images (a ``Segment`` model: (boxes, scores, classes,
        num, mask bits, anchors), module docstring), each a view of a
        fresh host tensor (every replica's rows of one output in one
        tensor; ``_download``): on the card a pinned one, its block back
        in PyTorch's host cache once the array is dropped; on the CPU a
        pageable one, so the arrays are copies of the program's outputs,
        not views of them."""
        n, k = batch.shape[0], len(self._replicas)
        with span("predict.run_batch", n=n):
            batch = pad_batch_for_mesh({"image": batch},
                                       Mesh(k, 1))[0]["image"]
            outs = []
            for r, ((dev, model), part) in enumerate(
                    zip(self._replicas, np.split(batch, k))):
                with span("predict.pin", replica=r):
                    x = torch.from_numpy(part)
                    if dev.type == "cuda":
                        x = x.pin_memory()
                with span("predict.upload", replica=r):
                    x = x.to(dev, non_blocking=True)
                with span("predict.infer", replica=r):
                    nms, *rest = self.infer(x, model)
                outs.append((nms.boxes, nms.scores, nms.classes, nms.num,
                             *rest))
            host = self._download(outs)
            return tuple(h[:n].numpy() for h in host)

    def _download(self, outs) -> List[torch.Tensor]:
        """Each output of every replica copied into its rows of one fresh
        host tensor, pinned when the replicas are on a card. On the card
        every copy is queued on its replica's current stream, then one
        event a replica is waited for (``predict.download``); on the CPU
        each replica's copies run inside its ``predict.download``."""
        m = outs[0][0].shape[0]
        pinned = self.device.type == "cuda"
        host = [torch.empty((len(outs) * m,) + v.shape[1:], dtype=v.dtype,
                            pin_memory=pinned) for v in outs[0]]

        def copy_rows(r):
            for h, v in zip(host, outs[r]):
                h[r * m:(r + 1) * m].copy_(v, non_blocking=True)

        waits = []
        for r, (dev, _) in enumerate(self._replicas):
            if pinned:
                copy_rows(r)
                waits.append(
                    torch.cuda.current_stream(dev).record_event().synchronize)
            else:
                waits.append(lambda r=r: copy_rows(r))
        for r, wait in enumerate(waits):
            with span("predict.download", replica=r):
                wait()
        nbytes = sum(h.nbytes for h in host)
        count("download.pinned_bytes", nbytes if pinned else 0)
        count("download.pageable_bytes", 0 if pinned else nbytes)
        return host


def _frame_masks(bits: np.ndarray, frame_hw) -> np.ndarray:
    """A ``Segment`` model's (n, hp, wp / 8) packed masks of one image at
    the prototypes' scale -> (n, H0, W0) uint8 0/1 masks of the frame: the
    letterbox's pad cropped at that scale (v7.0's ``scale_image``
    arithmetic), then a nearest resize (cv2's ``INTER_NEAREST`` pick,
    source pixel ``floor(dst * src / dst_size)``)."""
    m = np.unpackbits(bits, axis=-1, bitorder="little")
    hp, wp = m.shape[1:]
    h0, w0 = frame_hw
    gain = min(hp / h0, wp / w0)
    pad_w, pad_h = (wp - w0 * gain) / 2, (hp - h0 * gain) / 2
    m = m[:, int(pad_h):int(hp - pad_h), int(pad_w):int(wp - pad_w)]
    ys = np.arange(h0) * m.shape[1] // h0
    xs = np.arange(w0) * m.shape[2] // w0
    return np.ascontiguousarray(m[:, ys[:, None], xs[None, :]])


def load_predictor(weights: str, **kw) -> Predictor:
    """A ``Predictor`` of the port's checkpoint directory ``weights`` (its
    EMA where it has one): meta.json supplies the config, the class counts
    and names and autoanchor's anchors where training wrote them; ``kw``
    goes to ``Predictor``."""
    from desenet_tpu_torch.utils.checkpoint import load_inference_variables

    sd, meta = load_inference_variables(weights)
    if meta is None:
        raise ValueError(f"{weights}: checkpoint has no meta.json")
    kw = {"names": meta.get("de_names"), "se_names": meta.get("se_names"),
          "anchors": meta.get("anchors"), **kw}
    return Predictor(meta["cfg"], sd, nc=meta["de_nc"], se_nc=meta["se_nc"],
                     **kw)
