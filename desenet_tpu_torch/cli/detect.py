"""Inference CLI on the port: images, videos, webcams and streams.

    python -m desenet_tpu_torch.cli.detect --weights runs/train/exp/best \\
        --source path/to/imgs --img-size 640 [--device cpu]

``--weights`` is a checkpoint directory of the port (meta.json names the
config, the class counts and names); several run an ensemble with one joint
NMS pass. Each letterboxed frame goes through ``detect_program`` (forward,
Detect decode, single-label NMS on kernel K1, the seg tail on kernel K2);
boxes are scaled to the native image, which is written annotated, with a
paletted seg overlay (``*_seg.jpg``), optional label txt files and crops,
and a video writer for videos and streams. cv2 is needed to read and write
images. The counterpart of ``desenet_tpu/cli/detect.py``; class names come
from the checkpoint's meta.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from desenet_tpu_torch.data.sources import LoadImages, LoadStreams
from desenet_tpu_torch.eval.tta import forward_augment
from desenet_tpu_torch.eval.validator import _model_device_dtype, _to_input
from desenet_tpu_torch.ops import non_max_suppression, np_scale_coords
from desenet_tpu_torch.ops.seg_pallas import upsample_argmax
from desenet_tpu_torch.utils.checkpoint import META
from desenet_tpu_torch.utils.general import (check_img_size, increment_path,
                                             save_one_box, set_logging,
                                             set_matmul_precision)
from desenet_tpu_torch.utils.plots import Annotator, SegAnnotator, colors


@torch.inference_mode()
def detect_program(model, img_u8: torch.Tensor, conf_thres: float = 0.25,
                   iou_thres: float = 0.45, max_det: int = 1000,
                   classes=None, agnostic: bool = False,
                   augment: bool = False):
    """The device program: (B, H, W, 3) uint8 RGB on the model's device ->
    (NMSOutput, (B, H, W) uint8 seg class map). ``model``: a ``DeSeNet``
    built with 1/8-resolution seg logits (``seg_upsample=False``) or an
    ``EnsembleModel`` of them. With ``augment`` the decode is the TTA one
    (``eval.tta.forward_augment``, its identity variant the plain forward)
    and the seg map stays the plain forward's."""
    device, dtype = _model_device_dtype(model, None)
    x = _to_input(img_u8, dtype, device)
    plain = model(x)
    (dec, _), seg = plain
    if augment:
        dec = forward_augment(model, x, plain=plain)
    nms = non_max_suppression(dec, conf_thres=conf_thres,
                              iou_thres=iou_thres, max_det=max_det,
                              agnostic=agnostic, classes=classes)
    seg_cls = upsample_argmax(seg.permute(0, 2, 3, 1).contiguous(), scale=8,
                              align_corners=True)
    return nms, seg_cls


def load_detector(weights, half: bool = True, device="cuda"):
    """(model with 1/8-resolution seg logits, or the ensemble of several,
    spec, the first checkpoint's meta) for the checkpoint directories
    ``weights``."""
    from desenet_tpu_torch.cli.val import load_any

    path = os.path.join(str(weights[0]), META)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{weights[0]}: not a checkpoint directory "
                                f"with a {META}")
    with open(path, encoding="utf-8") as fh:
        meta = json.load(fh)
    model, spec = load_any(None, [str(w) for w in weights], None, None, half,
                           device, seg_upsample=False)
    return model, spec, meta


def run(
    weights,
    source,
    imgsz=640,
    conf_thres=0.25,
    iou_thres=0.45,
    max_det=1000,
    save_txt=False,
    save_conf=False,
    save_crop=False,
    nosave=False,
    classes=None,
    agnostic_nms=False,
    augment=False,
    line_thickness=3,
    hide_labels=False,
    hide_conf=False,
    half=True,
    project="runs/detect",
    name="exp",
    exist_ok=False,
    visualize=False,
    device="cuda",
):
    import cv2

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA card is visible; pass "
                           "--device cpu to run on the CPU")
    save_img = not nosave
    # a webcam index, a stream url or a .txt list of them: LoadStreams
    webcam = (str(source).isnumeric()
              or str(source).lower().endswith(".txt")
              or str(source).lower().startswith(
                  ("rtsp://", "rtmp://", "http://", "https://")))
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok)
    (save_dir / "labels" if save_txt else save_dir).mkdir(parents=True,
                                                          exist_ok=True)

    weights_list = ([weights] if isinstance(weights, (str, Path))
                    else list(weights))
    model, spec, meta = load_detector(weights_list, half, device)
    stride = max(spec.det_strides)
    imgsz = check_img_size(imgsz, s=stride)
    names = meta.get("de_names") or [str(i) for i in range(spec.de_nc)]
    classes = tuple(classes) if classes is not None else None

    dataset = (LoadStreams(source, img_size=imgsz, stride=stride) if webcam
               else LoadImages(source, img_size=imgsz, stride=stride))
    seg_ann = SegAnnotator()
    vid_writer, vid_path = None, None
    dt = [0.0, 0.0]
    seen = 0
    for path, img, im0s, vid_cap in dataset:
        if img.ndim == 3:
            img = img[None]
        batch_u8 = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        if visualize and seen == 0 and len(weights_list) == 1:
            # per-layer feature-map grids of the first image
            from desenet_tpu_torch.utils.plots import visualize_model_features

            _, dtype = _model_device_dtype(model, None)
            outs = visualize_model_features(
                model, _to_input(batch_u8, dtype, device),
                save_dir=str(save_dir / "features"))
            print(f"feature maps: {len(outs)} layers -> "
                  f"{save_dir / 'features'}")
        t0 = time.perf_counter()
        nms, seg_cls = detect_program(model, batch_u8, conf_thres, iou_thres,
                                      max_det, classes, agnostic_nms, augment)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt[0] += time.perf_counter() - t0

        # the copies to the host are postprocess, as in the JAX CLI
        t0 = time.perf_counter()
        boxes = nms.boxes.cpu().numpy()
        scores = nms.scores.cpu().numpy()
        cls_ids = nms.classes.cpu().numpy()
        nums = nms.num.cpu().numpy()
        seg_np = seg_cls.cpu().numpy()
        batch = im0s if isinstance(im0s, list) else [im0s]
        for si, im0 in enumerate(batch):
            seen += 1
            p = Path(path[si] if isinstance(path, list) else path)
            n = int(nums[si])
            det = np.concatenate(
                [boxes[si, :n], scores[si, :n, None], cls_ids[si, :n, None]],
                axis=1)
            # the class filter ran inside NMS, before suppression
            if len(det):
                np_scale_coords(img.shape[1:3], det[:, :4], im0.shape[:2])

            ann = Annotator(np.ascontiguousarray(im0),
                            line_width=line_thickness)
            for *xyxy, conf, c in det:
                c = int(c)
                label = (None if hide_labels else
                         (names[c] if hide_conf else f"{names[c]} {conf:.2f}"))
                ann.box_label(xyxy, label or "", color=colors(c, True))
                if save_txt:
                    gn = np.array([im0.shape[1], im0.shape[0]] * 2)
                    xywh = [
                        (xyxy[0] + xyxy[2]) / 2 / gn[0],
                        (xyxy[1] + xyxy[3]) / 2 / gn[1],
                        (xyxy[2] - xyxy[0]) / gn[2],
                        (xyxy[3] - xyxy[1]) / gn[3],
                    ]
                    line = [c, *xywh, conf] if save_conf else [c, *xywh]
                    with open(save_dir / "labels" / f"{p.stem}.txt", "a") as f:
                        f.write(" ".join(f"{v:g}" for v in line) + "\n")
                if save_crop:
                    crop_dir = save_dir / "crops" / names[c]
                    crop_dir.mkdir(parents=True, exist_ok=True)
                    save_one_box(xyxy, im0,
                                 file=str(crop_dir / f"{p.stem}.jpg"))

            im_out = ann.result()
            # the seg map at network resolution, nearest to native
            mask_native = cv2.resize(seg_np[si], (im0.shape[1], im0.shape[0]),
                                     interpolation=cv2.INTER_NEAREST)
            seg_overlay = seg_ann.overlay(im_out, mask_native)

            if save_img:
                if dataset.mode == "image":
                    cv2.imwrite(str(save_dir / p.name), im_out)
                    cv2.imwrite(str(save_dir / f"{p.stem}_seg.jpg"),
                                seg_overlay)
                else:  # video or stream
                    if vid_path != str(save_dir / p.name):
                        vid_path = str(save_dir / p.name)
                        if vid_writer is not None:
                            vid_writer.release()
                        fps = (vid_cap.get(cv2.CAP_PROP_FPS)
                               if vid_cap else 30.0)
                        wh = (im0.shape[1], im0.shape[0])
                        vid_writer = cv2.VideoWriter(
                            vid_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                            wh)
                    vid_writer.write(seg_overlay)
        dt[1] += time.perf_counter() - t0

    if vid_writer is not None:
        vid_writer.release()
    print(f"Speed: {dt[0] / max(seen, 1) * 1e3:.1f}ms device "
          f"(fwd+decode+NMS+seg), {dt[1] / max(seen, 1) * 1e3:.1f}ms "
          f"postprocess per image; results saved to {save_dir}")
    return str(save_dir)


def parse_opt(argv=None):
    p = argparse.ArgumentParser("desenet_tpu_torch detect")
    p.add_argument("--weights", type=str, nargs="+", required=True,
                   help="checkpoint dir(s); more than one runs an ensemble "
                        "with one joint NMS pass")
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--img-size", "--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-crop", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--classes", nargs="+", type=int)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="test-time augmentation")
    p.add_argument("--visualize", action="store_true",
                   help="dump per-layer feature-map grids for the first "
                        "image")
    p.add_argument("--line-thickness", type=int, default=3)
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--no-half", action="store_true")
    p.add_argument("--project", type=str, default="runs/detect")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                   default="default",
                   help="highest: full f32 products, TF32 off in cuBLAS and "
                        "cuDNN (use with --no-half for f32 parity)")
    return p.parse_args(argv)


def main(argv=None):
    set_logging()
    o = parse_opt(argv)
    set_matmul_precision(o.matmul_precision)
    return run(
        o.weights, o.source, o.img_size, o.conf_thres, o.iou_thres,
        o.max_det, o.save_txt, o.save_conf, o.save_crop, o.nosave, o.classes,
        o.agnostic_nms, o.augment, o.line_thickness, o.hide_labels,
        o.hide_conf, not o.no_half, o.project, o.name, o.exist_ok,
        visualize=o.visualize, device=o.device)


if __name__ == "__main__":
    main()
