"""Validation CLI on the port.

    python -m desenet_tpu_torch.cli.val --data data.yaml --cfg yolov5s_seg \\
        --weights sd.npz

Tasks: val/test/train (metrics on that split), speed (device latency at the
val shape), study (speed over image sizes). ``--weights`` is a checkpoint
directory of the port's training (``best_stripped``, or ``last``/``best``
through their EMA), whose meta.json names the config and the class counts,
or a torch-named state dict saved with ``np.savez``
(``tools/export_torch_sd.py`` writes one from a JAX checkpoint), with the
class counts from the data yaml; several ``--weights`` run an ensemble
(``eval/ensemble.py``). ``--augment`` runs test-time augmentation
(``eval/tta.py``); ``--save-json`` with ``--coco-anno`` re-scores the
exported predictions by the COCO protocol (``eval/coco.py``). ``--int8``
validates the int8 W8A8 program (``quant.quantize_for_inference``,
calibrated on ``calib_batches`` batches of the train split at
``min(8, batch)`` without augmentation; ``--int8-no-bias-correct``,
``--int8-mse-clip``, ``--int8-weights-only``, ``--int8-per-tensor`` and
``--int8-fp-hops N`` as the JAX package's), ``--act-store fp8|fp8_e5m2``
the fp8 activation-storage program; the two exclude each other.
``--matmul-precision highest`` turns TF32 off in cuBLAS and cuDNN (f32
parity with ``--no-half``), as ``cli.detect``'s does. Reading
the image dataset goes through the port's own ``desenet_tpu_torch.data``
(validation path only), which needs PIL, PyYAML for the data yaml, and cv2
where an image is resized.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from desenet_tpu_torch.eval.validator import Validator
from desenet_tpu_torch.models import build_model, config_path
from desenet_tpu_torch.ops import PRE_TOPK_VAL, non_max_suppression
from desenet_tpu_torch.utils.convert import load_npz_state_dict, load_state_dict

def load_weights(weights, cfg, nc: int, se_nc: int):
    """(state dict, cfg, nc, se_nc, anchors) for ``weights``: a port
    checkpoint directory (its EMA where it has one; its meta.json's
    ``cfg``, ``de_nc``, ``se_nc`` and autoanchor's ``anchors`` take the
    place of the arguments) or an npz state dict (the arguments stand)."""
    if not os.path.isdir(weights):
        return load_npz_state_dict(weights), cfg, nc, se_nc, None
    from desenet_tpu_torch.utils.checkpoint import load_inference_variables

    sd, meta = load_inference_variables(weights)
    meta = meta or {}
    return (sd, meta.get("cfg", cfg), int(meta.get("de_nc", nc)),
            int(meta.get("se_nc", se_nc)), meta.get("anchors"))


def load_model(cfg, weights, nc: int, se_nc: int, half: bool = True,
               device="cuda", seg_head_fused: bool = False, **build_kw):
    """Build ``cfg`` with full-resolution seg logits (unless ``build_kw``
    says ``seg_upsample=False``) and, as the JAX package's validation does,
    the one-conv FusedFocus stem, load ``weights`` (a port checkpoint
    directory or an npz state dict, ``load_weights``; a Focus stem's
    weights are rearranged at load), and place it on ``device`` in bf16
    (``half``) or f32."""
    sd, cfg, nc, se_nc, anchors = load_weights(weights, cfg, nc, se_nc)
    model, spec = build_model(config_path(cfg), nc=nc, se_nc=se_nc,
                              seg_head_fused=seg_head_fused, anchors=anchors,
                              fuse_focus=True, **build_kw)
    load_state_dict(model, sd)
    device = torch.device(device)
    mf = (torch.channels_last if device.type == "cuda"
          else torch.contiguous_format)
    dtype = torch.bfloat16 if half else torch.float32
    return model.to(device, dtype, memory_format=mf), spec


def load_any(cfg, weights, nc: int, se_nc: int, half: bool = True,
             device="cuda", seg_head_fused: bool = False, **build_kw):
    """``load_model`` for one of ``weights`` (a path or a list of them);
    for several, their ``EnsembleModel`` (the members must agree on the
    class counts). Returns (model, spec)."""
    if isinstance(weights, (str, os.PathLike)) or len(weights) == 1:
        w = weights if isinstance(weights, (str, os.PathLike)) else weights[0]
        return load_model(cfg, w, nc, se_nc, half, device, seg_head_fused,
                          **build_kw)
    from desenet_tpu_torch.eval.ensemble import EnsembleModel, load_ensemble

    members = load_ensemble(weights, cfg, nc, se_nc, half, device,
                            seg_head_fused=seg_head_fused, **build_kw)
    model = EnsembleModel([m for m, _ in members])
    return model, model.spec


def calibrate_int8(data, weights, cfg, nc: int, se_nc: int, imgsz: int,
                   batch_size: int, half: bool, device, single_cls=False,
                   calib_batches: int = 2, bias_correct: bool = True,
                   mse_clip: bool = False, weights_only: bool = False,
                   per_channel: bool = True, fp_hops: int = 1):
    """The int8 model of ``weights``: calibrated on ``calib_batches``
    batches of the train split (the val split where there is none) at
    ``min(8, batch_size)``, no augmentation. Returns (model, spec)."""
    from desenet_tpu_torch.data import create_mixed_dataloader
    from desenet_tpu_torch.models.build import parse_config
    from desenet_tpu_torch.quant import quantize_for_inference

    sd, cfg, nc, se_nc, anchors = load_weights(weights, cfg, nc, se_nc)
    cfg = config_path(cfg)
    stride = max(parse_config(cfg, nc=nc, se_nc=se_nc).det_strides)
    loader, _ = create_mixed_dataloader(
        data.get("train", data["val"]), img_size=imgsz,
        batch_size=min(8, batch_size), augment=False, rect=False,
        stride=stride, single_cls=single_cls, workers=2)
    calib = []
    for b in loader:
        calib.append(torch.from_numpy(b["image"]).permute(0, 3, 1, 2)
                     .float() / 255.0)
        if len(calib) >= calib_batches:
            break
    model, spec, _ = quantize_for_inference(
        cfg, sd, calib, bias_correct=bias_correct, mse_clip=mse_clip,
        weights_only=weights_only, per_channel_act=per_channel,
        device=device, compute_dtype=torch.bfloat16 if half
        else torch.float32, nc=nc, se_nc=se_nc, anchors=anchors,
        det_fp_hops=fp_hops)
    print(f"int8: calibrated on {len(calib)} batches "
          f"(bias_correct={bias_correct} mse_clip={mse_clip} "
          f"weights_only={weights_only} per_channel={per_channel} "
          f"fp_hops={fp_hops})")
    return model, spec


def run(
    data,
    weights,
    cfg="yolov5s_seg",
    batch_size=32,
    imgsz=640,
    conf_thres=0.001,
    iou_thres=0.6,
    task="val",
    single_cls=False,
    verbose=False,
    half=True,
    plots=False,
    save_dir="",
    workers=8,
    augment=False,
    save_txt=False,
    save_conf=False,
    save_json=False,
    save_hybrid=False,
    coco_anno="",
    int8=False,
    act_store=None,
    device="cuda",
    seg_head_fused=False,
    calib_batches=2,
    int8_bias_correct=True,
    int8_mse_clip=False,
    int8_weights_only=False,
    int8_per_channel=True,
    int8_fp_hops=1,
):
    from desenet_tpu_torch.data import create_mixed_dataloader
    from desenet_tpu_torch.utils.general import (check_dataset, check_img_size,
                                                 coco80_to_coco91_class)

    if int8 and act_store is not None:
        raise ValueError("--int8 and --act-store are mutually exclusive "
                         "inference modes")
    several = not isinstance(weights, (str, os.PathLike)) and len(weights) > 1
    if several and (int8 or act_store is not None):
        raise ValueError("--int8 and --act-store do not take an ensemble")
    # COCO's exports take its 91-id category space
    is_coco = str(data).endswith("coco.yaml")
    data = check_dataset(data)
    nc_data, se_nc_data = int(data["de"]["nc"]), int(data["se"]["nc"])
    if int8:
        w = weights if isinstance(weights, (str, os.PathLike)) else weights[0]
        model, spec = calibrate_int8(
            data, w, cfg, nc_data, se_nc_data, imgsz, batch_size, half,
            device, single_cls, calib_batches, int8_bias_correct,
            int8_mse_clip, int8_weights_only, int8_per_channel, int8_fp_hops)
    else:
        model, spec = load_any(cfg, weights, nc_data, se_nc_data, half,
                               device, seg_head_fused, act_store=act_store)
    imgsz = check_img_size(imgsz, s=max(spec.det_strides))
    nc = 1 if single_cls else int(data["de"]["nc"])
    se_nc = int(data["se"]["nc"])
    names = dict(enumerate(data["de"]["names"]))

    task = task if task in ("train", "val", "test") else "val"
    loader, _ = create_mixed_dataloader(
        data[task], img_size=imgsz, batch_size=batch_size, augment=False,
        rect=True, pad=0.5, stride=max(spec.det_strides),
        single_cls=single_cls, workers=workers)
    validator = Validator(
        model, nc=nc, se_nc=se_nc, conf_thres=conf_thres,
        iou_thres=iou_thres, single_cls=single_cls, plots=plots,
        save_dir=save_dir, names=names, augment=augment, save_txt=save_txt,
        save_conf=save_conf, save_json=save_json, save_hybrid=save_hybrid,
        class_map=coco80_to_coco91_class() if is_coco else None)
    if save_hybrid:
        print("WARNING: --save-hybrid returns high mAP from hybrid labels, "
              "not from predictions alone")
    results = validator.run(loader)

    pf = "%20s" + "%11i" * 1 + "%11.3g" * 6
    print(("%20s" + "%11s" * 7) % ("Class", "Images", "P", "R", "mAP@.5",
                                   "mAP@.5:.95", "mIoU", "pixAcc"))
    print(pf % ("all", results["seen"], results["mp"], results["mr"],
                results["map50"], results["map"], results["miou"],
                results["pix_acc"]))
    if verbose:
        for c, m in results["per_class"].items():
            print(f"{names.get(c, c):>20} {m['p']:.3f} {m['r']:.3f} "
                  f"{m['ap50']:.3f} {m['ap']:.3f}")
    sp = results["speed_ms"]
    print(f"Speed: {sp[0]:.1f}ms host-stage, {sp[1]:.1f}ms device "
          f"(fwd+decode+NMS), {sp[2]:.1f}ms metrics per image on "
          f"{_device_name(model)}")
    # COCO-protocol mAP over the exported predictions
    if save_json and save_dir:
        anno = coco_anno or os.path.join(data.get("path", "../coco"),
                                         "annotations",
                                         "instances_val2017.json")
        pred_json = os.path.join(save_dir, "predictions.json")
        if os.path.isfile(anno) and os.path.isfile(pred_json):
            from desenet_tpu_torch.eval.coco import evaluate_coco

            print(f"\nEvaluating COCO mAP on {pred_json}...")
            stats = evaluate_coco(anno, pred_json)
            results["map"], results["map50"] = float(stats[0]), float(stats[1])
        elif coco_anno:
            print(f"COCO eval skipped: {anno} or {pred_json} not found")
    return results


def _device_name(model) -> str:
    dev = next(model.parameters()).device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_speed(cfg, weights, nc, se_nc, batch_size=32, imgsz=640, half=True,
              device="cuda", seg_head_fused=False, reps=8):
    """--task speed: steady-state ms/image of the device step (forward,
    multi-label NMS, seg argmax) on random inputs at the val shape."""
    model, _ = load_model(cfg, weights, nc, se_nc, half, device,
                          seg_head_fused)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand((batch_size, 3, imgsz, imgsz), generator=gen,
                     device=dev).to(next(model.parameters()).dtype)
          for _ in range(reps + 1)]

    @torch.inference_mode()
    def step(x):
        (dec, _), seg = model(x)
        nms = non_max_suppression(dec, 0.001, 0.6, multi_label=True,
                                  pre_topk=PRE_TOPK_VAL)
        return nms.num.sum() + seg.argmax(1).sum()

    step(xs[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = [step(x) for x in xs[1:]]
    torch.stack(outs).cpu()
    dt = (time.perf_counter() - t0) / reps / batch_size * 1e3
    print(f"{dt:.2f} ms/image at batch {batch_size}, {imgsz}px on "
          f"{_device_name(model)}")
    return dt


def parse_opt(argv=None):
    p = argparse.ArgumentParser("desenet_tpu_torch val")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--cfg", type=str, default="yolov5s_seg",
                   help="bundled config name or .json/.yaml path")
    p.add_argument("--weights", type=str, nargs="+", required=True,
                   help="checkpoint dir of the port's training, or a "
                        "torch-named state dict (.npz); more than one runs "
                        "an ensemble with one joint NMS pass")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", "--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--task", type=str, default="val",
                   choices=["val", "test", "train", "speed", "study"])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seg-head-fused", action="store_true",
                   help="run the SegMaskPSP2 head as the fused kernel K4")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--no-half", action="store_true")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--save-dir", type=str, default=None,
                   help="explicit output dir (overrides --project/--name)")
    p.add_argument("--project", type=str, default="runs/val")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--augment", action="store_true",
                   help="test-time augmentation")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-json", action="store_true")
    p.add_argument("--save-hybrid", action="store_true",
                   help="inject GT labels pre-NMS and save hybrid "
                        "label+prediction txt (auto-labelling)")
    p.add_argument("--coco-anno", type=str, default="",
                   help="COCO instances json to re-score --save-json's "
                        "predictions with (default: <data path>/annotations/"
                        "instances_val2017.json)")
    p.add_argument("--int8", action="store_true",
                   help="int8 W8A8 post-training quantization (calibrates "
                        "on train batches; per-channel activation scales "
                        "and bias correction by default)")
    p.add_argument("--int8-no-bias-correct", action="store_true",
                   help="ablation: no weight-quantization bias correction")
    p.add_argument("--int8-mse-clip", action="store_true",
                   help="per-channel MSE-optimal weight clip search instead "
                        "of absmax scales")
    p.add_argument("--int8-fp-hops", type=int, default=1,
                   help="keep this many compute layers upstream of Detect "
                        "full precision under --int8")
    p.add_argument("--int8-weights-only", action="store_true",
                   help="ablation: quantize the weights only (fp "
                        "activations)")
    p.add_argument("--int8-per-tensor", action="store_true",
                   help="ablation: per-tensor activation scales")
    p.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                   default="default",
                   help="highest: full f32 products, TF32 off in cuBLAS and "
                        "cuDNN (use with --no-half for f32 parity)")
    p.add_argument("--act-store", choices=["fp8", "fp8_e5m2"], default=None,
                   help="store block activations in fp8 (eval only; "
                        "compute stays in the model dtype)")
    return p.parse_args(argv)


def main(argv=None):
    o = parse_opt(argv)
    from desenet_tpu_torch.utils.general import (check_dataset,
                                                 increment_path, set_logging,
                                                 set_matmul_precision)

    set_logging()
    set_matmul_precision(o.matmul_precision)
    if o.task in ("speed", "study"):
        data = check_dataset(o.data)
        nc, se_nc = int(data["de"]["nc"]), int(data["se"]["nc"])
        sizes = (o.img_size,) if o.task == "speed" else (256, 384, 512, 640)
        out = {size: run_speed(o.cfg, o.weights[0], nc, se_nc, o.batch_size,
                               size, not o.no_half, o.device,
                               o.seg_head_fused) for size in sizes}
        if o.task == "study":
            print(json.dumps(out))
        return out if o.task == "study" else out[o.img_size]
    if o.save_dir is None:
        o.save_dir = str(increment_path(os.path.join(o.project, o.name),
                                        exist_ok=o.exist_ok, mkdir=True))
    return run(
        o.data, o.weights, o.cfg, o.batch_size, o.img_size, o.conf_thres,
        o.iou_thres, o.task, o.single_cls, o.verbose, not o.no_half,
        o.plots, o.save_dir, o.workers, augment=o.augment,
        save_txt=o.save_txt, save_conf=o.save_conf, save_json=o.save_json,
        save_hybrid=o.save_hybrid, coco_anno=o.coco_anno, int8=o.int8,
        act_store=o.act_store, device=o.device,
        seg_head_fused=o.seg_head_fused,
        int8_bias_correct=not o.int8_no_bias_correct,
        int8_mse_clip=o.int8_mse_clip,
        int8_weights_only=o.int8_weights_only,
        int8_per_channel=not o.int8_per_tensor,
        int8_fp_hops=o.int8_fp_hops)


if __name__ == "__main__":
    main()
