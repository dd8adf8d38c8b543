"""Standalone segmentation mIoU CLI on the port: run the model over a split
and print running pixAcc, per-class IoU and mIoU.

    python -m desenet_tpu_torch.cli.show_seg_miou --data data.yaml \\
        --cfg yolov5s_seg --weights sd.npz --img-size 640
"""

from __future__ import annotations

import argparse

from desenet_tpu_torch.cli.val import load_model
from desenet_tpu_torch.eval.validator import seg_metrics


def run(data, weights, cfg="yolov5s_seg", batch_size=16, imgsz=640,
        task="val", half=True, workers=8, device="cuda",
        seg_head_fused=False):
    from desenet_tpu_torch.data import create_mixed_dataloader
    from desenet_tpu_torch.utils.general import (check_dataset,
                                                 check_img_size)

    data = check_dataset(data)
    se_nc = int(data["se"]["nc"])
    model, spec = load_model(cfg, weights, int(data["de"]["nc"]), se_nc,
                             half, device, seg_head_fused)
    imgsz = check_img_size(imgsz, s=max(spec.det_strides))
    se_names = list(data["se"]["names"])
    loader, _ = create_mixed_dataloader(
        data[task], img_size=imgsz, batch_size=batch_size, augment=False,
        rect=True, pad=0.5, stride=max(spec.det_strides), workers=workers)

    m = seg_metrics(model, se_nc, loader, on_batch=lambda m: print(
        f"pixAcc: {m.pix_acc:.3f}, mIoU: {m.miou:.3f}", end="\r"))
    print()
    for i, iou in enumerate(m.ious, start=1):
        name = se_names[i] if i < len(se_names) else str(i)
        print(f"  IoU[{name}] = {iou:.4f}")
    print(f"pixAcc = {m.pix_acc:.4f}  mIoU = {m.miou:.4f}")
    return m.miou


def main(argv=None):
    from desenet_tpu_torch.utils.general import set_logging

    set_logging()
    p = argparse.ArgumentParser("desenet_tpu_torch show_seg_miou")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--cfg", type=str, default="yolov5s_seg")
    p.add_argument("--weights", type=str, required=True,
                   help="torch-named state dict (.npz)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", "--imgsz", type=int, default=640)
    p.add_argument("--task", type=str, default="val")
    p.add_argument("--no-half", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seg-head-fused", action="store_true")
    o = p.parse_args(argv)
    return run(o.data, o.weights, o.cfg, o.batch_size, o.img_size, o.task,
               not o.no_half, o.workers, o.device, o.seg_head_fused)


if __name__ == "__main__":
    main()
