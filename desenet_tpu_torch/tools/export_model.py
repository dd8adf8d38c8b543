"""Serving export of the port: the whole inference program as a
``torch.export`` artifact with the checkpoint's weights baked in.

    python -m desenet_tpu_torch.tools.export_model runs/train/exp/best \\
        model.pt2 [--batch 1] [--img-size 640] [--fp32] [--device cuda]

Counterpart of ``tools/export_model.py`` (the JAX package's StableHLO
export). The program (``ServingProgram``): a uint8 NHWC batch in, widened to
the compute dtype and scaled to [0, 1] inside; the forward of the model
built with full-resolution seg logits (``seg_upsample=True``, the
checkpoint's EMA weights); the Detect decode; fixed-shape single-label NMS
at ``pre_topk=1024`` with ``backend="xla"`` (plain PyTorch ops: the CUDA
kernels K1 to K3 are ctypes launches that cannot be traced, and would tie
the artifact to one card's build, as a Pallas kernel would tie the JAX
artifact to one TPU); the seg logits' argmax to uint8. Outputs: boxes
(B, max_det, 4) xyxy in letterboxed pixels, scores, classes, num_valid,
seg_mask (B, H, W) uint8.

``torch.export.export`` traces it (the NMS's ``max_det`` rounds as one
``while_loop``) and ``torch.export.save`` writes it; ``<out>.json`` beside
it holds the I/O contract (``meta``, ``batch``, ``img_size``,
``outputs``, ``device`` and the compute ``dtype``).
``tools/consume_exported_model.py`` runs an artifact with nothing but
torch and numpy. ``--device`` is where the program is traced and its
weights live (``cuda`` by default; without a card it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch import nn

OUTPUTS = ["boxes(B,max_det,4) xyxy letterboxed px", "scores", "classes",
           "num_valid", "seg_mask(B,H,W) uint8"]


class ServingProgram(nn.Module):
    """uint8 NHWC images -> (boxes, scores, classes, num, seg_mask) of the
    eval ``model`` (full-resolution seg logits) in ``dtype``."""

    def __init__(self, model: nn.Module, dtype: torch.dtype,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det

    def forward(self, img_u8: torch.Tensor):
        from desenet_tpu_torch.ops.nms import non_max_suppression

        x = img_u8.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        (dec, _), seg = self.model(x)
        nms = non_max_suppression(
            dec, conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det, pre_topk=1024, backend="xla")
        seg_cls = seg.argmax(1).to(torch.uint8)
        return nms.boxes, nms.scores, nms.classes, nms.num, seg_cls


def load_program(weights_dir: str, dtype: torch.dtype, device,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300):
    """(``ServingProgram`` in eval mode on ``device``, checkpoint meta) of
    the port checkpoint directory ``weights_dir`` (its EMA weights)."""
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.utils.checkpoint import load_inference_variables
    from desenet_tpu_torch.utils.convert import load_state_dict

    sd, meta = load_inference_variables(weights_dir)
    if meta is None:
        raise ValueError(f"{weights_dir}: checkpoint has no meta.json")
    model, _ = build_model(config_path(meta["cfg"]), nc=meta["de_nc"],
                           se_nc=meta["se_nc"], anchors=meta.get("anchors"),
                           seg_upsample=True)
    load_state_dict(model, sd)
    model.to(device, dtype)
    prog = ServingProgram(model, dtype, conf_thres, iou_thres, max_det)
    return prog.eval(), meta


def export(prog: ServingProgram, batch: int, img_size: int, device):
    """``torch.export`` of ``prog`` on a (batch, img_size, img_size, 3)
    uint8 input on ``device``."""
    x = torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8,
                    device=device)
    with torch.no_grad():
        return torch.export.export(prog, (x,))


def main(argv=None) -> dict:
    from desenet_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir")
    ap.add_argument("out_path")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--fp32", action="store_true",
                   help="f32 compute (default bf16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the program is "
                         "traced and its weights live")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    prog, meta = load_program(args.weights_dir, dtype, device,
                              args.conf_thres, args.iou_thres, args.max_det)
    t = time.perf_counter()
    ep = export(prog, args.batch, args.img_size, device)
    torch.export.save(ep, args.out_path)
    seconds = time.perf_counter() - t
    with open(args.out_path + ".json", "w") as f:
        json.dump({"meta": meta, "batch": args.batch,
                   "img_size": args.img_size, "outputs": OUTPUTS,
                   "device": str(device),
                   "dtype": str(dtype).replace("torch.", "")}, f, indent=1)
    size = os.path.getsize(args.out_path)
    print(f"exported {size / 1e6:.1f} MB -> {args.out_path} (device "
          f"{device}, {dtype}, {seconds:.1f} s)")
    return {"seconds": seconds, "bytes": size, "device": str(device)}


if __name__ == "__main__":
    main()
