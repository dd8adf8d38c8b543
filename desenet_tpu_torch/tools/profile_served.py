"""Where the served program's time goes, kernel by kernel.

    python -m desenet_tpu_torch.tools.profile_served       # card, b128/640
    python -m desenet_tpu_torch.tools.profile_served --cfg yolov5l_seg
    python -m desenet_tpu_torch.tools.profile_served --device cpu \\
        --batch 1 --imgsz 64

``torch.profiler`` over ``timing.RUNS`` warm calls of the served device
program (``Predictor.infer``: yolov5s_seg or ``--cfg``, random weights from
seed 0, bf16 on a card, uint8 images in, the FusedFocus stem or with
``--no-fuse-focus`` the Focus one), then over the model's stem alone on
that program's stem input. For each, a table of the device kernels (on
the CPU: the host ops, by self time) with milliseconds and calls per run,
most time first, and their total, with the card's name and power limit.
The port's own kernels on that path (K1, K2) are listed below the table
where they do not reach it.
"""

from __future__ import annotations

import argparse

import torch

from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.tools.timing import card_line, kernel_table, show


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--cfg", default="yolov5s_seg",
                    help="bundled config name or .json/.yaml path")
    ap.add_argument("--no-fuse-focus", action="store_true",
                    help="serve the reference's Focus stem")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_served: no CUDA device")
    tail = f"[{card_line()}]" if dev.type == "cuda" else "(host ops, CPU)"

    model, _ = build_model(config_path(args.cfg))
    sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    pred = Predictor(args.cfg, sd, imgsz=args.imgsz,
                     half=dev.type == "cuda", device=dev,
                     fuse_focus=not args.no_fuse_focus)
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.randint(0, 256, (args.batch, args.imgsz, args.imgsz, 3),
                        dtype=torch.uint8, device=dev, generator=g)
    seen = []
    hook = pred.model.model[0].register_forward_hook(
        lambda m, a, out: seen.append(a[0]))
    try:
        show(f"{args.cfg} served program b{args.batch}/{args.imgsz} "
             f"{pred.dtype}",
             kernel_table(lambda: pred.infer(img), dev), tail)
    finally:
        hook.remove()
    stem, x = pred.model.model[0], seen[-1]
    with torch.inference_mode():
        show(f"its {type(stem).__name__} stem alone on {tuple(x.shape)}",
             kernel_table(lambda: stem(x), dev), tail)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
