"""Where the validation device step's time goes, kernel by kernel, with the
module seg head and with the fused one (kernel K4).

    python -m desenet_tpu_torch.tools.profile_val_step      # card, b32/640
    python -m desenet_tpu_torch.tools.profile_val_step --cfg yolov5m_seg
    python -m desenet_tpu_torch.tools.profile_val_step --device cpu \\
        --batch 1 --imgsz 64

``torch.profiler`` over warm calls of ``Validator.eval_step`` (yolov5s_seg
or ``--cfg`` with the FusedFocus stem, as ``cli.val`` builds it, random
weights from seed 0, bf16 on a card, uint8 images in: forward,
multi-label top-16384 candidates, kernel K3, full-resolution seg argmax).
For either head, a table of the device kernels (on the CPU: the host ops)
with milliseconds and calls per step, most time first, their total, and on
a card the step's time by the host's clock beside it: where that is far
above the kernels' total, the host and not the card sets the step's pace.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from desenet_tpu_torch.eval import Validator
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.tools.timing import card_line, kernel_table, show

WALL_REPS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--cfg", default="yolov5s_seg",
                    help="bundled config name or .json/.yaml path")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_val_step: no CUDA device")
    tail = f"[{card_line()}]" if cuda else "(host ops, CPU)"

    model, spec = build_model(config_path(args.cfg), fuse_focus=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev, torch.bfloat16 if cuda else torch.float32,
                     memory_format=torch.channels_last)
    validator = Validator(model, nc=spec.de_nc, se_nc=spec.se_nc)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(
        0, 256, (args.batch, args.imgsz, args.imgsz, 3), dtype=np.uint8)).to(dev)
    tgts = torch.zeros((args.batch, 1, 5), device=dev)
    tmask = torch.zeros((args.batch, 1), dtype=torch.bool, device=dev)

    def step():
        return validator.eval_step(img, tgts, tmask)

    for fused in (False, True):
        model.seg_head_fused = fused
        head = "the fused seg head (K4)" if fused else "the module seg head"
        note = tail
        if cuda:
            step()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(WALL_REPS):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / WALL_REPS * 1e3
            note = f"; {wall:.3f} ms a step by the host's clock {tail}"
        show(f"{args.cfg} val step b{args.batch}/{args.imgsz} with {head}",
             kernel_table(step, dev), note)
    model.seg_head_fused = False
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
