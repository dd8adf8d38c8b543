"""Where kernel K4's time goes, kernel by kernel.

    python -m desenet_tpu_torch.tools.profile_seg_head       # card, b32
    python -m desenet_tpu_torch.tools.profile_seg_head --device cpu \\
        --batch 1 --side 16

``torch.profiler`` over ``timing.RUNS`` warm calls of
``fused_psp2_eval`` (a seeded random SegMaskPSP2 head at yolov5s_seg's
widths, c_hid 128, on seeded inputs of ``side`` x ``side`` positions at 1/8
resolution; bf16 on a card), then of the module head (cuDNN) on the same
inputs: for each a table of the device kernels (on the CPU: the host ops)
with milliseconds and calls per run, most time first, and their total, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from desenet_tpu_torch.ops import seg_head_pallas
from desenet_tpu_torch.testing import psp2_inputs, random_psp2_head
from desenet_tpu_torch.tools.timing import card_line, kernel_table, show

C_HID = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--side", type=int, default=80)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_seg_head: no CUDA device")
    cuda = dev.type == "cuda"
    tail = f"[{card_line()}]" if cuda else "(host ops, CPU)"
    dt = torch.bfloat16 if cuda else torch.float32

    chans = (2 * C_HID, 2 * C_HID, 4 * C_HID)
    head = random_psp2_head(chans, C_HID).to(dev, dt)
    xs = [x.to(dev, dt) for x in psp2_inputs(args.batch, args.side, args.side,
                                             chans)]
    nchw = [x.permute(0, 3, 1, 2) for x in xs]  # channels_last views
    what = f"({args.batch}, {args.side}, {args.side}) c_hid {C_HID} {dt}"
    with torch.inference_mode():
        show(f"fused_psp2_eval {what}", kernel_table(
            lambda: seg_head_pallas.fused_psp2_eval(xs, head, 3), dev), tail)
        show(f"the module head {what}",
             kernel_table(lambda: head(nchw), dev), tail)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
