"""Kernel K6, the fused C3 block, checked and timed at the four yolov5s
backbone C3 shapes: the port's counterpart of ``tools/proto_c3_kernel.py``.

    python -m desenet_tpu_torch.tools.proto_c3_kernel       # card, b128/640
    python -m desenet_tpu_torch.tools.proto_c3_kernel --device cpu \\
        --batch 2 --imgsz 64

For each shape (P2 to P5, maps of imgsz/4 to imgsz/32) a seeded port ``C3``
module with random BN statistics gives K6 its params through
``utils/fold.fold_c3``. Two parity lines, float32 (TF32 off) and bfloat16:
``c3_fused`` on a (batch, H, W, C) input against ``c3_plain`` and against
the module. Then, on a card, a bfloat16 timing line: K6, its plain version
and the module C3 (cuDNN), in turns, with the card's name and power limit.
A failed check raises, so the exit code is non-zero.

Bars: float32 rtol/atol 1e-4; bfloat16 ``testing.BF16_BAR`` against the
plain version (the same rounding points) and ``testing.BF16_MODULE_BAR``
against the module.
"""

from __future__ import annotations

import argparse
import copy

import torch

from desenet_tpu_torch.models.layers import C3
from desenet_tpu_torch.ops import c3_fused
from desenet_tpu_torch.testing import (BF16_MODULE_BAR, check_close, no_tf32,
                                       randomize_bn)
from desenet_tpu_torch.tools.timing import card_line, in_turns
from desenet_tpu_torch.utils.fold import fold_c3

REPS, PLAIN_REPS = 5, 1  # timed runs per turn
F32_TOL = 1e-4  # rtol and atol in float32 (TF32 off)
# (name, stride, C, n): the proto's yolov5s_seg C3s, C -> C with c_ = C/2
# and the shortcut
SHAPES = (("P2", 4, 64, 1), ("P3", 8, 128, 2), ("P4", 16, 256, 3),
          ("P5", 32, 512, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("proto_c3_kernel: no CUDA device")
    card = card_line() if dev.type == "cuda" else None

    g = torch.Generator(device=dev).manual_seed(0)
    for seed, (name, stride, c, n) in enumerate(SHAPES):
        side = args.imgsz // stride
        torch.manual_seed(seed)
        module = randomize_bn(C3(c, c, n, True).eval(), seed=seed)
        raw = fold_c3(module, (side, side))
        x = torch.randn((args.batch, side, side, c), device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            params = c3_fused.c3_params(raw, dev, dt)
            mod = copy.deepcopy(module).to(dev, dt,
                                           memory_format=torch.channels_last)
            xd = x.to(dt)
            xm = xd.permute(0, 3, 1, 2)  # the NCHW channels_last view
            with torch.inference_mode(), no_tf32():
                got = c3_fused.c3_fused(xd, params, n)
                plain = c3_fused.c3_plain(xd, params, n)
                e_plain = check_close(got, plain, f"K6 {name} vs plain",
                                      F32_TOL)
                e_mod = check_close(got, mod(xm).permute(0, 2, 3, 1),
                                    f"K6 {name} vs the module C3", F32_TOL,
                                    BF16_MODULE_BAR)
            print(f"{name} parity ({args.batch}, {side}, {side}, {c}) -> {c}, "
                  f"c_ {c // 2}, n {n}, shortcut True, {dt}: max abs err vs "
                  f"plain {e_plain:.6g}, vs the module C3 {e_mod:.6g} (|plain| "
                  f"max {float(plain.float().abs().max()):.6g})", flush=True)
            del got, plain
        if card is None:
            continue
        # params, xd, mod and xm are the last loop's: bfloat16
        with torch.inference_mode():
            p, k, m = in_turns(
                (lambda: c3_fused.c3_plain(xd, params, n), PLAIN_REPS),
                (lambda: c3_fused.c3_fused(xd, params, n), REPS),
                (lambda: mod(xm), REPS))
        print(f"{name} timing, bfloat16: kernel {k:.3f} ms, plain {p:.3f} ms, "
              f"module C3 (cuDNN) {m:.3f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
