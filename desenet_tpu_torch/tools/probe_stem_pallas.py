"""Kernel K5, the FusedFocus stem conv, checked and timed: the port's
counterpart of ``tools/probe_stem_pallas.py``.

    python -m desenet_tpu_torch.tools.probe_stem_pallas     # card, b128/640
    python -m desenet_tpu_torch.tools.probe_stem_pallas --device cpu \\
        --batch 2 --imgsz 64

A seeded port ``Focus(3, 32, 3)`` with random BN statistics gives K5 its
weights through ``utils/fold.fold_focus``. Four parity lines, in float32
(TF32 off) and bfloat16: a (2, 64, 64, 3) image and a (4, imgsz, imgsz, 3)
batch through ``stem_conv`` against its plain version, the plain conv
(``stem_conv_reference``) and the Focus module. Then, on a card, one timing
line at ``--batch`` bfloat16 images of ``--imgsz``: K5, its plain version
and the module Focus (slice-concat and cuDNN conv), in turns, with the
card's name and power limit. A failed check raises, so the exit code is
non-zero.

Bars: float32 rtol/atol 1e-5 against all three, as
``tests/test_stem_pallas.py`` holds the TPU kernel; bfloat16
``testing.BF16_BAR`` against the plain version and the plain conv (the same
single rounding; the tensor-core kernel's SiLU goes through
``tanh.approx.f32``) and ``testing.BF16_MODULE_BAR`` against the module,
which rounds after its conv, BN and SiLU. float32 takes the CUDA-core
kernel, bfloat16 the tensor-core one; the probe checks which ran.
"""

from __future__ import annotations

import argparse
import copy

import torch

from desenet_tpu_torch.models.layers import Focus
from desenet_tpu_torch.ops import stem_pallas
from desenet_tpu_torch.testing import (BF16_BAR, BF16_MODULE_BAR,
                                       check_close, no_tf32, randomize_bn)
from desenet_tpu_torch.tools.timing import card_line, in_turns
from desenet_tpu_torch.utils.fold import fold_focus

CO = 32  # yolov5s's stem width
REPS, PLAIN_REPS = 10, 2  # timed runs per turn
F32_TOL = 1e-5  # rtol and atol in float32 (TF32 off)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_stem_pallas: no CUDA device")

    torch.manual_seed(0)
    focus = randomize_bn(Focus(3, CO, 3).eval(), seed=1)
    w6, bias = fold_focus(focus, (args.imgsz, args.imgsz))
    b = torch.from_numpy(bias).to(dev)
    x = torch.rand((4, args.imgsz, args.imgsz, 3),
                   generator=torch.Generator().manual_seed(2))
    # made outside inference mode, so that stem_conv can tell they have not
    # changed and keeps their kernel layout between calls
    wms = {dt: stem_pallas.stem_weight_matrix(w6, dt).to(dev)
           for dt in (torch.float32, torch.bfloat16)}
    with torch.inference_mode(), no_tf32():
        for dt, wm in wms.items():
            mod = copy.deepcopy(focus).to(dev, dt,
                                          memory_format=torch.channels_last)
            for xs in (x[:2, :64, :64], x):
                xs = xs.to(dev, dt).contiguous()
                got = stem_pallas.stem_conv(xs, wm, b)
                if dev.type == "cuda" and stem_pallas.last_variant != \
                        stem_pallas.pick_variant(dt):
                    raise AssertionError(f"K5 {dt} took the "
                                         f"{stem_pallas.last_variant} kernel")
                plain = stem_pallas.stem_conv_plain(xs, wm, b)
                wants = {
                    "plain": (plain, BF16_BAR),
                    "the plain conv": (stem_pallas.stem_conv_reference(
                        xs, w6, bias), BF16_BAR),
                    "the module Focus": (mod(xs.permute(0, 3, 1, 2)).permute(
                        0, 2, 3, 1), BF16_MODULE_BAR)}
                errs = [check_close(got, want, f"K5 vs {what}", F32_TOL, bar)
                        for what, (want, bar) in wants.items()]
                print(f"parity {tuple(xs.shape)} {dt} CO {CO}: max abs err "
                      f"vs plain {errs[0]:.6g}, vs the plain conv "
                      f"{errs[1]:.6g}, vs the module Focus {errs[2]:.6g} "
                      f"(|plain| max {float(plain.float().abs().max()):.6g})",
                      flush=True)
        if dev.type != "cuda":
            return 0
        g = torch.Generator(device=dev).manual_seed(0)
        xt = torch.rand((args.batch, args.imgsz, args.imgsz, 3), device=dev,
                        generator=g).to(torch.bfloat16)
        xm = xt.permute(0, 3, 1, 2)  # the NCHW channels_last view
        # wm and mod are the last loop's: bfloat16
        p, k, m = in_turns(
            (lambda: stem_pallas.stem_conv_plain(xt, wm, b), PLAIN_REPS),
            (lambda: stem_pallas.stem_conv(xt, wm, b), REPS),
            (lambda: mod(xm), REPS))
    print(f"timing ({args.batch}, {args.imgsz}, {args.imgsz}, 3) bfloat16 "
          f"CO {CO}: kernel {k:.3f} ms, plain {p:.3f} ms, module Focus "
          f"(cuDNN) {m:.3f} ms [{card_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
