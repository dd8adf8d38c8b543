"""Proto's upsample and 3x3 conv on the card: the ways to run them.

    python -m desenet_tpu_torch.tools.profile_proto              # b128, 80x80, 320
    python -m desenet_tpu_torch.tools.profile_proto --batch 2 --hw 16 --c 40

A nearest 2x upsample followed by a 3x3, stride-1, pad-1 conv is one 2x2
conv over the small map, pad 1, with four output phases
(``ops/conv_epilogue.fold_phases``). On a (B, C, H, W) bf16 channels_last
map, random weights from seed 0, this times by CUDA events, in turns:

- ``upsample + 3x3``: ``F.interpolate`` nearest 2x, then cuDNN's 3x3 conv
  at 2H x 2W (the unfolded path);
- ``folded 2x2``: cuDNN's conv of the folded (4C, C, 2, 2) weight, pad 1,
  at (H+1) x (W+1);
- ``four 2x2``: the map padded once, then four (C, C, 2, 2) convs over its
  H x W phase slices;

each with the TFLOP/s of the work it does (the folded conv's wasted row
and column included); then the phase pass (``conv_epilogue_phases``) on
the folded conv's output beside its plain version, its bound
(``timing.epilogue_phases_bound``) and the one-pass epilogue over the
unfolded conv's output; then a fused ``Proto(C, C, 32)`` (seeded BN) on
the map with its phase path and without it, in turns. Last, the device
kernels of each by the profiler. Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from desenet_tpu_torch.models.heads import Proto
from desenet_tpu_torch.ops import conv_epilogue as CE
from desenet_tpu_torch.testing import randomize_bn
from desenet_tpu_torch.tools.timing import (card_line, epilogue_phases_bound,
                                            in_turns, kernel_table, show)

PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (py, px) of phase p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=80)
    ap.add_argument("--c", type=int, default=320)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_proto: no CUDA device")
    dev = torch.device("cuda")
    tail = f"[{card_line()}]"
    b, h, c = args.batch, args.hw, args.c
    g = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last
    x = torch.randn((b, c, h, h), device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=cl)
    w = (torch.randn((c, c, 3, 3), device=dev, generator=g) / (3 * c ** 0.5)
         ).to(torch.bfloat16).contiguous(memory_format=cl)
    k = CE.fold_phases(w).contiguous(memory_format=cl)
    parts = k.view(4, c, c, 2, 2).unbind(0)
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3

    def unfolded():
        return F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w,
                        padding=1)

    def folded():
        return F.conv2d(x, k, padding=1)

    def four():
        xp = F.pad(x, (1, 1, 1, 1))
        return [F.conv2d(xp[:, :, py:py + h + 1, px:px + h + 1], kp)
                for (py, px), kp in zip(PHASES, parts)]

    proto = randomize_bn(Proto(c, c, 32), seed=0).eval().to(
        dev, torch.bfloat16, memory_format=cl)
    with torch.inference_mode():
        want = unfolded().float()
        got = folded().float()
        err = 0.0
        for p, (py, px) in enumerate(PHASES):
            ph = got[:, p * c:(p + 1) * c, py:py + h, px:px + h]
            err = max(err, float((ph - want[:, :, py::2, px::2]).abs().max()))
        big = float(want.abs().max())
        del want, got
        runs = [("upsample + 3x3", unfolded, 2 * b * (2 * h) ** 2 * 9 * c * c),
                ("folded 2x2", folded, 2 * b * (h + 1) ** 2 * 4 * c * 4 * c),
                ("four 2x2", four, 4 * 2 * b * h * h * 4 * c * c)]
        ms = in_turns(*[(fn, 5) for _, fn, _ in runs])
        print(f"Proto's upsample and 3x3 conv, b{b} C {c} at {h}x{h} bf16 "
              f"channels_last (folded against unfolded: max abs err {err:.4g}"
              f" of {big:.4g}) {tail}", flush=True)
        for (name, _, flops), t in zip(runs, ms):
            print(f"  {name:15s} {t:9.3f} ms  {flops / t / 1e9:7.1f} TFLOP/s",
                  flush=True)

        y, z = folded(), unfolded()
        same = torch.equal(CE.conv_epilogue_phases(y, scale, shift),
                           CE.conv_epilogue_phases_plain(y, scale, shift))
        kms, pms, ems = in_turns(
            (lambda: CE.conv_epilogue_phases(y, scale, shift), 10),
            (lambda: CE.conv_epilogue_phases_plain(y, scale, shift), 2),
            (lambda: CE.conv_epilogue(z, scale, shift, True), 10))
        bound, by = epilogue_phases_bound(b, h, h, c)
        print(f"the phase pass on {tuple(y.shape)}: kernel {kms:.4f} ms "
              f"(bit for bit its plain version: {same}), plain {pms:.3f} ms, "
              f"bound {bound:.4f} ms ({by}), {100 * bound / kms:.1f}% of it; "
              f"the one-pass epilogue over the unfolded {tuple(z.shape)} "
              f"{ems:.4f} ms {tail}", flush=True)
        del y, z

        for cv in (proto.cv1, proto.cv2, proto.cv3):
            cv.fuse_epilogue()
        old = proto(x)
        proto.fuse_phases()
        new = proto(x)
        perr = float((new.float() - old.float()).abs().max())
        kept = proto.cv2._derived["phases"]

        def phased():
            proto.cv2._derived["phases"] = kept
            return proto(x)

        def plain():
            proto.cv2._derived.pop("phases", None)
            return proto(x)

        t_new, t_old = in_turns((phased, 5), (plain, 5))
        print(f"Proto({c}, {c}, 32) b{b} at {h}x{h} bf16, fused: phase path "
              f"{t_new:.3f} ms, upsample and 3x3 {t_old:.3f} ms (max abs err "
              f"{perr:.4g} of {float(old.abs().max()):.4g}) {tail}",
              flush=True)
        del old, new
        runs += [("Proto, phase path", phased, 0),
                 ("Proto, upsample and 3x3", plain, 0)]
        for name, fn, _ in runs:
            show(name, kernel_table(fn, dev), tail)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
