"""Where kernel K5's tensor-core variant spends its time, at the b128/640
stem of yolov5s_seg.

    python -m desenet_tpu_torch.tools.profile_stem_phases     # card, b128

Builds the kernels with ``-DK5_PROF`` (a build of its own, beside the normal
one), in which ``stem_mma_kernel`` reads a mask of parts to leave out: the
window loads (cp.async), the A loads and products, the SiLU, the stores.
Prints the kernel's time (CUDA events) with everything on, with each part
off alone, and with only one part on; then, with everything on, no SiLU;
then the CUDA-core kernel on the same input. Every line carries the card's name and power
limit. What a part costs where the others hide it is the difference to the
full kernel; what it costs alone is the last group. Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from desenet_tpu_torch.ops import _ext, stem_pallas
from desenet_tpu_torch.testing import stem_inputs
from desenet_tpu_torch.tools.timing import card_line, cuda_ms, stem_bound

PARTS = {"window loads": 1, "A loads and products": 2, "SiLU": 4, "stores": 8}
REPS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--co", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stem_phases: no CUDA device")
    _ext.NVCC_FLAGS = _ext.NVCC_FLAGS + ("-DK5_PROF=1",)
    lib = _ext.load()
    dev = torch.device("cuda")
    card = card_line()
    _, w6, bias = stem_inputs(1, 2, 2, args.co)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((args.batch, args.imgsz, args.imgsz, 3), device=dev,
                   generator=g).to(torch.bfloat16)
    wm = stem_pallas.stem_weight_matrix(w6, torch.bfloat16).to(dev)
    b = torch.from_numpy(bias).to(dev)
    shape = f"({args.batch}, {args.imgsz}, {args.imgsz}, 3) -> {args.co} bf16"

    def timed(skip: int, silu: bool = True) -> float:
        torch.cuda.synchronize()
        _ext.check(lib.desenet_stem_prof(skip), "set the parts to skip")
        return cuda_ms(lambda: stem_pallas.stem_conv(x, wm, b, silu=silu),
                       REPS)

    # a launch is queued in far less than the kernel runs, or the times
    # below would be the host's
    host = cuda_ms(lambda: stem_pallas.stem_conv(x[:1, :32, :32], wm, b), 50)
    print(f"K5 on a (1, 32, 32, 3) image (the wrapper and an empty card): "
          f"{host:.3f} ms a call", flush=True)

    bound = stem_bound(args.batch, args.imgsz, args.imgsz, args.co)
    full = timed(0)
    print(f"K5 {shape}: {full:.3f} ms with every part on; bound {bound[0]:.4f} ms ({bound[1]}) [{card}]",
          flush=True)
    everything = sum(PARTS.values())
    print(f"  nothing on (tile loop, barriers, bias): "
          f"{timed(everything):.3f} ms", flush=True)
    for name, bit in PARTS.items():
        off, alone = timed(bit), timed(everything & ~bit)
        print(f"  {name}: {off:.3f} ms without it ({full - off:+.3f} ms "
              f"exposed), {alone:.3f} ms with only it on [{card}]", flush=True)
    print(f"  no SiLU: {timed(0, silu=False):.3f} ms [{card}]", flush=True)
    xf = x[: max(1, args.batch // 4)].float()
    ms = cuda_ms(lambda: stem_pallas.stem_conv(xf, wm, b), 3)
    print(f"  the CUDA-core kernel, float32, batch {xf.shape[0]}: {ms:.3f} ms "
          f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
