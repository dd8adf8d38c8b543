"""The rate at which the card runs the ``mma.sync`` bf16 tile that kernels K4
and K6 are built on, with nothing else in the way.

    python -m desenet_tpu_torch.tools.mma_peak

Launches ``csrc/mma_peak.cu`` (one block an SM, nothing but m16n8k16
products on registers) at 4, 8, 16 and 32 warps a block and prints the
TFLOP/s each reaches, with the card's name and power limit. The largest is
the ceiling for a kernel built on ``mma.sync``, to hold K4's, K5's and K6's
achieved rates against; the card's published bf16 peak is reached only
through ``wgmma``. Then the same for the special-function unit, whose rate
bounds a SiLU epilogue: ``ex2``, ``rcp`` and ``tanh`` in f32 and ``tanh`` and
``ex2`` in bf16x2 (two values an operation), in operations a clock an SM at
the clock ``nvidia-smi`` reports under load. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess

import torch

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.tools.timing import H100_BF16_FLOPS, card_line, cuda_ms

ITERS = 4096       # loop trips a warp, eight products each
TILE_FLOPS = 2 * 16 * 8 * 16
SFU_OPS = ("ex2.approx.ftz.f32", "rcp.approx.ftz.f32", "tanh.approx.f32",
           "tanh.approx.bf16x2", "ex2.approx.ftz.bf16x2")


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reports right now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mma_peak: no CUDA device")
    lib = _ext.load()
    dev = torch.device("cuda")
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    card = card_line()
    sink = torch.empty(blocks * 1024, dtype=torch.float32, device=dev)
    stream, index = _ext.stream_and_device(sink)
    for threads in (128, 256, 512, 1024):
        def launch():
            _ext.check(lib.desenet_mma_peak(blocks, threads, ITERS,
                                            sink.data_ptr(), stream, index),
                       "mma_peak kernel")

        ms = cuda_ms(launch, 5)
        flops = blocks * (threads // 32) * ITERS * 8 * TILE_FLOPS
        rate = flops / ms * 1e3
        print(f"mma.sync m16n8k16 bf16, {blocks} blocks of {threads // 32} "
              f"warps: {rate / 1e12:.1f} TFLOP/s "
              f"({100 * rate / H100_BF16_FLOPS:.0f}% of the published "
              f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s) [{card}]", flush=True)
    for op, name in enumerate(SFU_OPS):
        def launch():
            _ext.check(lib.desenet_sfu_peak(blocks, 1024, ITERS, op,
                                            sink.data_ptr(), stream, index),
                       "sfu_peak kernel")

        ms = cuda_ms(launch, 5)
        mhz = sm_clock_mhz()  # read right behind the load
        ops = blocks * 1024 * ITERS * 8
        print(f"{name}, {blocks} blocks of 32 warps: {ops / ms / 1e6:.1f} G "
              f"operations/s = {ops / ms / 1e3 / mhz / blocks:.2f} a clock an "
              f"SM at {mhz:.0f} MHz [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
