"""Where kernel K6's tensor-core variant spends a block's time, phase by
phase, at yolov5s_seg's eight C3 rows.

    python -m desenet_tpu_torch.tools.profile_c3_phases     # card, b128

Builds the kernels with ``-DK6_PROF`` (a build of its own, beside the normal
one), so that thread 0 of block (0, 0) of ``c3_mma_kernel`` adds up the
clock cycles of each phase of its stages. One line per row: the kernel's
time (CUDA events; the counters cost a little) and the block's cycles in a
pass's set-up and first loads, waiting for weight chunks (barrier and next
load included), the mma.sync products, the barrier that ends a pass, and
the epilogues (bias, SiLU, rounding, store), with the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from desenet_tpu_torch.ops import _ext, c3_fused
from desenet_tpu_torch.testing import C3_SERVED, random_c3_params
from desenet_tpu_torch.tools.timing import card_line, cuda_ms

PHASES = ("set-up", "wait", "mma", "pass barrier", "epilogue")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_c3_phases: no CUDA device")
    _ext.NVCC_FLAGS = _ext.NVCC_FLAGS + ("-DK6_PROF=1",)
    lib = _ext.load()
    dev = torch.device("cuda")
    card = card_line()
    rng = np.random.default_rng(0)
    for row, c, c2, c_, n, sc, side in C3_SERVED:
        params = c3_fused.c3_params(
            random_c3_params(np.random.default_rng(row), c, c_, c2, n), dev)
        x = torch.from_numpy(rng.normal(size=(args.batch, side, side, c))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        ms = cuda_ms(lambda: c3_fused.c3_fused(x, params, n, sc), 3)
        _ext.check(lib.desenet_c3_prof(None, 1), "reset the phase counters")
        c3_fused.c3_fused(x, params, n, sc)
        cycles = (ctypes.c_longlong * len(PHASES))()
        _ext.check(lib.desenet_c3_prof(cycles, 0), "read the phase counters")
        total = sum(cycles)
        split = ", ".join(f"{name} {v} ({100 * v / total:.0f}%)"
                          for name, v in zip(PHASES, cycles))
        print(f"row {row} tile {c3_fused.pick_tile(side, side, c, c_, c2, n)} "
              f"{c3_fused.last_variant}: {ms:.3f} ms; block (0, 0) cycles: "
              f"{split} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
