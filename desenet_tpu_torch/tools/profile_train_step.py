"""Where the training step's time goes, kernel by kernel, with the fused
seg loss (``upsampled_ce`` on 1/8 logits) and with the materialized one
(the full-resolution logits through ``segmentation_loss``).

    python -m desenet_tpu_torch.tools.profile_train_step      # card, b64/640
    python -m desenet_tpu_torch.tools.profile_train_step --device cpu \\
        --batch 2 --imgsz 64

``torch.profiler`` over warm steps of ``train.make_train_step`` on
``CFG``, yolov5s_seg at full width and depth (random weights from seed 0, the
recipe's hyperparameters, SGD, bf16 compute under autocast on a card,
synthetic uint8 batches from ``testing.train_batch``): forward, detection
loss, seg loss, one backward, the 3-group update and the EMA. For either
seg loss a table of the device kernels (on the CPU: the host ops) with
milliseconds and calls per step, most time first, their total, and on a
card the step's time by the host's clock and its peak device memory.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.testing import train_batch
from desenet_tpu_torch.tools.timing import card_line, kernel_table, show
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule

CFG = "yolov5s_seg"  # bundled config name or .json/.yaml path
NOMINAL_BS = 64  # the recipe's nbs: at batch 64 every step is an optimizer step
WALL_REPS = 5


def trainer(fused: bool, device, batch: int, imgsz: int,
            dtype: torch.dtype, seed: int = 0, warmup_iters: int = 3):
    """``CFG`` (yolov5s_seg at full width) in training mode on ``device``
    (weights from ``seed``, channels-last), the recipe's loss gains and
    schedule, SGD. Returns ``(state, step, spec)``."""
    model, spec = build_model(config_path(CFG),
                              seg_upsample=not fused, train=True)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(device, memory_format=torch.channels_last)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, imgsz, 300)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=100,
                           warmup_iters=warmup_iters, nominal_bs=NOMINAL_BS,
                           batch_size=batch, fused_seg=fused, dtype=dtype)
    return state, step, spec


def device_batches(n: int, b: int, imgsz: int, nc: int, device,
                   seed: int = 0) -> list:
    """``n`` distinct training batches (``testing.train_batch``), on
    ``device``."""
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in train_batch(rng, b, imgsz, nc).items()}
            for _ in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--imgsz", type=int, default=640)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device")
    tail = f"[{card_line()}]" if cuda else "(host ops, CPU)"
    dtype = torch.bfloat16 if cuda else torch.float32

    for fused in (True, False):
        state, step, spec = trainer(fused, dev, args.batch, args.imgsz, dtype)
        batches = itertools.cycle(device_batches(
            3, args.batch, args.imgsz, spec.de_nc, dev))

        def run():
            nonlocal state
            state, _ = step(state, next(batches))

        what = "fused" if fused else "materialized"
        note = tail
        if cuda:
            run()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(WALL_REPS):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / WALL_REPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            note = (f"; {wall:.3f} ms a step by the host's clock, peak "
                    f"allocated {peak:.3f} GiB {tail}")
        show(f"train step b{args.batch}/{args.imgsz}, {what} seg loss",
             kernel_table(run, dev), note)
        del state, step
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
