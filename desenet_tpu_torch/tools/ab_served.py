"""The served path's two kernels and the served program, on two trees of
this package side by side on one card.

    python -m desenet_tpu_torch.tools.ab_served --against other/checkout

Two checkouts cannot share a process (both are ``desenet_tpu_torch``), so
each measurement is a process of its own with the tree it measures first on
its path; they run in turns (other, this, this, other) within the one
call, on one card and one host, and each builds its own kernels. Every
process gets the same inputs, made here with numpy from seeds and handed
over as a file: a sparse decode (about 250 candidates an image) and a dense
one (3000 candidates around 100 objects) for K1, (B, 80, 80, 3) bf16 logits
for K2, uint8 images for the whole device program of ``Predictor``
(yolov5s_seg, random weights from seed 0, bf16, 640 px). It uses only what
both trees have: ``nms_planes``, ``greedy_select``, ``upsample_argmax``,
``Predictor.infer``. Each kernel is timed twice: by CUDA events over 20
back-to-back calls of its wrapper (at a few hundredths of a millisecond
that follows the host: the allocations and the launch) and by
``torch.profiler`` as device time per call (``*_dev_ms``). One line per
process, then the means per tree.

``--quant`` times the quantized programs instead, on the same weights: the
int8 ``Predictor``'s device program (calibrated on 2 seeded images) at
b128, and the b32 val step (``Validator.eval_step``: forward, K3, seg
argmax) of the int8 model (``quantize_for_inference``, calibrated on a
seeded batch of 8), the fp8-storage model and the bf16 one, the three in
turns.

    python -m desenet_tpu_torch.tools.ab_served --against other/checkout --quant
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

BATCH = 128      # the served batch: both kernels' shapes follow from it
IMGSZ = 640      # and from this: 25200 anchors, (B, 80, 80, 3) logits
ANCHORS = 25200
METRICS = ("k1_sparse_ms", "k1_sparse_dev_ms", "k1_dense_ms",
           "k1_dense_dev_ms", "k2_ms", "k2_dev_ms", "program_ms")
VAL_BATCH = 32   # the val step's batch under --quant
QUANT_METRICS = ("int8_program_ms", "val_int8_ms", "val_fp8_ms",
                 "val_bf16_ms")


def make_inputs(path: str) -> None:
    from desenet_tpu_torch.testing import dense_decode, synthetic_decode

    np.savez(path,
             sparse=synthetic_decode(np.random.default_rng(1), BATCH, ANCHORS,
                                     6, 0.01),
             dense=dense_decode(np.random.default_rng(2), BATCH, ANCHORS, 6,
                                3000, 100),
             logits=np.random.default_rng(1).normal(
                 0, 1, (BATCH, 80, 80, 3)).astype(np.float32))


def worker(inputs: str, quant: bool = False) -> dict:
    """Time the tree that is first on ``sys.path``; needs a card."""
    import torch

    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.ops import nms_fused, seg_pallas
    from desenet_tpu_torch.tools.profile_served import kernel_table
    from desenet_tpu_torch.tools.timing import card_line, cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("ab_served: no CUDA device")
    dev = torch.device("cuda")
    data = np.load(inputs)
    out = {"tree": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(nms_fused.__file__)))), "card": card_line()}
    model, _ = build_model(config_path("yolov5s_seg"))
    sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3),
                      dtype=torch.uint8, device=dev, generator=g)
    if quant:
        return quant_worker(out, sd, x)
    for name in ("sparse", "dense"):
        planes = nms_fused.nms_planes(torch.from_numpy(data[name]).to(dev),
                                      0.25)
        rows = nms_fused.greedy_select(*planes, 300, 0.45)
        out[f"k1_{name}_picks"] = float((rows[..., 4] > 0).sum(1).float()
                                        .mean())
        out[f"k1_{name}_ms"] = cuda_ms(
            lambda: nms_fused.greedy_select(*planes, 300, 0.45), 20)
        out[f"k1_{name}_dev_ms"] = sum(ms for _, ms, _ in kernel_table(
            lambda: nms_fused.greedy_select(*planes, 300, 0.45), dev))
    logits = torch.from_numpy(data["logits"]).to(dev, torch.bfloat16)
    out["k2_ms"] = cuda_ms(lambda: seg_pallas.upsample_argmax(logits, 8, True),
                           20)
    out["k2_dev_ms"] = sum(ms for _, ms, _ in kernel_table(
        lambda: seg_pallas.upsample_argmax(logits, 8, True), dev))
    pred = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda")
    for _ in range(2):
        pred.infer(x)
    out["program_ms"] = cuda_ms(lambda: pred.infer(x), 10)
    return out


def quant_worker(out: dict, sd: dict, x) -> dict:
    """``--quant``: the int8 served program and the three val steps."""
    import torch

    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.quant import quantize_for_inference
    from desenet_tpu_torch.tools.timing import cuda_ms, in_turns
    from desenet_tpu_torch.utils.convert import load_state_dict

    dev = x.device
    rng = np.random.default_rng(12)
    calib = [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
             for _ in range(2)]
    pq = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda",
                   int8=True, calib=calib)
    out["int8_program_ms"] = cuda_ms(lambda: pq.infer(x), 10)
    del pq
    cal = torch.from_numpy(rng.integers(0, 256, (8, 3, IMGSZ, IMGSZ))
                           .astype(np.float32) / 255.0)
    cfg = config_path("yolov5s_seg")
    models = {"int8": quantize_for_inference(
        cfg, sd, [cal], device=dev, compute_dtype=torch.bfloat16)[0]}
    for name, kw in (("fp8", {"act_store": "fp8"}), ("bf16", {})):
        m, _ = build_model(cfg, fuse_focus=True, **kw)  # as cli.val's
        load_state_dict(m, sd)
        models[name] = m.to(dev, torch.bfloat16,
                            memory_format=torch.channels_last)
    img = x[:VAL_BATCH]
    tg = torch.zeros((VAL_BATCH, 16, 5), device=dev)
    tmask = torch.zeros((VAL_BATCH, 16), dtype=torch.bool, device=dev)
    steps = [(lambda v=Validator(m, nc=m.spec.de_nc, se_nc=m.spec.se_nc):
              v.eval_step(img, tg, tmask), 5) for m in models.values()]
    for name, ms in zip(models, in_turns(*steps)):
        out[f"val_{name}_ms"] = ms
    return out


def summarise(runs: list, metrics=METRICS) -> dict:
    """Mean of every metric per tree over its runs."""
    trees = {}
    for r in runs:
        trees.setdefault(r["tree"], []).append(r)
    return {tree: {m: sum(r[m] for r in rs) / len(rs) for m in metrics}
            for tree, rs in trees.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of the other checkout")
    ap.add_argument("--quant", action="store_true",
                    help="time the int8 and fp8 programs instead")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.quant)), flush=True)
        return 0
    if not args.against or not os.path.isdir(
            os.path.join(args.against, "desenet_tpu_torch")):
        raise SystemExit("ab_served: --against needs the root of a checkout "
                         "that holds desenet_tpu_torch/")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(args.against)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        make_inputs(inputs)
        for tree in (other, here, here, other):
            env = dict(os.environ, PYTHONPATH=tree)
            # this file by path: its own directory, not a tree, heads sys.path
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 inputs] + (["--quant"] if args.quant else []),
                cwd=tree, env=env, capture_output=True, text=True,
                timeout=1200)
            if proc.returncode != 0:
                raise SystemExit(f"ab_served: the run on {tree} failed:\n"
                                 f"{proc.stdout}{proc.stderr}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    for tree, means in summarise(
            runs, QUANT_METRICS if args.quant else METRICS).items():
        name = "this tree" if tree == here else "the other tree"
        if args.quant:
            print(f"{name} ({tree}), mean of 2 runs: int8 served program "
                  f"b{BATCH}/{IMGSZ} {means['int8_program_ms']:.3f} ms; val "
                  f"step b{VAL_BATCH}/{IMGSZ} int8 "
                  f"{means['val_int8_ms']:.3f}, fp8 {means['val_fp8_ms']:.3f}"
                  f", bf16 {means['val_bf16_ms']:.3f} ms [{runs[0]['card']}]")
            continue
        print(f"{name} ({tree}), mean of 2 runs, b{BATCH}/{IMGSZ} "
              f"bf16, by events (device time by the profiler): K1 sparse "
              f"{means['k1_sparse_ms']:.4f} ({means['k1_sparse_dev_ms']:.4f}) "
              f"ms, K1 dense {means['k1_dense_ms']:.4f} "
              f"({means['k1_dense_dev_ms']:.4f}) ms, K2 {means['k2_ms']:.4f} "
              f"({means['k2_dev_ms']:.4f}) ms, served program "
              f"{means['program_ms']:.3f} ms [{runs[0]['card']}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
