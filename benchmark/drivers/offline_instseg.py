"""Offline instance segmentation: one caller in a closed loop over
``Predictor.run_batch`` of a ``Segment`` model (YOLOv5 v7.0), host numpy
in and host numpy out: boxes, scores, classes, counts, each kept box's
mask bits at the prototypes' resolution, and the boxes' anchors.

The loop, window, sampling and traced stretch are ``offline_batch.py``'s
(its docstring gives the traffic parameters); what differs is the model's
outputs and their judge (``reference/instseg.py``: ``det_gap`` and
``mask_gap``), its weights (``harness/weights_v7seg.py``), its FLOP
count and the mask assembly's bound (``counts/v7seg.py``).

End-to-end: ``serve_img_s``, images over the window's seconds (the last
call ends the window); ``setup_s``, process start to the window's start.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.counts.v7seg import forward_flops
from benchmark.harness.frames import letterbox_rgb, make_frames
from benchmark.harness.trace import Stretch
from benchmark.harness.weights_v7seg import seeded_weights
from benchmark.reference.instseg import judge_batches
from benchmark.reference.v7seg import segment_row


def run(ctx: dict) -> dict:
    from torch.profiler import record_function

    from desenet_tpu_torch.api import Predictor

    tp = ctx["workload"]["params"]
    conf, dev, seed = ctx["config"], ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, n_pool, (fh, fw) = tp["batch"], tp["pool"], tp["frame_hw"]
    size = conf["imgsz"]

    sd = seeded_weights(conf, seed, dev)
    pred = Predictor(conf["model"], sd, imgsz=size,
                     half=conf["dtype"] == "bfloat16", device=dev)
    frames = make_frames(b * n_pool, fh, fw, seed + 2, dev).cpu().numpy()
    pool = [letterbox_rgb(frames[i * b:(i + 1) * b], size)
            for i in range(n_pool)]
    del frames
    t = time.perf_counter()
    pred.run_batch(pool[0])
    first_call_s = time.perf_counter() - t
    for j in range(1, tp["warmup"]):
        pred.run_batch(pool[j % n_pool])
    stretch = Stretch(ctx["trace"], dev)
    stretch.prime()
    sync()
    if cuda:  # the window's peak, not set-up's
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = t_window - ctx["t_start"]

    rng = np.random.default_rng(seed)
    sample = set(rng.choice(tp["sample_from"], tp["sample"], replace=False)
                 .tolist())
    trace_calls = set()
    if ctx["trace"]:
        trace_calls = set(range(tp["trace_at"],
                                tp["trace_at"] + tp["trace_calls"]))
    kept, i = {}, 0
    while True:
        if i == tp["trace_at"]:
            stretch.start()
        with record_function("bench.run_batch"):
            out = pred.run_batch(pool[i % n_pool])
        if i in trace_calls and i + 1 not in trace_calls:
            stretch.stop()
        if i in sample or i in trace_calls:
            kept[i] = out
        i += 1
        if (time.perf_counter() - t_window >= ctx["seconds"]
                and i > max(trace_calls, default=-1)
                and i >= tp["sample_from"]):
            break
    elapsed = time.perf_counter() - t_window
    kept[i - 1] = out
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    spec = (pred.conf_thres, pred.iou_thres, pred.max_det)
    del pred, out
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks, counts = judge_batches(
        conf, sd, {k: pool[k % n_pool] for k in kept}, kept, dev, *spec)
    ref_s = time.perf_counter() - t
    records = stretch.records()
    if records:
        traced = sorted(trace_calls)
        cands = [c for k in traced for c in counts[k]["candidates"]]
        picks = [c for k in traced for c in counts[k]["kept"]]
        seg = segment_row(conf["model"])
        records.update(
            calls=len(traced), units=len(traced) * b,
            flops_per_unit=forward_flops(conf["model"], size, size),
            k1_work={"b": b, "a": counts[traced[0]]["anchors"],
                     "max_det": spec[2],
                     "candidates": float(np.mean(cands)),
                     "picks": float(np.mean(picks))},
            mask_work={"b": b, "hp": size // 4, "wp": size // 4,
                       "nm": seg["nm"], "max_det": spec[2],
                       "kept": float(np.mean([counts[k]["served"]
                                              for k in traced])),
                       "crop_px": float(np.mean([counts[k]["crop_px"]
                                                 for k in traced])),
                       "itemsize": 2 if conf["dtype"] == "bfloat16" else 4})
    cand = [c for k in kept for c in counts[k]["candidates"]]
    return {
        "e2e": {"serve_img_s": i * b / elapsed, "setup_s": setup_s},
        "attempted": i * b, "failed": 0,
        "checks": checks, "records": records, "memory_peak_bytes": peak,
        "notes": {"first_call_s": first_call_s, "window_calls": i,
                  "window_s": elapsed, "reference_s": ref_s,
                  "compared_images": len(kept) * b,
                  "candidates_per_image_median": float(np.median(cand)),
                  "candidates_per_image_max": int(max(cand)),
                  "served_per_image_mean": float(np.mean(
                      [counts[k]["served"] / b for k in kept]))},
    }
