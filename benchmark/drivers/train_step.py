"""Training: the joint train step as the program's engine builds it
(``train/engine.py``: ``loss_and_schedule(load_hyp())``,
``create_train_state``, ``make_train_step(fused_seg=True)`` in the
config's dtype), driven by one caller over batches made on the device.

Traffic parameters (the workload file's ``params``): ``batch`` images of
the config's size, ``pool`` distinct batches cycled, ``max_targets`` boxes
an image at most, ``checked`` first steps (on distinct batches) that the
reference follows, ``nb`` batches an epoch and ``epochs`` for the schedule
(the warmup is ``max(round(3 * nb), 1000)`` steps, as the engine's), and
``hyp``: the recipe's numbers for the reference (a frozen copy of the
engine's defaults; the program takes its own).

Set-up builds one step and its state, takes the ``checked`` steps (which
warm every shape), records their losses, the first gradient (the momentum
buffer after the first step) and every weight's change after the last,
and hands the same step and state to the window. End-to-end:
``train_img_s``, images over the window's seconds (the window ends when
its last step has finished on the card); ``setup_s``.
"""

from __future__ import annotations

import time

import torch

from benchmark.counts.flops import train_flops
from benchmark.harness.trace import Stretch
from benchmark.harness.train_batches import make_batch
from benchmark.harness.weights import seeded_weights
from benchmark.reference import train as R


def run(ctx: dict) -> dict:
    from torch.profiler import record_function

    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.train import create_train_state, make_train_step
    from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
    from desenet_tpu_torch.utils.convert import load_state_dict

    tp = ctx["workload"]["params"]
    conf, dev, seed = ctx["config"], ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size, b = conf["imgsz"], tp["batch"]
    dtype = torch.bfloat16 if conf["dtype"] == "bfloat16" else torch.float32

    sd = seeded_weights(conf, seed, dev)
    model, spec = build_model(conf["model"], seg_upsample=False, train=True)
    load_state_dict(model, sd)
    model.to(dev, memory_format=torch.channels_last if cuda
             else torch.contiguous_format)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, size,
                                              tp["epochs"])
    state = create_train_state(model, opt_cfg)
    step = make_train_step(
        model, det_loss, opt_cfg, lf, nb=tp["nb"],
        warmup_iters=max(round(3 * tp["nb"]), 1000), nominal_bs=b,
        batch_size=b, fused_seg=True, dtype=dtype)
    nc = int(conf["model"]["de_nc"])
    batches = [make_batch(b, size, nc, tp["max_targets"], seed + 7 + j, dev)
               for j in range(tp["pool"])]

    start = {k: p.detach().clone() for k, p in state.params.items()}
    prog = {"loss": []}
    t = time.perf_counter()
    for j in range(tp["checked"]):
        state, m = step(state, batches[j % tp["pool"]])
        prog["loss"].append(float(m["loss"]))
        if j == 0:
            first_call_s = time.perf_counter() - t
            prog["grad"] = {k: float(v.norm())
                            for k, v in state.opt_state["mu"].items()}
    prog["change"] = {k: float((p.detach() - start[k]).norm())
                      for k, p in state.params.items()}
    del start
    stretch = Stretch(ctx["trace"], dev)
    stretch.prime()
    sync()
    if cuda:  # the window's peak, not set-up's
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = t_window - ctx["t_start"]

    i, traced = 0, range(tp["trace_at"], tp["trace_at"] + tp["trace_calls"])
    while True:
        if ctx["trace"] and i == traced.start:
            stretch.start()
        with record_function("bench.train_step"):
            state, m = step(state, batches[(tp["checked"] + i) % tp["pool"]])
        if ctx["trace"] and i == traced.stop - 1:
            stretch.stop()
        i += 1
        if i >= traced.stop and time.perf_counter() - t_window >= ctx["seconds"]:
            break
    sync()
    elapsed = time.perf_counter() - t_window
    final_loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, step, model, m
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = R.steps(conf["model"], sd, batches[:tp["checked"]], tp["hyp"])
    checks = R.gaps(prog, ref)
    ref_s = time.perf_counter() - t
    records = stretch.records()
    if records:
        records.update(calls=len(traced), units=len(traced) * b,
                       flops_per_unit=train_flops(conf["model"], size, size))
    return {
        "e2e": {"train_img_s": i * b / elapsed, "setup_s": setup_s},
        "attempted": i * b, "failed": 0,
        "checks": checks, "records": records, "memory_peak_bytes": peak,
        "notes": {"first_call_s": first_call_s, "window_steps": i,
                  "window_s": elapsed, "reference_s": ref_s,
                  "losses": prog["loss"], "reference_losses": ref["loss"],
                  "last_loss": final_loss},
    }
