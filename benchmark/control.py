"""The readings that a cell's limits are set from: the program's numbers
and the control's, seed by seed, in one process.

    python benchmark/control.py --workload s.serve.b128 --seeds 11,12,13

For each seed: the cell's weights and traffic, then the timed path's
calls on the batches a run compares (offline: ``sample`` batches of the
pool through ``Predictor.run_batch``; online: the cell's open loop into
the runner, ``sample`` requests of it), judged by the reference
(``reference/serve.py``). The control is the program with
its fp8 activation storage switched on (``build_model(act_store="fp8")``:
every block's output stored in float8 e4m3, the step below the
configuration's bfloat16), on the same inputs and judged the same way.
For a training cell the program takes the cell's checked first steps as
a run's set-up does; the control is the reference computed with every
block's output rounded to float8 e4m3 (the program has no such training
path); and the fault "half of the batch left out" is the program's step
on the first half of each batch. A step that returns its state unchanged
reads 1 on the change's number by construction and is not run.
One JSON line a seed: ``{"seed", "program": {...}, "control": {...}}``
(and ``"half_batch"`` for training). The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL_WINDOW_S = 8.0  # the online cell's open loop, for 512 requests


def _fp8_model(pred, conf, sd):
    """The Predictor's model rebuilt with fp8 activation storage."""
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.utils.convert import load_state_dict

    model, _ = build_model(conf["model"], seg_upsample=False,
                           fuse_focus=True, act_store="fp8")
    load_state_dict(model, sd)
    return model.to(pred.device, pred.dtype, memory_format=pred._mf)


def train_readings(wl: dict, conf: dict, seed: int, device) -> dict:
    import torch

    from benchmark.harness.train_batches import make_batch
    from benchmark.harness.weights import seeded_weights
    from benchmark.reference import train as R
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.train import create_train_state, make_train_step
    from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
    from desenet_tpu_torch.utils.convert import load_state_dict

    tp, size = wl["params"], conf["imgsz"]
    b, n = tp["batch"], tp["checked"]
    sd = seeded_weights(conf, seed, device)
    batches = [make_batch(b, size, int(conf["model"]["de_nc"]),
                          tp["max_targets"], seed + 7 + j, device)
               for j in range(n)]

    def program(rows: int) -> dict:
        model, spec = build_model(conf["model"], seg_upsample=False,
                                  train=True)
        load_state_dict(model, sd)
        model.to(device, memory_format=torch.channels_last)
        det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, size,
                                                  tp["epochs"])
        state = create_train_state(model, opt_cfg)
        step = make_train_step(
            model, det_loss, opt_cfg, lf, nb=tp["nb"],
            warmup_iters=max(round(3 * tp["nb"]), 1000), nominal_bs=rows,
            batch_size=rows, fused_seg=True, dtype=torch.bfloat16)
        start = {k: p.detach().clone() for k, p in state.params.items()}
        out = {"loss": []}
        for j, batch in enumerate(batches):
            state, m = step(state, {k: v[:rows] for k, v in batch.items()})
            out["loss"].append(float(m["loss"]))
            if j == 0:
                out["grad"] = {k: float(v.norm())
                               for k, v in state.opt_state["mu"].items()}
        out["change"] = {k: float((p.detach() - start[k]).norm())
                         for k, p in state.params.items()}
        return out

    prog = program(b)
    half = program(b // 2)
    ref = R.steps(conf["model"], sd, batches, tp["hyp"])
    ctl = R.steps(conf["model"], sd, batches, tp["hyp"],
                  store=torch.float8_e4m3fn)
    ctl = {"loss": ctl["loss"],
           "grad": {k: float(v.norm()) for k, v in ctl["grad"].items()},
           "change": {k: float(v.norm()) for k, v in ctl["change"].items()}}
    return {"seed": seed, "program": R.gaps(prog, ref),
            "control": R.gaps(ctl, ref), "half_batch": R.gaps(half, ref)}


def online_readings(wl: dict, conf: dict, seed: int, device) -> dict:
    """The online cell's timed path as a run drives it: the open loop at
    the cell's rate into the runner for ``CONTROL_WINDOW_S``, ``sample``
    requests compared; then the same with the control's model."""
    import numpy as np

    from benchmark.drivers import open_loop as OL
    from benchmark.reference.serve import judge_frames

    tp = wl["params"]
    ctx = {"workload": wl, "config": conf, "seed": seed, "device": device}
    sd, pred, runner, frames, timed, _ = OL.setup(ctx)
    spec = (pred.conf_thres, pred.iou_thres, pred.max_det)

    def judged():
        due, which = OL.schedule(tp["rate"], CONTROL_WINDOW_S, seed,
                                 tp["pool"])
        for d in (timed.kept, timed.call_start, timed.request_of):
            d.clear()
        rng = np.random.default_rng(seed + 3)
        timed.sampled = set(rng.choice(len(due), min(tp["sample"], len(due)),
                                       replace=False).tolist())
        OL.offer(runner, frames, due, which, timed.request_of,
                 drain_s=tp["drain_s"])
        ks = sorted(k for k in timed.sampled if k in timed.kept)
        served = [{"boxes": timed.kept[k][0][:, :4],
                   "scores": timed.kept[k][0][:, 4],
                   "classes": timed.kept[k][0][:, 5],
                   "seg": timed.kept[k][1]} for k in ks]
        return judge_frames(conf, sd, frames[which[ks]], served, device,
                            *spec)[0]

    try:
        out = {"seed": seed, "program": judged()}
        pred.model = _fp8_model(pred, conf, sd)
        pred._place_replicas([pred.device])
        out["control"] = judged()
    finally:
        runner.stop()
        runner.join(timeout=60)
    return out


def readings(cell: str, seed: int, device) -> dict:
    import numpy as np
    import torch

    from benchmark.harness import cell as C
    from benchmark.harness.frames import letterbox_rgb, make_frames
    from benchmark.harness.weights import seeded_weights
    from benchmark.reference.serve import judge_batches
    from desenet_tpu_torch.api import Predictor

    wl = C.workload(cell)
    conf, tp = C.config(wl["config"]), wl["params"]
    if wl["driver"] == "train_step":
        return train_readings(wl, conf, seed, device)
    if wl["driver"] == "open_loop":
        return online_readings(wl, conf, seed, device)
    sd = seeded_weights(conf, seed, device)
    pred = Predictor(conf["model"], sd, imgsz=conf["imgsz"],
                     half=conf["dtype"] == "bfloat16", device=device)
    spec = (pred.conf_thres, pred.iou_thres, pred.max_det)
    fh, fw = tp["frame_hw"]
    out = {"seed": seed}
    b = tp["batch"]
    frames = make_frames(b * tp["pool"], fh, fw, seed + 2,
                         device).cpu().numpy()
    rng = np.random.default_rng(seed)
    ks = rng.choice(tp["sample_from"], tp["sample"], replace=False)
    inputs = {int(k): letterbox_rgb(frames[(k % tp["pool"]) * b:
                                           (k % tp["pool"] + 1) * b],
                                    conf["imgsz"]) for k in ks}

    def judged():
        outs = {k: pred.run_batch(v) for k, v in inputs.items()}
        return judge_batches(conf, sd, inputs, outs, device, *spec)[0]

    out["program"] = judged()
    pred.model = _fp8_model(pred, conf, sd)
    pred._place_replicas([pred.device])
    out["control"] = judged()
    del pred
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
