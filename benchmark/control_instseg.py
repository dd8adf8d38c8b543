"""The readings that the instance-segmentation cell's limits are set
from: the program's numbers and the control's, seed by seed, in one
process (``control.py``'s for the driver ``offline_instseg``).

    python benchmark/control_instseg.py --workload x7seg.serve.b128 \\
        --seeds 11,12,13

For each seed: the cell's weights (``harness/weights_v7seg.py``) and
traffic, then ``Predictor.run_batch`` on the ``sample`` batches of the
pool a run compares, judged by ``reference/instseg.py`` (``det_gap``,
``mask_gap``). The control is the program with its fp8 activation
storage switched on (``build_model(act_store="fp8")``: every block's
output, Proto's convs included, stored in float8 e4m3, the step below the
configuration's bfloat16), on the same inputs and judged the same way.

One JSON line a seed: ``{"seed", "program": {...}, "program_correct",
"control": {...}, "control_correct", "boxes": {...}, "seconds"}``, each
side's numbers held to the cell's limits. ``boxes`` reads the program's
served boxes one by one (``instseg.box_readings``): the widest anchor gap
and the most decided pixels a box flips, against ``ANCHOR_REACH`` and
``MIN_DECIDED``; and two faults planted in the program's own answer on
the card: every anchor shifted by one (the least ``mask_gap`` of an
image alone) and each box's mask inverted inside its crop (what
``mask_gap`` reads: ``FAULT`` where the box has ``MIN_DECIDED`` decided
pixels, else its ``reach``; the least, and how many boxes would pass).
Exits 1 where a program reading breaks a limit or the control keeps them
all. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class BoxReadings:
    """``judge_batches``' ``each_image`` hook: the program's box readings
    and the two planted faults' (module docstring)."""

    def __init__(self, limit: float):
        self.limit = limit
        self.anchor, self.flipped, self.share = 0.0, 0, 0.0
        self.boxes, self.neg, self.neg_pass, self.shifted = 0, [], 0, []

    def __call__(self, proto, dec, nc, served, anchors, bits, n, img_hw):
        import numpy as np

        from benchmark.reference import instseg as I

        if n == 0:
            return
        r = I.box_readings(proto, dec, nc, served, anchors, bits, n, img_hw)
        decided, flipped = r["decided"], r["flipped"]
        judged = decided >= I.MIN_DECIDED
        self.anchor = max(self.anchor, float(r["anchor"].max()))
        self.flipped = max(self.flipped, int(flipped.max()))
        if bool(judged.any()):
            self.share = max(self.share, float(
                (flipped[judged] / decided[judged]).max()))
        inverted = judged & (2 * (decided - flipped) > decided)
        neg = np.where(inverted.cpu().numpy(), I.FAULT,
                       r["reach"].cpu().numpy())
        self.boxes += n
        self.neg.append(float(neg.min()))
        self.neg_pass += int((neg <= self.limit).sum())
        moved = np.asarray(anchors).copy()
        moved[:n] = np.minimum(moved[:n] + 1, dec.shape[0] - 1)
        self.shifted.append(I.mask_gap_one(proto, dec, nc, served, moved,
                                           bits, n, img_hw))

    def summary(self) -> dict:
        from benchmark.reference.instseg import FAULT

        return {"boxes": self.boxes, "anchor_gap_max": self.anchor,
                "decided_flipped_max": self.flipped,
                "decided_share_max": self.share,
                "shifted_least": min(self.shifted),
                "shifted_fault_images": sum(g >= FAULT for g in self.shifted),
                "images": len(self.shifted),
                "inverted_least": min(self.neg),
                "inverted_passing_boxes": self.neg_pass}


def readings(cell: str, seed: int, device) -> dict:
    import numpy as np
    import torch

    from benchmark.control import _fp8_model
    from benchmark.harness import cell as C
    from benchmark.harness.frames import letterbox_rgb, make_frames
    from benchmark.harness.weights_v7seg import seeded_weights
    from benchmark.reference.instseg import judge_batches
    from desenet_tpu_torch.api import Predictor

    wl = C.workload(cell)
    if wl["driver"] != "offline_instseg":
        raise ValueError(f"{cell}: driver {wl['driver']}, not "
                         "offline_instseg (control.py reads the others)")
    conf, tp, limits = C.config(wl["config"]), wl["params"], wl["limits"]
    sd = seeded_weights(conf, seed, device)
    pred = Predictor(conf["model"], sd, imgsz=conf["imgsz"],
                     half=conf["dtype"] == "bfloat16", device=device)
    spec = (pred.conf_thres, pred.iou_thres, pred.max_det)
    fh, fw = tp["frame_hw"]
    b = tp["batch"]
    frames = make_frames(b * tp["pool"], fh, fw, seed + 2,
                         device).cpu().numpy()
    rng = np.random.default_rng(seed)
    ks = rng.choice(tp["sample_from"], tp["sample"], replace=False)
    inputs = {int(k): letterbox_rgb(frames[(k % tp["pool"]) * b:
                                           (k % tp["pool"] + 1) * b],
                                    conf["imgsz"]) for k in ks}

    def judged(hook=None):
        outs = {k: pred.run_batch(v) for k, v in inputs.items()}
        return judge_batches(conf, sd, inputs, outs, device, *spec,
                             each_image=hook)[0]

    def correct(checks):
        return all(checks[k] <= v for k, v in limits.items())

    boxes = BoxReadings(limits["mask_gap"])
    out = {"seed": seed, "program": judged(boxes)}
    out["program_correct"] = correct(out["program"])
    out["boxes"] = boxes.summary()
    pred.model = _fp8_model(pred, conf, sd)
    pred._place_replicas([pred.device])
    out["control"] = judged()
    out["control_correct"] = correct(out["control"])
    del pred
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control_instseg.py: no CUDA card", file=sys.stderr)
        return 2
    rc = 0
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        if r["control_correct"] or not r["program_correct"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
