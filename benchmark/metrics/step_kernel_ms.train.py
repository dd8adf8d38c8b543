"""The train step's device time a step: every kernel, copy and set in the
traced stretch, over the steps traced."""

LAYER = "train step (train/step.py, losses/, ops/seg_ce.py)"
UNIT = "ms"
MOVES = "train_img_s"


def read(rec: dict):
    dev = rec.get("device")
    if not dev or not rec.get("calls"):
        return None
    return sum(e - s for _, s, e in dev) / 1e3 / rec["calls"]
