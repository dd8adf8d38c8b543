"""Share of the traced stretch of training in which nothing ran on the
card while the host was inside the program's ``train.update`` (gradient
sum, optimizer, frozen rows' restore) or ``train.ema`` spans."""

from benchmark.harness.spans import idle_inside_pct

LAYER = "train step (train/step.py, losses/, ops/seg_ce.py)"
UNIT = "%"
MOVES = "train_img_s"


def read(rec: dict):
    return idle_inside_pct(rec, ("train.update", "train.ema"))
