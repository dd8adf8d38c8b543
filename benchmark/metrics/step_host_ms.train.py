"""The host's time in a train step: ms a step inside the program's
``train.step`` spans, over the traced steps. Near or above
``step_kernel_ms.train``, the step is bound by its launches."""

from benchmark.harness.spans import host_ms

LAYER = "train step (train/step.py, losses/, ops/seg_ce.py)"
UNIT = "ms"
MOVES = "train_img_s"


def read(rec: dict):
    return host_ms(rec, "train.step")
