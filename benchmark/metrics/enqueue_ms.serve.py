"""The host's time to launch a served batch's device program: ms a batch
inside the program's ``predict.infer`` spans (the forward, K1 with its
prep and K2 queued on the card), over the traced batches."""

from benchmark.harness.spans import host_ms

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return host_ms(rec, "predict.infer")
