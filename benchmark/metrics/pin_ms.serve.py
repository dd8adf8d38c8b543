"""The pin copy of a served batch: host ms a batch inside the program's
``predict.pin`` spans (``Predictor.run_batch``: the batch copied into
page-locked memory), over the traced batches."""

from benchmark.harness.spans import host_ms

LAYER = "host pre and post (api.Predictor.run_batch, __call__)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return host_ms(rec, "predict.pin")
