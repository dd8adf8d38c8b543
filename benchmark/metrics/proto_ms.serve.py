"""A Segment model's Proto (YOLOv5 v7.0's mask prototypes: two 3x3 convs
around a nearest 2x upsample, a 1x1 conv to 32, from the P3 map to 1/4 of
the input), its device time a served batch: the card's ms inside the
program's device spans ``forward.proto`` (``models/heads.Segment``), over
the batches traced. None where the program records no such span (a model
without a Segment row, or an older program)."""

from benchmark.harness.device_spans import device_ms

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return device_ms(rec, "forward.proto")
