"""A P6 model's stride-64 stage, its device time a served batch: the
card's ms inside the program's device spans ``forward.p6``
(``models/build.py``, around each run of rows at output stride 64: rows
9-12 and 30-32 of yolov5x6_seg), over the batches traced. None where the
program records no such span (a P5 model, or an older program)."""

from benchmark.harness.device_spans import device_ms

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return device_ms(rec, "forward.p6")
