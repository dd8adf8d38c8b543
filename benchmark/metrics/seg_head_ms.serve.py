"""The seg head's device time a served batch: the card's ms inside the
program's device span ``forward.seg_head`` (``models/build.py``, around the
SegMaskPSP2 row), over the batches traced. None where the program records
no such span."""

from benchmark.harness.device_spans import device_ms

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return device_ms(rec, "forward.seg_head")
