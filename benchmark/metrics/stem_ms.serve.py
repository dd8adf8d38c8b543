"""The served stem's device time a batch: the card's ms inside the
program's device span ``forward.stem`` (``models/build.py``, around row 0;
on the served path that is the widen, conv, BN and SiLU of
``ops/stem_pallas.served_stem`` in one kernel), over the batches traced.
None where the program records no such span."""

from benchmark.harness.device_spans import device_ms

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    return device_ms(rec, "forward.stem")
