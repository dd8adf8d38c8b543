"""Per call of ``Predictor.__call__`` under the runner, the ms outside its
``run_batch``: the letterbox, the stack, the boxes scaled back, the masks
cropped, ``Detections`` (the benchmark's own timers around both calls)."""

import statistics

LAYER = "host pre and post (api.Predictor.run_batch, __call__)"
UNIT = "ms"
MOVES = "latency_p95_ms"


def read(rec: dict):
    ms = rec.get("prepost_ms")
    return statistics.fmean(ms) if ms else None
