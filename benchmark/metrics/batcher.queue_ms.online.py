"""Median ms from a request's due time to the start of the predictor call
that served it (the benchmark's wrapper around the predictor it hands the
runner notes when each call starts)."""

import statistics

LAYER = "micro-batching (serve.BatchRunner)"
UNIT = "ms"
MOVES = "latency_p95_ms"


def read(rec: dict):
    q = rec.get("queue_ms")
    return statistics.median(q) if q else None
