"""Real requests a device call of ``serve.BatchRunner`` over the window
(its ``stats``: requests over batches)."""

LAYER = "micro-batching (serve.BatchRunner)"
UNIT = "req/call"
MOVES = "latency_p95_ms"


def read(rec: dict):
    st = rec.get("runner") or {}
    return st["requests"] / st["batches"] if st.get("batches") else None
