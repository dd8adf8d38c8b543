"""The share of the served forwards whose row 0 took the served stem
(``ops/stem_pallas.served_stem``: the uint8 batch widened, conv, BN and
SiLU in one pass): the counters ``stem.fused`` over ``stem.fused`` plus
``stem.plain`` (``models/build.py``: one a forward in eval on a float
input), counted while tracing is on. Tracing comes on with the profiler
alone in a traced run (``DESENET_TRACE`` unset), so the counters cover the
traced stretch. None without traced calls, or where the program keeps no
such counters."""

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "%"
MOVES = "serve_img_s"


def read(rec: dict):
    if not rec.get("calls"):
        return None
    try:
        from desenet_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    fused, plain = c.get("stem.fused", 0), c.get("stem.plain", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
