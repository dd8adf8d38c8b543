"""The share of the served forward's ConvBnAct calls that took the fused
epilogue (``models/layers.ConvBnAct``: BN, SiLU and the shortcut in one
pass over the conv's output, ``ops/conv_epilogue.py``): the counters
``epilogue.fused`` over ``epilogue.fused`` plus ``epilogue.plain``, counted
while tracing is on. Tracing comes on with the profiler alone in a traced
run (``DESENET_TRACE`` unset), so the counters cover the traced stretch.
None without traced calls, or where the program keeps no such counters."""

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
    fused, plain = c.get("epilogue.fused", 0), c.get("epilogue.plain", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
