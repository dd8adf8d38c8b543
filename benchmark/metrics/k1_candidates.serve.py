"""K1's candidates an image as the program counts them: the counters
``k1.candidates`` over ``k1.images`` (``ops/nms_fused.fused_select_nms``,
summed on the card while tracing is on). Tracing comes on with the
profiler alone in a traced run (``DESENET_TRACE`` unset), so the counters
cover the traced stretch. None without traced calls, or where the program
keeps no such counters."""

LAYER = "kernels K1 and K2"
UNIT = "cand/img"
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
    if not c.get("k1.images"):
        return None
    return c.get("k1.candidates", 0) / c["k1.images"]
