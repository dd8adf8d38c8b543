"""Instance masks assembled an image as the program counts them: the
counters ``masks.kept`` over ``masks.images``
(``ops/mask_assembly.assemble_masks``, after each launch, summed on the
card, while tracing is on). Tracing comes on with the profiler alone in a
traced run (``DESENET_TRACE`` unset), so the counters cover the traced
stretch. None without traced calls, or where the program keeps no such
counters."""

LAYER = "instance masks (ops/mask_assembly.py)"
UNIT = "masks/img"
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
    if not c.get("masks.images"):
        return None
    return c.get("masks.kept", 0) / c["masks.images"]
