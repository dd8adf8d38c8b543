"""The share of the served forwards whose ``Segment`` head's Proto ran its
upsample and 3x3 conv as one phase-folded 2x2 conv and the phase pass
(``models/heads.py`` Proto, ``ops/conv_epilogue.conv_epilogue_phases``):
the counters ``proto.phased`` over ``proto.phased`` plus ``proto.plain``
(one an eval call of Proto), counted while tracing is on. Tracing comes
on with the profiler alone in a traced run (``DESENET_TRACE`` unset), so
the counters cover the traced stretch. None without traced calls, or
where the program keeps no such counters."""

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
    phased, plain = c.get("proto.phased", 0), c.get("proto.plain", 0)
    if not phased + plain:
        return None
    return 100.0 * phased / (phased + plain)
