"""The program's device spans in a traced run.

``desenet_tpu_torch.utils.profiling.span(name, device=<a CUDA device>)``
times its block on that card with a pair of CUDA events on the device's
current stream while tracing is on (in a
traced run: while the profiler runs), and ``profiling.spans()`` returns it
with ``device_ms``. A program without such spans, or a span without
``device_ms``, gives nothing to read, and the readers here return None.
"""

from __future__ import annotations

from typing import Optional


def device_ms(rec: dict, name: str) -> Optional[float]:
    """Device ms a traced call inside the spans ``name``."""
    if not rec.get("calls"):
        return None
    try:
        from desenet_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    ms = [getattr(s, "device_ms", None) for s in spans(name)]
    ms = [v for v in ms if v is not None]
    if not ms:
        return None
    return sum(ms) / rec["calls"]
