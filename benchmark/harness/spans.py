"""The program's own spans in a traced run's records.

With a profiler running, ``desenet_tpu_torch.utils.profiling.span`` opens
each span as a ``record_function`` of its name, so the spans are host
events of ``records["host"]`` (``harness/trace.py``), on the device
events' clock. A program without those spans has no such events, and the
readers here return None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from benchmark.harness.trace import merge


def host_ms(rec: dict, name: str) -> Optional[float]:
    """Host ms a call inside the spans ``name`` over the traced calls."""
    if not rec.get("calls"):
        return None
    ts = [e - s for n, s, e in rec.get("host", ()) if n == name]
    if not ts:
        return None
    return sum(ts) / 1e3 / rec["calls"]


def overlap(a: List[Tuple[float, float]],
            b: List[Tuple[float, float]]) -> float:
    """The length two merged, sorted interval lists share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_inside_pct(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Share of the traced stretch in which nothing ran on the card while
    the host was inside a span of ``names``."""
    names = set(names)
    if not rec.get("device") or not rec.get("window_s"):
        return None
    inside = merge([(s, e) for n, s, e in rec.get("host", ()) if n in names])
    if not inside:
        return None
    busy = merge([(s, e) for _, s, e in rec["device"]])
    idle = sum(e - s for s, e in inside) - overlap(inside, busy)
    return 100.0 * idle / (rec["window_s"] * 1e6)
