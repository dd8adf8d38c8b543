"""Kernel K2 (``csrc/seg_tail.cu``, the seg tail: 8x bilinear upsample and
argmax) against its bound (``counts/bounds.seg_tail_bound`` at the served
logits' shape) over K2's mean time a launch in the trace."""

from benchmark.counts.bounds import seg_tail_bound

LAYER = "kernels K1 and K2"
UNIT = "%"
MOVES = "serve_img_s"
PATTERN = "seg_tail_"


def read(rec: dict):
    ts = [e - s for name, s, e in rec.get("device", ()) if PATTERN in name]
    if not ts or "k2_shape" not in rec:
        return None
    bound_ms, _ = seg_tail_bound(**rec["k2_shape"])
    return 100.0 * bound_ms / (sum(ts) / len(ts) / 1e3)
