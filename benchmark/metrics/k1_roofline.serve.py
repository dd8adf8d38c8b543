"""Kernel K1 (``csrc/nms_fused.cu``, fused candidate selection and greedy
NMS) against its bound: the least time for the work these inputs need
(``counts/bounds.nms_fused_bound``, with the candidates and picks an image
that the reference counts on the traced batches) over K1's mean time a
launch in the trace."""

from benchmark.counts.bounds import nms_fused_bound

LAYER = "kernels K1 and K2"
UNIT = "%"
MOVES = "serve_img_s"
PATTERN = "nms_fused_kernel"


def read(rec: dict):
    ts = [e - s for name, s, e in rec.get("device", ()) if PATTERN in name]
    if not ts or "k1_work" not in rec:
        return None
    bound_ms, _ = nms_fused_bound(**rec["k1_work"])
    per_launch_ms = sum(ts) / len(ts) / 1e3
    return 100.0 * bound_ms / per_launch_ms
