"""The model forward's device time a served batch: every kernel in the
traced stretch (copies and sets left out) less K1's and K2's, over the
batches traced."""

LAYER = "model forward (models/build.py on cuDNN)"
UNIT = "ms"
MOVES = "serve_img_s"
OWN = ("nms_fused_kernel", "seg_tail_")


def read(rec: dict):
    kern = [(name, e - s) for name, s, e in rec.get("device", ())
            if not name.startswith(("Memcpy", "Memset"))]
    if not kern or not rec.get("calls"):
        return None
    us = sum(d for name, d in kern if not any(o in name for o in OWN))
    return us / 1e3 / rec["calls"]
