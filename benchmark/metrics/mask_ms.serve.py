"""The mask assembly's device time a served batch: the profiler's rows of
``mask_assembly_kernel`` (``csrc/mask_assembly.cu``: each kept box's
instance mask from its coefficients and the prototypes, cropped and
bit-packed) in the traced stretch, over the batches traced. None where no
such kernel ran."""

LAYER = "instance masks (ops/mask_assembly.py)"
UNIT = "ms"
MOVES = "serve_img_s"
PATTERN = "mask_assembly_kernel"


def read(rec: dict):
    ts = [e - s for name, s, e in rec.get("device", ()) if PATTERN in name]
    if not ts or not rec.get("calls"):
        return None
    return sum(ts) / 1e3 / rec["calls"]
