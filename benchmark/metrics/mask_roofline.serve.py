"""The mask assembly (``mask_assembly_kernel``) against its bound: the
least time its work on these inputs could take on the card
(``counts/v7seg.mask_assembly_bound``: 64 operations a proto pixel inside
each served box's crop, the prototypes read once an image, the
coefficients of the served boxes, every bit row written; the boxes and
crops counted from what the traced calls served) over the kernel's mean
time a launch in the trace."""

from benchmark.counts.v7seg import mask_assembly_bound

LAYER = "instance masks (ops/mask_assembly.py)"
UNIT = "%"
MOVES = "serve_img_s"
PATTERN = "mask_assembly_kernel"


def read(rec: dict):
    ts = [e - s for name, s, e in rec.get("device", ()) if PATTERN in name]
    if not ts or "mask_work" not in rec:
        return None
    bound_ms, _ = mask_assembly_bound(**rec["mask_work"])
    per_launch_ms = sum(ts) / len(ts) / 1e3
    return 100.0 * bound_ms / per_launch_ms
