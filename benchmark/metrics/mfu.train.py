"""The whole training step's share of the card's bf16 peak over the traced
stretch: the reference model's training FLOPs an image (three forwards,
``counts/flops.py``) times the images trained, over the stretch's
seconds, over 989 TFLOP/s."""

from benchmark.counts.bounds import H100_BF16_FLOPS

LAYER = "device, whole step"
UNIT = "%"
MOVES = "train_img_s"


def read(rec: dict):
    if not rec.get("device") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops_per_unit"] * rec["units"] / rec["window_s"] \
        / H100_BF16_FLOPS
