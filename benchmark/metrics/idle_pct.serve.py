"""Share of the traced stretch of offline serving in which nothing ran on
the card (no kernel, copy or set)."""

LAYER = "device (H100)"
UNIT = "%"
MOVES = "serve_img_s"


def read(rec: dict):
    if not rec.get("device") or not rec.get("window_s"):
        return None
    return 100.0 * max(0.0, 1.0 - rec["busy_s"] / rec["window_s"])
