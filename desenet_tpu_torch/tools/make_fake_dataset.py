"""Generate a small synthetic mixed det+seg dataset in the reference layout:

    root/
      Images/{train,val}/img_*.jpg
      DeLabels/{train,val}/img_*.txt   "cls x y w h" normalized
      SeLabels/{train,val}/img_*.txt   "cls x1 y1 x2 y2 ..." normalized polygon
      data.yaml                         train/val paths + de/se class maps

    python -m desenet_tpu_torch.tools.make_fake_dataset /tmp/fakeds \\
        --n-train 32 --n-val 8 --size 640

The port's own copy of ``tools/make_fake_dataset.py``: the same images and
labels from the same seed (coloured rectangles as det objects on a textured
background, a quadrilateral "road" band as the seg class); ``data.yaml`` is
written as JSON text, valid YAML that the port reads without PyYAML. cv2 is
imported inside ``generate``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DE_NAMES = ["person", "car", "pole", "dog", "bike", "sign"]
SE_NAMES = ["background", "road", "sidewalk"]


def make_image(rng, size, de_nc, se_nc):
    import cv2

    h = w = size
    img = rng.integers(120, 200, (h, w, 3), dtype=np.uint8)
    noise = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
    img = cv2.add(img, noise)

    # seg region: a horizontal band quadrilateral ("road"), maybe a second
    seg_lines = []
    for cls in range(1, se_nc):
        if rng.random() < 0.9:
            y0 = rng.uniform(0.3, 0.7)
            th = rng.uniform(0.15, 0.3)
            x_jit = rng.uniform(-0.08, 0.08, 4)
            poly = np.array(
                [
                    [0.02 + x_jit[0], y0],
                    [0.98 + x_jit[1], y0 + rng.uniform(-0.05, 0.05)],
                    [0.98 + x_jit[2], min(y0 + th, 0.98)],
                    [0.02 + x_jit[3], min(y0 + th + rng.uniform(-0.05, 0.05), 0.98)],
                ]
            ).clip(0.0, 1.0)
            pts = (poly * [w, h]).astype(np.int32)
            color = [int(60 + 50 * cls), int(60 + 30 * cls), int(90 * cls)]
            cv2.fillPoly(img, [pts], color)
            flat = " ".join(f"{v:.6f}" for v in poly.reshape(-1))
            seg_lines.append(f"{cls} {flat}")

    det_lines = []
    for _ in range(rng.integers(1, 6)):
        cls = int(rng.integers(0, de_nc))
        bw, bh = rng.uniform(0.08, 0.3, 2)
        cx = rng.uniform(bw / 2, 1 - bw / 2)
        cy = rng.uniform(bh / 2, 1 - bh / 2)
        x0, y0 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
        x1, y1 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
        color = [int(40 * cls + 30), int(255 - 35 * cls), int(35 * cls + 20)]
        cv2.rectangle(img, (x0, y0), (x1, y1), color, -1)
        cv2.rectangle(img, (x0, y0), (x1, y1), (20, 20, 20), 1)
        det_lines.append(f"{cls} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
    return img, det_lines, seg_lines


def generate(root, n_train=32, n_val=16, size=320, de_nc=6, se_nc=3, seed=0):
    """Write the dataset under ``root``; returns the data.yaml path."""
    import cv2

    rng = np.random.default_rng(seed)
    for split, n in [("train", n_train), ("val", n_val)]:
        for d in ["Images", "DeLabels", "SeLabels"]:
            os.makedirs(os.path.join(root, d, split), exist_ok=True)
        for i in range(n):
            img, det, seg = make_image(rng, size, de_nc, se_nc)
            name = f"img_{i:04d}"
            cv2.imwrite(os.path.join(root, "Images", split, name + ".jpg"), img)
            with open(os.path.join(root, "DeLabels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(det) + "\n")
            with open(os.path.join(root, "SeLabels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(seg) + ("\n" if seg else ""))

    data = {
        "train": os.path.join(root, "Images", "train"),
        "val": os.path.join(root, "Images", "val"),
        "de": {"nc": de_nc, "names": DE_NAMES[:de_nc]},
        "se": {"nc": se_nc, "names": SE_NAMES[:se_nc]},
    }
    yaml_path = os.path.join(root, "data.yaml")
    with open(yaml_path, "w") as f:
        json.dump(data, f, indent=1)
    return yaml_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(generate(args.root, args.n_train, args.n_val, args.size,
                   seed=args.seed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
