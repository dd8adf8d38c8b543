"""Run a serving export of the port with nothing but torch and numpy.

    python -m desenet_tpu_torch.tools.export_model runs/train/exp/best \\
        model.pt2 --batch 1 --img-size 640
    python desenet_tpu_torch/tools/consume_exported_model.py model.pt2 \\
        image.npy [outputs.npz]

Counterpart of ``examples/consume_exported_model.py``. The only imports are
json, sys, numpy and torch: ``desenet_tpu_torch`` is not imported
(``tests/test_torch_export.py`` checks that), so the script runs where the
port is not installed. The sidecar ``<artifact>.json`` holds the I/O
contract: the input is a uint8 NHWC letterboxed RGB batch at ``img_size``;
the outputs are boxes (xyxy, letterboxed px), scores, classes, num_valid
and the uint8 seg mask. The image is an ``.npy`` HWC uint8 RGB array; it
is letterboxed with numpy (nearest resize, grey 114 padding) and run on
the device the artifact was exported on (an f32 artifact with TF32 off
in cuBLAS and cuDNN, so that its products are f32 ones). Prints the detections in the
image's pixels and the seg class histogram; with a third argument the raw
outputs are saved there (``np.savez``).
"""

import json
import sys

import numpy as np
import torch


def load(artifact_path):
    """The artifact's program (a torch.nn.Module) and its I/O contract."""
    program = torch.export.load(artifact_path).module()
    with open(artifact_path + ".json") as f:
        contract = json.load(f)
    return program, contract


def letterbox_u8(img, size):
    """Aspect-preserving nearest resize into a size x size grey (114)
    canvas, centred, with numpy only. Returns (canvas, ratio, (dx, dy))."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    ys = (np.arange(nh) / r).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(nw) / r).astype(np.int64).clip(0, w - 1)
    out = np.full((size, size, 3), 114, np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top:top + nh, left:left + nw] = img[ys][:, xs]
    return out, r, (left, top)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__)
        return 2
    program, contract = load(argv[0])
    size, device = contract["img_size"], contract["device"]
    if contract["dtype"] == "float32":  # f32 products, not TF32's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x, r, (dx, dy) = letterbox_u8(np.load(argv[1]), size)
    batch = np.repeat(x[None], contract["batch"], 0)
    with torch.no_grad():
        outs = program(torch.from_numpy(batch).to(device))
    boxes, scores, classes, num, seg = (t.cpu().numpy() for t in outs)
    if len(argv) == 3:
        np.savez(argv[2], boxes=boxes, scores=scores, classes=classes,
                 num=num, seg=seg)
    n = int(num[0])
    names = contract["meta"].get("de_names") or []
    print(f"{n} detections (artifact device: {device})")
    for i in range(n):
        x1, y1, x2, y2 = ((boxes[0, i] - np.array([dx, dy, dx, dy])) / r
                          ).tolist()
        c = int(classes[0, i])
        label = names[c] if c < len(names) else c
        print(f"  {label}: {float(scores[0, i]):.3f} "
              f"[{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
    ids, counts = np.unique(seg[0], return_counts=True)
    print("seg class histogram:",
          {int(k): int(v) for k, v in zip(ids, counts)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
