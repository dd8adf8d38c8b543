"""Misc dataset utilities: create_folder, flatten_recursive, extract_boxes,
autosplit and rename_dataset_prefix.

The port's copy of ``desenet_tpu/data/misc_tools.py`` over its own
``data/dataset.py`` (``IMG_FORMATS``, ``img2label_paths``); cv2 is imported
by the function that reads and writes images.
"""

from __future__ import annotations

import glob
import os
import random
import shutil
from pathlib import Path

import numpy as np

from desenet_tpu_torch.data.dataset import IMG_FORMATS, img2label_paths


def create_folder(path: str = "./new"):
    """(Re)create an empty directory."""
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def flatten_recursive(path: str):
    """Copy every file of a directory tree into <path>_flat."""
    new_path = Path(str(path) + "_flat")
    create_folder(str(new_path))
    for file in glob.glob(str(Path(path)) + "/**/*.*", recursive=True):
        shutil.copyfile(file, new_path / Path(file).name)
    return str(new_path)


def extract_boxes(path: str):
    """Detection dataset -> per-class crop classification dataset under
    ``<path>/classifier/<cls>/``, each box grown by 20% plus 3 px and
    clipped to the image. Returns the number of crops written."""
    import cv2

    path = Path(path)
    out = path / "classifier"
    if out.is_dir():
        shutil.rmtree(out)
    n = 0
    for im_file in sorted(path.rglob("*.*")):
        if im_file.suffix[1:].lower() not in IMG_FORMATS:
            continue
        im = cv2.imread(str(im_file))
        if im is None:
            continue
        h, w = im.shape[:2]
        lb_file = img2label_paths([str(im_file)])[0][0]
        if not os.path.exists(lb_file):
            continue
        with open(lb_file) as f:
            rows = np.array(
                [x.split() for x in f.read().strip().splitlines()],
                dtype=np.float32,
            )
        for j, x in enumerate(rows):
            c = int(x[0])
            f_out = out / str(c) / f"{im_file.stem}_{j}.jpg"
            f_out.parent.mkdir(parents=True, exist_ok=True)
            b = x[1:] * [w, h, w, h]
            b[2:] = b[2:] * 1.2 + 3  # pad
            x1 = int(max(b[0] - b[2] / 2, 0))
            y1 = int(max(b[1] - b[3] / 2, 0))
            x2 = int(min(b[0] + b[2] / 2, w))
            y2 = int(min(b[1] + b[3] / 2, h))
            if x2 > x1 and y2 > y1:
                cv2.imwrite(str(f_out), im[y1:y2, x1:x2])
                n += 1
    return n


def autosplit(path: str, weights=(0.9, 0.1, 0.0), seed: int = 0,
              annotated_only: bool = False):
    """Write autosplit_{train,val,test}.txt index files beside ``path``,
    each image drawn into a split by ``random.Random(seed)`` with
    ``weights``. Returns the counts."""
    path = Path(path)
    files = sorted(
        x for x in path.rglob("*.*") if x.suffix[1:].lower() in IMG_FORMATS
    )
    rng = random.Random(seed)
    txt = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for t in txt:
        f = path.parent / t
        if f.exists():
            f.unlink()
    counts = [0, 0, 0]
    for img in files:
        if annotated_only:
            lb = img2label_paths([str(img)])[0][0]
            if not os.path.exists(lb):
                continue
        i = rng.choices([0, 1, 2], weights=weights)[0]
        counts[i] += 1
        with open(path.parent / txt[i], "a") as f:
            f.write("./" + str(img.relative_to(path.parent)) + "\n")
    return counts


def rename_dataset_prefix(dataset_dir, new_name: str,
                          old_names=("sidewalk", "step")):
    """Batch-rename dataset files and directories whose basename starts with
    one of ``old_names``: the first ``_``-separated token is replaced by
    ``new_name``. Renames deepest-first so directory renames do not orphan
    the files inside them. Returns the (old, new) path pairs."""
    root = Path(dataset_dir)
    prefixes = tuple(old_names)
    renamed = []
    for p in sorted(root.rglob("*"), key=lambda q: -len(q.parts)):
        if p.name.startswith(prefixes):
            new = p.with_name(
                p.name.replace(p.name.split("_")[0], new_name))
            if new != p:
                p.rename(new)
                renamed.append((str(p), str(new)))
    return renamed
