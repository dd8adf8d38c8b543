"""General host utilities of the entry points: dataset yaml checks,
image-size rounding, run-dir increment, logging, the COCO class map, and for
training the seeds, the latest run, class and image weights and early
stopping; for detection the coloured console string and the box crop.

The port's own copy of those functions of ``desenet_tpu/utils/general.py``
(and ``make_divisible``, which they call); numpy and the standard library at
module level, PyYAML imported where a yaml file that is not JSON is read,
cv2 where a crop is written.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import random
import re
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

LOGGER = logging.getLogger("desenet_tpu_torch")


def set_logging(verbose: bool = True):
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if verbose else logging.WARNING,
    )


def init_seeds(seed: int = 0) -> torch.Generator:
    """Seed ``random`` and numpy's global RNG, and return a CPU
    ``torch.Generator`` seeded with ``seed`` for the weights' init; torch's
    global seed is left alone."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def colorstr(*input):
    """colorstr('blue', 'hello world') -> the string in ANSI colours."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bold": "\033[1m", "underline": "\033[4m", "end": "\033[0m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def load_yaml(path) -> Dict:
    """A yaml file as a dict: JSON text (a subset of YAML) without PyYAML,
    anything else through PyYAML."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml

        return yaml.safe_load(text)


def check_dataset(data) -> Dict:
    """Load and validate a dataset yaml with de/se class blocks. Returns
    the dict."""
    if isinstance(data, (str, Path)):
        data = load_yaml(data)

    def require(ok, msg):
        if not ok:
            raise ValueError(msg)

    for k in ("train", "val"):
        require(k in data, f"dataset yaml missing '{k}' key")
    for k in ("de", "se"):
        require(k in data, f"dataset yaml missing '{k}' block")
        require("nc" in data[k] and "names" in data[k],
                f"dataset '{k}' block needs nc + names")
        require(len(data[k]["names"]) == int(data[k]["nc"]),
                f"{k}: len(names) != nc")
    for k in ("train", "val", "test"):
        if data.get(k):
            p = Path(data[k])
            require(p.exists(), f"dataset path does not exist: {p}")
    return data


def check_img_size(imgsz: int, s: int = 32, floor: int = 0) -> int:
    """Round image size up to a stride multiple."""
    new = max(make_divisible(int(imgsz), s), floor)
    if new != imgsz:
        LOGGER.warning("img size %d not a multiple of %d, using %d", imgsz, s,
                       new)
    return new


def make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


def get_latest_run(search_dir: str = ".") -> str:
    """Most recent 'last' checkpoint dir under ``search_dir``, the bare
    ``--resume`` target (checkpoints are directories marked by meta.json)."""
    metas = glob.glob(os.path.join(search_dir, "**", "last", "meta.json"),
                      recursive=True)
    return os.path.dirname(max(metas, key=os.path.getmtime)) if metas else ""


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False):
    """runs/exp -> runs/exp2, exp3...."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() \
            else (path, "")
        dirs = glob.glob(f"{path}{sep}*")
        matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d)
                   for d in dirs]
        i = [int(m.groups()[0]) for m in matches if m]
        n = max(i) + 1 if i else 2
        path = Path(f"{path}{sep}{n}{suffix}")
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def labels_to_class_weights(labels: Sequence[np.ndarray], nc: int) -> np.ndarray:
    """Inverse-frequency class weights. labels: list of (n, 5) [cls, xywh]."""
    if not len(labels):
        return np.ones(nc) / nc
    classes = np.concatenate(
        [l[:, 0] for l in labels if len(l)] or [np.zeros(0)], 0
    ).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    weights /= weights.sum()
    return weights


def labels_to_image_weights(labels, nc: int, class_weights: np.ndarray):
    """Per-image sampling weights from class weights."""
    counts = np.array(
        [np.bincount(l[:, 0].astype(int), minlength=nc) if len(l)
         else np.zeros(nc) for l in labels]
    )
    return (class_weights.reshape(1, nc) * counts).sum(1)


class EarlyStopping:
    """Stop when the fitness has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(
                "EarlyStopping: no improvement in last %d epochs "
                "(best epoch %d). Stopping.", self.patience, self.best_epoch,
            )
        return stop


def coco80_to_coco91_class() -> List[int]:
    """COCO 80-class index -> paper 91-class ids."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]


def save_one_box(xyxy, im, file="crop.jpg", gain=1.02, pad=10, square=False,
                 BGR=True, save=True):
    """Crop a box, grown by ``gain`` and ``pad`` pixels (squared with
    ``square``) and clipped to the image, from ``im``; write it to ``file``
    with cv2 where ``save``. Returns the crop."""
    b = np.asarray(xyxy, np.float32).reshape(4)
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    bw, bh = (b[2] - b[0]), (b[3] - b[1])
    if square:
        bw = bh = max(bw, bh)
    bw, bh = bw * gain + pad, bh * gain + pad
    x1 = int(max(cx - bw / 2, 0))
    y1 = int(max(cy - bh / 2, 0))
    x2 = int(min(cx + bw / 2, im.shape[1]))
    y2 = int(min(cy + bh / 2, im.shape[0]))
    crop = im[y1:y2, x1:x2, :: (1 if BGR else -1)]
    if save:
        import cv2

        Path(file).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(file), crop)
    return crop
