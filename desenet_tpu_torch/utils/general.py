"""General host utilities of the validation entry points: dataset yaml
checks, image-size rounding, run-dir increment, logging, the COCO class map.

The port's own copy of those five functions of
``desenet_tpu/utils/general.py`` (and ``make_divisible``, which they call);
the standard library at module level, PyYAML imported where a yaml file is
read.
"""

from __future__ import annotations

import glob
import logging
import math
import re
from pathlib import Path
from typing import Dict, List

LOGGER = logging.getLogger("desenet_tpu_torch")


def set_logging(verbose: bool = True):
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if verbose else logging.WARNING,
    )


def check_dataset(data) -> Dict:
    """Load and validate a dataset yaml with de/se class blocks. Returns
    the dict."""
    if isinstance(data, (str, Path)):
        import yaml

        with open(data, encoding="utf-8") as f:
            data = yaml.safe_load(f)

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


def coco80_to_coco91_class() -> List[int]:
    """COCO 80-class index -> paper 91-class ids."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]
