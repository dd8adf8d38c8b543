"""General host utilities of the entry points: dataset yaml checks,
image-size rounding, run-dir increment, logging, the COCO class map, and for
training the seeds, the latest run, class and image weights and early
stopping; for detection the coloured console string, the box crop, the
matmul precision and the second-stage classifier; the file and suffix
checks, the environment banner, a SIGALRM timeout, the offline
``attempt_download`` and the evolution bookkeeping (``print_mutation``).

The port's own copy of the functions of ``desenet_tpu/utils/general.py``
(and ``make_divisible``, which they call), less ``host_cache_tag`` and
``enable_compile_cache``, which key XLA's compilation cache (eager PyTorch
has none); numpy and the standard library at module level, PyYAML imported
where a yaml file that is not JSON is read, cv2 where an image is cropped.
The files this module writes (``hyp_evolve.yaml``) are JSON text, which
YAML reads too.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import logging
import math
import os
import random
import re
import signal
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
    """A yaml file as a dict: JSON text (a subset of YAML), after any
    whole-line ``#`` comments, without PyYAML; anything else through
    PyYAML."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads("\n".join(ln for ln in text.splitlines()
                                    if not ln.lstrip().startswith("#")))
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


def set_matmul_precision(name: str) -> None:
    """``highest``: full f32 products (TF32 off in cuBLAS and cuDNN);
    ``high``: TF32 allowed in both; ``default`` leaves PyTorch's
    settings."""
    if name in (None, "default"):
        return
    torch.set_float32_matmul_precision(name)
    torch.backends.cudnn.allow_tf32 = name == "high"


def one_cycle_np(y1=1.0, y2=1.0, steps=100):
    """Host-side one-cycle lambda: cosine from y1 to y2 over ``steps``."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def check_environment(min_python=(3, 10)) -> Dict:
    """Environment banner: the interpreter version (at least
    ``min_python``, else ValueError), torch's version, its CUDA build and
    the visible cards. Installs nothing."""
    import platform
    import sys

    if sys.version_info < min_python:
        raise ValueError(f"python {min_python} required, running "
                         f"{platform.python_version()}")
    info = {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else []}
    LOGGER.info("environment: %s", info)
    return info


class Timeout(contextlib.ContextDecorator):
    """SIGALRM timeout context (main thread only); ``seconds=0`` disables
    it. A TimeoutError is swallowed unless ``suppress_timeout_errors`` is
    False."""

    def __init__(self, seconds: int, timeout_msg: str = "",
                 suppress_timeout_errors: bool = True):
        self.seconds = int(seconds)
        self.msg = timeout_msg
        self.suppress = suppress_timeout_errors

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg)

    def __enter__(self):
        if self.seconds > 0:
            signal.signal(signal.SIGALRM, self._handler)
            signal.alarm(self.seconds)

    def __exit__(self, exc_type, exc, tb):
        if self.seconds > 0:
            signal.alarm(0)
        return bool(self.suppress and exc_type is TimeoutError)


def try_except(func):
    """Decorator: log the wrapped function's exception as a warning and
    return None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the decorator's purpose
            LOGGER.warning("%s: %s", func.__name__, e)

    return wrapper


def check_suffix(file, suffix=(".ckpt",), msg=""):
    """ValueError where a file (or one of a list) has a suffix outside
    ``suffix``; files without a suffix pass."""
    if isinstance(suffix, str):
        suffix = (suffix,)
    for f in file if isinstance(file, (list, tuple)) else [file]:
        s = Path(f).suffix.lower()
        if s and s not in suffix:
            raise ValueError(f"{msg}{f} acceptable suffix is {suffix}")


def check_file(file: str) -> str:
    """A local file: the path itself, or the one match of ``**/<file>``
    under the working directory. URLs raise (this build is offline), as do
    no match and several."""
    file = str(file)
    if os.path.isfile(file) or not file:
        return file
    if file.startswith(("http:/", "https:/")):
        raise FileNotFoundError(
            f"cannot download {file}: this build is offline; fetch it "
            "manually and pass a local path")
    found = glob.glob(os.path.join("**", file), recursive=True)
    if not found:
        raise FileNotFoundError(f"file not found: {file}")
    if len(found) > 1:
        raise FileNotFoundError(f"multiple matches for {file}: {found}")
    return found[0]


def check_yaml(file, suffix=(".yaml", ".yml")):
    check_suffix(file, suffix)
    return check_file(file)


def print_args(name: str, opt):
    LOGGER.info("%s: %s", colorstr(name + ": "),
                ", ".join(f"{k}={v}" for k, v in vars(opt).items()))


def user_config_dir(dir_name: str = "desenet_tpu_torch",
                    env_var: str = "DESENET_CONFIG_DIR") -> Path:
    """A writable per-user config directory: ``$env_var`` where set, else
    ``~/.config/<dir_name>``; made if absent."""
    env = os.getenv(env_var)
    path = Path(env) if env else Path.home() / ".config" / dir_name
    path.mkdir(parents=True, exist_ok=True)
    return path


def apply_classifier(boxes_xyxy, classes, im0, classifier_fn, size=224):
    """Second-stage classifier filter: each detection box squared and
    padded (1.3x + 30 px), cropped from the BGR image ``im0`` (clipped to
    it), resized to ``size`` by cv2 and batched as RGB 0-1 float NHWC
    through ``classifier_fn`` (-> class scores). Returns the boolean mask
    of the detections whose classifier argmax agrees with ``classes``."""
    import cv2

    boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
    classes = np.asarray(classes).reshape(-1)
    if len(boxes) == 0:
        return np.ones(0, bool)
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    side = np.maximum(boxes[:, 2] - boxes[:, 0],
                      boxes[:, 3] - boxes[:, 1]) * 1.3 + 30
    h0, w0 = im0.shape[:2]
    x1 = np.clip((cx - side / 2).astype(int), 0, w0 - 1)
    y1 = np.clip((cy - side / 2).astype(int), 0, h0 - 1)
    x2 = np.clip((cx + side / 2).astype(int), 1, w0)
    y2 = np.clip((cy + side / 2).astype(int), 1, h0)
    ims = []
    for a1, b1, a2, b2 in zip(x1, y1, x2, y2):
        cut = im0[b1:max(b2, b1 + 1), a1:max(a2, a1 + 1)]
        im = cv2.resize(cut, (size, size))[:, :, ::-1]  # BGR -> RGB
        ims.append(np.ascontiguousarray(im, np.float32) / 255.0)
    pred_cls = np.asarray(classifier_fn(np.stack(ims))).argmax(1)
    return pred_cls == classes.astype(pred_cls.dtype)


def attempt_download(file, url: str = ""):
    """The local path of ``file``; this build is offline, so a missing file
    raises FileNotFoundError."""
    p = Path(str(file))
    if p.exists():
        return str(p)
    raise FileNotFoundError(
        f"{file} not found locally and downloads are disabled in this "
        f"offline build{' (wanted ' + url + ')' if url else ''}")


def print_mutation(results: dict, hyp: dict, save_dir: str):
    """Evolution bookkeeping: append the (results, hyp) row to
    ``save_dir/evolve.csv`` and write the best row's hyp to
    ``hyp_evolve.yaml`` (a ``#`` comment line, then JSON text)."""
    import csv

    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(save_dir, "evolve.csv")
    keys = list(results.keys()) + list(hyp.keys())
    vals = list(results.values()) + list(hyp.values())
    new = not os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(keys)
        w.writerow([f"{float(v):.5g}" for v in vals])
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    fit_key = "fitness" if "fitness" in results else keys[0]
    best = max(rows, key=lambda r: float(r[fit_key]))
    with open(os.path.join(save_dir, "hyp_evolve.yaml"), "w") as f:
        f.write(f"# best of {len(rows)} generations "
                f"({fit_key}={best[fit_key]})\n")
        json.dump({k: float(best[k]) for k in hyp}, f, indent=1)
