"""Training loggers: console, results.csv and TensorBoard where
``torch.utils.tensorboard`` imports.

The port's own copy of ``desenet_tpu/utils/loggers.py``: the same
``results.csv`` columns, registered on the callback hooks through
``Callbacks.auto_register``.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict

LOGGER = logging.getLogger("desenet_tpu_torch")

CSV_KEYS = [
    "epoch",
    "train/box_loss",
    "train/obj_loss",
    "train/cls_loss",
    "train/seg_loss",
    "metrics/precision",
    "metrics/recall",
    "metrics/mAP_0.5",
    "metrics/mAP_0.5:0.95",
    "metrics/mIoU",
    "metrics/pixAcc",
    "val/fitness",
    "x/lr",
]


class Loggers:
    def __init__(self, save_dir: str, use_tb: bool = True):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.csv_path = os.path.join(save_dir, "results.csv")
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                LOGGER.info("TensorBoard unavailable - csv/console only")
            else:
                self.tb = SummaryWriter(os.path.join(save_dir, "tb"))

    def log_row(self, row: Dict[str, float]):
        new = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_KEYS)
            if new:
                w.writeheader()
            w.writerow({k: row.get(k, "") for k in CSV_KEYS})
        if self.tb is not None:
            step = int(row.get("epoch", 0))
            for k, v in row.items():
                if k != "epoch" and v != "":
                    self.tb.add_scalar(k, float(v), step)

    # callback-hook methods (picked up by Callbacks.auto_register)
    def on_fit_epoch_end(self, row: Dict[str, float]):
        self.log_row(row)

    def on_train_end(self, *a, **k):
        if self.tb is not None:
            self.tb.flush()

    def teardown(self, *a, **k):
        if self.tb is not None:
            self.tb.close()
