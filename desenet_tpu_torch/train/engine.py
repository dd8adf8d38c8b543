"""The training engine's set-up of the loss and the schedule.

Counterpart of the first piece of ``desenet_tpu/train/engine.py``: the
hyperparameters (``configs/hyp_scratch.json``, the JAX package's
``configs/hyp_scratch.yaml`` as JSON) and the loss-gain and LR-schedule
set-up of ``engine.py:366-394``. The epoch loop, data and checkpoints are
not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Tuple

from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models.heads import anchors_grid_units
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.train.schedule import linear_lr as _linear_lr
from desenet_tpu_torch.train.schedule import one_cycle

HYP_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "hyp_scratch.json")


def load_hyp() -> Dict:
    """The recipe's hyperparameters (``configs/hyp_scratch.json``)."""
    with open(HYP_PATH, encoding="utf-8") as fh:
        return json.load(fh)


def loss_and_schedule(hyp: Dict, spec, imgsz: int, epochs: int,
                      linear_lr: bool = False, adam: bool = False,
                      label_smoothing: float = 0.0
                      ) -> Tuple[DetectionLoss, OptimConfig, Callable]:
    """(DetectionLoss, OptimConfig, lf) for ``spec`` at ``imgsz``, with the
    loss gains scaled as train.py:258-260 scales them."""
    nl = len(spec.det_strides)
    anchors = anchors_grid_units(spec.layers[spec.det_layer].args[1],
                                 spec.det_strides)
    det_loss = DetectionLoss(
        anchors=tuple(tuple(tuple(float(v) for v in a) for a in s)
                      for s in anchors),
        nc=spec.de_nc,
        box_gain=hyp["box"] * 3.0 / nl,
        obj_gain=hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl,
        cls_gain=hyp["cls"] * spec.de_nc / 80.0 * 3.0 / nl,
        cls_pw=hyp["cls_pw"], obj_pw=hyp["obj_pw"],
        label_smoothing=label_smoothing, fl_gamma=hyp["fl_gamma"],
        anchor_t=hyp["anchor_t"],
    )
    opt_cfg = OptimConfig(
        optimizer="adam" if adam else "sgd",
        lr0=hyp["lr0"], momentum=hyp["momentum"],
        weight_decay=hyp["weight_decay"],
        warmup_bias_lr=hyp["warmup_bias_lr"],
        warmup_momentum=hyp["warmup_momentum"],
    )
    lf = (_linear_lr(hyp["lrf"], epochs) if linear_lr
          else one_cycle(1.0, hyp["lrf"], epochs))
    return det_loss, opt_cfg, lf
