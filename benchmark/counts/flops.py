"""Model FLOPs for ``mfu``, counted on the plain reference
(``reference/desenet.py``), never on the program: a change that folds BN
or swaps the stem must not move its own yardstick.

``FlopCounterMode`` over the reference's forward of one image of the
cell's size on the meta device: convolutions and matmuls at 2 FLOPs a
multiply-add, nothing else. Training counts three forwards (forward,
and the backward's two products a conv); recomputed work is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.desenet import forward, param_specs


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of the reference's forward of one (h, w) image."""
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev) for n, s, _, _ in param_specs(cfg)}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        forward(cfg, P, torch.empty((1, 3, h, w), device=dev))
    return float(counter.get_total_flops())


def train_flops(cfg: dict, h: int, w: int) -> float:
    return 3.0 * forward_flops(cfg, h, w)
