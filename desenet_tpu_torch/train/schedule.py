"""LR schedules: one-cycle cosine (general.py:421-423), linear
(train.py:173), and the warmup interpolation (train.py:332-340).

Counterpart of ``desenet_tpu/train/schedule.py``. The step counts live on
the host, so these are numpy scalar functions; given ``np.float32`` inputs
they compute in f32, as the JAX functions do inside the jitted step.
"""

from __future__ import annotations

import numpy as np


def one_cycle(y1: float = 1.0, y2: float = 1.0, steps: int = 100):
    """lambda(epoch) = y1 -> y2 over ``steps`` epochs along a half cosine."""

    def f(x):
        return ((1 - np.cos(x * np.pi / steps)) / 2) * (y2 - y1) + y1

    return f


def linear_lr(lrf: float, epochs: int):
    """lambda(epoch) linear decay to lrf (train.py:173)."""

    def f(x):
        return (1 - x / (epochs - 1)) * (1.0 - lrf) + lrf

    return f


def warmup_interp(ni, nw, x0, x1):
    """np.interp(ni, [0, nw], [x0, x1]) clamped: the warmup ramp."""
    t = np.clip(ni / np.maximum(nw, 1), 0.0, 1.0)
    return x0 + (x1 - x0) * t
