"""Model EMA with the reference ModelEMA's semantics (torch_utils.py:304-342).

Counterpart of ``desenet_tpu/train/ema.py``:
decay(updates) = base * (1 - exp(-updates / tau)), base 0.9999, tau 2000;
ema <- d * ema + (1 - d) * value, over the parameters and the BN running
mean and variance (not ``num_batches_tracked``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def ema_decay(updates, base: float = 0.9999, tau: float = 2000.0):
    """The decay after ``updates`` optimizer steps, in f32."""
    return base * (1.0 - np.exp(-np.float32(updates) / tau))


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor],
               values: Mapping[str, torch.Tensor], updates,
               base: float = 0.9999, tau: float = 2000.0) -> None:
    """One EMA step in place (after each optimizer step, with the post-step
    values); ``values`` has ``ema``'s keys."""
    d = ema_decay(updates, base, tau)
    names = list(ema)
    es = [ema[k] for k in names]
    torch._foreach_mul_(es, float(d))
    torch._foreach_add_(es, [values[k].float() for k in names],
                        alpha=float(1.0 - d))
