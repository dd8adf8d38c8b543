"""Training state and its constructor.

Counterpart of ``desenet_tpu/train/state.py``. The model holds the
parameters and the BN running statistics; the state holds what the step
needs beside them. Gradients accumulate in the parameters' ``.grad``
between optimizer steps (the JAX state's ``accum_grads``). The counters are
host integers, so the step decides on the host whether to take an
optimizer step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from desenet_tpu_torch.train import optim as O

_STATS = ("running_mean", "running_var")


def trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's parameters that the optimizer sees: all but those of the
    BNs that never run (their conv's input is 1x1; the JAX package has no
    variables for them)."""
    quirk = set(getattr(model, "quirk_bn_keys", list)())
    return {k: p for k, p in model.named_parameters() if k not in quirk}


def bn_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running means and variances of the BNs that run."""
    quirk = set(getattr(model, "quirk_bn_keys", list)())
    return {k: b for k, b in model.named_buffers()
            if k.endswith(_STATS) and k not in quirk}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    params: Dict[str, nn.Parameter]  # trainable(model)
    groups: Dict[str, int]  # optim group tag per parameter
    opt_state: dict  # optim.init_opt_state's buffers
    ema: Dict[str, torch.Tensor]  # f32 copies of params and BN stats
    ema_updates: int = 0  # optimizer steps taken (the EMA decay's input)
    step: int = 0  # integrated batches ni (train.py:330)
    last_opt_step: int = -1  # for the accumulation trigger


def create_train_state(model: nn.Module, opt_cfg: O.OptimConfig) -> TrainState:
    """The state of a model in training mode, built once the model is on
    its device (every buffer is made beside its parameter)."""
    params = trainable(model)
    ema = {k: t.detach().float().clone()
           for k, t in {**params, **bn_stats(model)}.items()}
    return TrainState(model=model, params=params,
                      groups=O.build_groups(model, params),
                      opt_state=O.init_opt_state(params, opt_cfg), ema=ema)
