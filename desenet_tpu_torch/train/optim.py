"""Optimizer with the reference recipe's semantics.

Counterpart of ``desenet_tpu/train/optim.py``. The reference builds three
parameter groups (train.py:151-168):
  BN_WEIGHT: BatchNorm weights (gamma)   no weight decay
  WEIGHT:    conv/linear weights         weight decay
  BIAS:      biases (incl. BN beta)      no weight decay, warmup-bias LR

and uses SGD(nesterov, momentum) or Adam(betas=(momentum, 0.999)). During
warmup the bias group's LR ramps warmup_bias_lr -> lr, the others 0 -> lr,
and the momentum warmup_momentum -> momentum, per step. Weight decay enters
the gradient before the momentum (torch.optim's non-decoupled form).

Parameters, gradients and buffers are dicts keyed by state-dict name; the
update runs in place with ``torch._foreach_*`` ops, one list per group. The
per-step scalars are computed on the host in f32, as the JAX step computes
them on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

# param-group tags
BN_WEIGHT, WEIGHT, BIAS = 0, 1, 2


def group_label(module: nn.Module, leaf: str) -> int:
    """The reference's .bias / BN .weight / other .weight split, from the
    owning module's type and the parameter's name (the JAX leaves: 'scale',
    'bias', 'kernel')."""
    if leaf == "bias":
        return BIAS
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return BN_WEIGHT
    return WEIGHT


def build_groups(model: nn.Module, names: Iterable[str]) -> Dict[str, int]:
    """Group tag of each named parameter of ``model``."""
    out = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        out[name] = group_label(model.get_submodule(owner), leaf)
    return out


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr0: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    nesterov: bool = True
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptimConfig) -> dict:
    """Zero buffers beside each (f32) parameter: ``mu`` (momentum / Adam's
    first moment), for Adam also ``nu`` and the step ``count``."""
    def zeros():
        return {k: torch.zeros_like(p) for k, p in params.items()}

    state = {"mu": zeros()}
    if cfg.optimizer == "adam":
        state["nu"] = zeros()
        state["count"] = 0
    return state


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, Optional[torch.Tensor]],
                  opt_state: dict, groups: Mapping[str, int],
                  cfg: OptimConfig, lr_scale, warmup_t) -> dict:
    """One optimizer step, in place on ``params`` and the buffers of
    ``opt_state``; returns ``opt_state`` (Adam's count advanced).

    ``lr_scale`` is lf(epoch), ``warmup_t`` the warmup progress in [0, 1]
    (np.float32 scalars). A gradient that is None counts as zero."""
    lr_main = cfg.lr0 * lr_scale
    lr_bias_w = cfg.warmup_bias_lr + (lr_main - cfg.warmup_bias_lr) * warmup_t
    lr_other_w = lr_main * warmup_t
    mom = cfg.warmup_momentum + (cfg.momentum - cfg.warmup_momentum) * warmup_t
    adam = cfg.optimizer == "adam"
    if adam:
        count = opt_state["count"] + 1
        b1, b2 = cfg.momentum, cfg.adam_beta2
        bc1 = 1 - b1 ** np.float32(count)
        bc2 = 1 - b2 ** np.float32(count)
        opt_state["count"] = count

    for tag in (BN_WEIGHT, WEIGHT, BIAS):
        names = [k for k, t in groups.items() if t == tag]
        if not names:
            continue
        ps = [params[k] for k in names]
        # gradients are f32 values, as in the JAX step (``g.astype(f32)``)
        gs = [torch.zeros_like(p) if grads[k] is None
              else grads[k].float().to(p.dtype) for k, p in zip(names, ps)]
        if tag == WEIGHT:
            gs = torch._foreach_add(gs, ps, alpha=cfg.weight_decay)
        lr = float(lr_bias_w if tag == BIAS else lr_other_w)
        ms = [opt_state["mu"][k] for k in names]
        if not adam:
            torch._foreach_mul_(ms, float(mom))
            torch._foreach_add_(ms, gs)
            d = (torch._foreach_add(gs, ms, alpha=float(mom)) if cfg.nesterov
                 else ms)
            torch._foreach_add_(ps, d, alpha=-lr)
            continue
        vs = [opt_state["nu"][k] for k in names]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        den = torch._foreach_div(vs, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.adam_eps)
        step = torch._foreach_div(ms, float(bc1))
        torch._foreach_div_(step, den)
        torch._foreach_add_(ps, step, alpha=-lr)
    return opt_state
