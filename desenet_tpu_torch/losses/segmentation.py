"""Segmentation losses.

Counterpart of ``desenet_tpu/losses/segmentation.py`` (the reference
SegmentationLosses, core/utils/loss.py:227-282): mean pixel cross-entropy
with ``ignore_index`` and an optional class weight, and the aux-output
combinations of the BiSe head. Logits are NCHW here (the JAX functions
take NHWC). With several processes the CE's denominator (the valid pixels,
or their class weights) is summed over the processes before dividing, so
each returns its share of the global batch's mean.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from desenet_tpu_torch.parallel.multihost import global_sum


def _ce(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1,
        class_weight=None) -> torch.Tensor:
    """Mean pixel cross-entropy. logits (B, C, H, W); labels (B, H, W) int.

    The class pick is a comparison-masked sum over the class axis, as in
    the JAX package (ignored pixels drop out of the mean)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, 1)
    c = logits.shape[1]
    onehot = safe[:, None] == torch.arange(
        c, dtype=safe.dtype, device=safe.device)[:, None, None]
    nll = -torch.where(onehot, logp, 0.0).sum(1)
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=logits.device)[:, None, None]
        w = torch.where(onehot, cw, 0.0).sum(1)
        nll = nll * w
        denom = global_sum(torch.where(valid, w, 0.0).sum())
    else:
        denom = global_sum(valid.sum()).clamp(min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def segmentation_loss(
    preds: Union[torch.Tensor, Sequence[torch.Tensor]],
    labels: torch.Tensor,
    aux_weight: float = 0.1,
    ignore_index: int = -1,
    class_weight=None,
) -> torch.Tensor:
    """Dispatch on the aux count (loss.py:241-256):
      1 output  -> plain CE (PSP/PSP2/Lab/Base heads)
      2 outputs -> main + aux_weight * aux
      3 outputs -> main + 1.5*aux_weight * aux16 + 0.5*aux_weight * aux32
    """
    if not isinstance(preds, (list, tuple)):
        return _ce(preds, labels, ignore_index, class_weight)
    ce = [_ce(p, labels, ignore_index, class_weight) for p in preds]
    if len(ce) == 1:
        return ce[0]
    if len(ce) == 2:
        return ce[0] + aux_weight * ce[1]
    if len(ce) == 3:
        return ce[0] + aux_weight * 1.5 * ce[1] + aux_weight / 2.0 * ce[2]
    raise ValueError(f"unsupported aux count {len(preds)}")
