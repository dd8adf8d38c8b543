"""Model ensembles: every member's decoded predictions concatenated on the
anchor axis for one joint NMS pass, its seg logits averaged.

The port's copy of ``desenet_tpu/eval/ensemble.py``. The members are
modules holding their weights, so ``EnsembleModel`` is an ``nn.Module``
that ``Validator``, TTA and the detect program take as they take one model.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn


def load_ensemble(weights: Sequence[str], cfg=None, nc=None, se_nc=None,
                  half: bool = True, device="cuda", **build_kw) -> List:
    """Load each of ``weights`` (a checkpoint directory of the port, whose
    meta.json names its config and class counts, or an npz state dict of
    ``cfg`` with ``nc``/``se_nc``) as ``cli.val.load_model`` does ->
    [(model, spec), ...]. The members must agree on de_nc and se_nc: the
    joint NMS pass and the seg mean need one class space. ``build_kw``
    goes to ``build_model`` (``seg_upsample=False`` for the detect
    program's 1/8-resolution seg tail)."""
    from desenet_tpu_torch.cli.val import load_model

    members = [load_model(cfg, w, nc, se_nc, half, device, **build_kw)
               for w in weights]
    for key in ("de_nc", "se_nc"):
        vals = {getattr(spec, key) for _, spec in members}
        if len(vals) != 1:
            raise ValueError(f"ensemble members disagree on {key}: {vals}")
    return members


class EnsembleModel(nn.Module):
    """Several models as one: ``forward(x)`` returns ((the members'
    decodes concatenated on the anchor axis, None), their seg logits
    averaged in f32). ``spec`` is the member's with the largest stride.
    Inference only."""

    def __init__(self, models: Sequence[nn.Module]):
        super().__init__()
        if not models:
            raise ValueError("empty ensemble")
        self.members = nn.ModuleList(models)
        self.spec = max((m.spec for m in models),
                        key=lambda s: max(s.det_strides))
        self.eval()

    def forward(self, x: torch.Tensor):
        if self.training:
            raise RuntimeError("EnsembleModel is inference-only")
        decs, segs = [], []
        for m in self.members:
            (dec, _), seg = m(x)
            decs.append(torch.cat(list(dec), 1)
                        if isinstance(dec, (list, tuple)) else dec)
            segs.append(seg.float())
        return (torch.cat(decs, 1), None), sum(segs) / len(segs)


@torch.inference_mode()
def ensemble_forward(models: Sequence[nn.Module], x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every member on ``x``: (decodes concatenated (B, sum A, 5+nc), seg
    logits averaged in f32)."""
    (dec, _), seg = EnsembleModel(models)(x)
    return dec, seg
