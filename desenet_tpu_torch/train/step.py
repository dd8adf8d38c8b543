"""The joint training step.

Counterpart of ``desenet_tpu/train/step.py``: forward in training mode (BN
on batch statistics), the combined loss ``det_gain * ComputeLoss * bs +
seg_gain * CE`` with one backward (the reference's two backward passes,
train.py:362-367, as one), gradient accumulation with the
warmup-interpolated trigger (train.py:146-147, 332-340, 370-376), the
3-group SGD/Adam update and the EMA.

Eager PyTorch on the model's device. The counters are host integers, so
whether a batch ends in an optimizer step is decided on the host, and the
update and the EMA run only then (the JAX step computes both and selects).
The JAX step's compiler options (the latency-hiding scheduler gate),
buffer donation and ``remat_convs`` schedule a TPU program and are not
ported.

With several processes (``parallel.multihost``) each takes its rows of the
global batch; the BN statistics and the losses' normalizers are the global
batch's (``layers.BatchNorm2d``, ``losses``), so each process's loss is its
share of the global batch's and the gradient of that loss is the sum of
theirs: the gradients are summed over the processes (not averaged) before
the update, and every process applies the same update. The reference's
seg loss times WORLD_SIZE is not copied, as in the JAX step.

On a ``(data, spatial)`` mesh (``make_train_step(mesh=...)``, the JAX
engine's ``--spatial``) each process holds its data row's images and
feeds the model its height band of them (``parallel.mesh.spatial_band``)
under ``parallel.spatial.scope``; the model's outputs come back whole on
every rank of the spatial group, so each computes the whole loss of its
data row's images against whole labels, with the normalizers summed over
the data axis only (each image once). The spatial group's ranks thus hold
``spatial`` copies of that loss, and ``gather_rows``' backward adds their
gradients: the backward takes ``loss / spatial``, so that the gradients
summed over all the processes are the global batch's. BN sums its
statistics over all of them (bands of a group add up to its images).

With tracing on (``utils/profiling``), a step records ``train.step``
around ``train.forward``, ``train.loss`` (``train.loss.det``,
``train.loss.seg``), ``train.backward`` and, when it updates,
``train.update`` (the gradient sum, the optimizer and the frozen rows'
restore) and ``train.ema``.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from desenet_tpu_torch.losses import DetectionLoss, segmentation_loss
from desenet_tpu_torch.models.build import (mask_coefficients,
                                            require_seg_head)
from desenet_tpu_torch.models.layers import Dropout
from desenet_tpu_torch.ops.seg_ce import upsampled_ce
from desenet_tpu_torch.parallel import spatial
from desenet_tpu_torch.parallel.mesh import Mesh, process_count, spatial_band
from desenet_tpu_torch.parallel.multihost import global_sum, sum_gradients
from desenet_tpu_torch.train import optim as O
from desenet_tpu_torch.train.ema import ema_update
from desenet_tpu_torch.train.schedule import warmup_interp
from desenet_tpu_torch.train.state import TrainState, bn_stats
from desenet_tpu_torch.utils.profiling import span


def frozen_names(names, freeze: int):
    """Parameters of the first ``freeze`` DSL rows (``model.{i}.``), as the
    reference's requires_grad=False loop picks them (train.py:137-143)."""
    out = []
    for name in names:
        m = re.match(r"model\.(\d+)\.", name)
        if m is not None and int(m.group(1)) < freeze:
            out.append(name)
    return out


def make_train_step(
    model: torch.nn.Module,
    det_loss_fn: DetectionLoss,
    opt_cfg: O.OptimConfig,
    lf: Callable,  # epoch -> lr scale (one_cycle / linear_lr)
    nb: int,  # batches per epoch
    warmup_iters: int,  # nw = max(3 epochs * nb, 1000) (train.py:287)
    nominal_bs: int = 64,
    batch_size: int = 16,
    det_gain: float = 0.14,
    seg_gain: float = 1.0,
    seg_aux_weight: float = 0.1,
    ema_base: float = 0.9999,
    ema_tau: float = 2000.0,
    freeze: int = 0,
    fused_seg: bool = False,
    dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)`` for ``model`` (the state's model, in training mode).

    ``batch`` is a dict of tensors (or arrays) on any device:
      image       (B, H, W, 3) uint8, or float in [0, 1]
      det_targets (B, M, 5), det_mask (B, M)
      seg_labels  (B, H, W) integer class ids, uint8 or wider

    ``fused_seg``: the model was built with ``seg_upsample=False``; its 1/8
    logits go to ``upsampled_ce``, as the JAX step does when the seg output
    is smaller than the labels. ``dtype``: the compute dtype; for bf16 the
    forward runs under ``torch.autocast`` and the parameters, gradients,
    buffers and EMA stay f32 (flax's ``param_dtype=f32, dtype=bf16``).
    ``freeze`` sets requires_grad False on the first ``freeze`` rows'
    parameters; they take no gradient and keep their values, while their
    optimizer buffers and EMA still move as in the JAX step. ``generator``
    takes the place of the JAX step's dropout key: the model's
    ``layers.Dropout`` modules (the BiSe and Base seg heads) draw their
    masks from it, or from the device's default generator when it is None.

    ``batch_size`` and ``nominal_bs`` are global: with several processes
    ``batch`` is this process's rows of a global batch of ``batch_size``
    (its data rank's rows, whole, on a spatial ``mesh``: the step cuts the
    image's band of this rank).

    ``metrics``: ``loss, lbox, lobj, lcls, lseg`` (0-d tensors on the
    device, the global batch's), ``lr`` (float) and ``stepped`` (0 or 1)."""
    require_seg_head(model.spec, "make_train_step")
    if mask_coefficients(model.spec):
        raise NotImplementedError(
            "make_train_step: a Segment model (YOLOv5 v7.0 instance "
            "segmentation) has no training step in the port: its mask loss "
            "(BCE over overlap masks) is not written (ROADMAP.md, Queue 6)")
    if fused_seg == bool(model.seg_upsample):
        raise ValueError(
            f"fused_seg={fused_seg} needs a model built with "
            f"seg_upsample={not fused_seg}")
    accum_target = nominal_bs / batch_size
    always_step = accum_target <= 1.0
    frozen = frozen_names(dict(model.named_parameters()), freeze)
    for name in frozen:
        model.get_parameter(name).requires_grad_(False)
    compute_cast = dtype in (torch.bfloat16, torch.float16)
    dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
    sp = mesh.spatial if mesh is not None else 1
    max_stride = int(max(model.spec.det_strides))

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        with span("train.step"):
            return _step(state, batch, generator)

    def _step(state: TrainState, batch: Dict,
              generator: Optional[torch.Generator]):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        ni = state.step
        dev = next(iter(state.params.values())).device
        imgs = torch.as_tensor(batch["image"], device=dev)
        height = imgs.shape[1]
        if sp > 1:  # this rank's height band of its data row's images
            imgs = spatial_band({"image": imgs}, mesh, max_stride)["image"]
        x = imgs.to(dtype)
        if imgs.dtype == torch.uint8:
            x = x / 255.0
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
        for m in dropouts:
            m.generator = generator
        band = (spatial.scope(mesh, height, max_stride) if sp > 1
                else contextlib.nullcontext())
        with band:
            with span("train.forward"), torch.autocast(
                    dev.type, dtype=dtype, enabled=compute_cast):
                det_feats, seg_out = model(x)
            with span("train.loss"):
                with span("train.loss.det"):
                    det_total, comps = det_loss_fn(
                        det_feats,
                        torch.as_tensor(batch["det_targets"], device=dev),
                        torch.as_tensor(batch["det_mask"], device=dev))
                with span("train.loss.seg"):
                    seg_lab = torch.as_tensor(batch["seg_labels"],
                                              device=dev).to(torch.int32)
                    if (not isinstance(seg_out, (list, tuple))
                            and seg_out.shape[2:] != seg_lab.shape[1:]):
                        # 1/8 logits: CE against their 8x align_corners
                        # upsample, tiled
                        seg_l = upsampled_ce(seg_out, seg_lab,
                                             seg_lab.shape[1:],
                                             align_corners=True)
                    else:
                        seg_l = segmentation_loss(seg_out, seg_lab,
                                                  aux_weight=seg_aux_weight)
                loss = det_gain * det_total + seg_gain * seg_l
            # accumulates into .grad; the spatial group's copies of the
            # loss add up to one in the summed gradients
            with span("train.backward"):
                (loss / sp if sp > 1 else loss).backward()
            losses = (loss, *comps, seg_l)
            if process_count() > 1:  # the shares of the processes, added
                losses = global_sum(torch.stack([v.detach()
                                                 for v in losses]))

        # warmup-interpolated accumulation count (train.py:334)
        ni32 = np.float32(ni)
        accumulate = int(max(np.round(warmup_interp(
            ni32, np.float32(warmup_iters), 1.0, accum_target)), 1.0))
        do_step = always_step or (ni - state.last_opt_step) >= accumulate
        lr_scale = lf(np.float32(ni // nb))
        warmup_t = np.clip(ni32 / np.float32(max(warmup_iters, 1)), 0.0, 1.0)

        if do_step:
            with span("train.update"), torch.no_grad():
                sum_gradients([p.grad for p in state.params.values()
                               if p.grad is not None])
                pinned = [state.params[k].clone() for k in frozen]
                O.apply_updates(state.params,
                                {k: p.grad for k, p in state.params.items()},
                                state.opt_state, state.groups, opt_cfg,
                                lr_scale, warmup_t)
                for k, v in zip(frozen, pinned):
                    state.params[k].copy_(v)
            state.ema_updates += 1
            with span("train.ema"):
                ema_update(state.ema, {**state.params, **bn_stats(model)},
                           state.ema_updates, ema_base, ema_tau)
            for p in state.params.values():
                p.grad = None
            state.last_opt_step = ni
        state.step = ni + 1
        metrics = {
            "loss": losses[0].detach(),
            "lbox": losses[1].detach(),
            "lobj": losses[2].detach(),
            "lcls": losses[3].detach(),
            "lseg": losses[4].detach(),
            "lr": float(opt_cfg.lr0 * lr_scale * warmup_t),
            "stepped": int(do_step),
        }
        return state, metrics

    return train_step
