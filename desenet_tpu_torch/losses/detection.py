"""YOLO detection loss with fixed-capacity target assignment.

Counterpart of ``desenet_tpu/losses/detection.py`` (the reference
ComputeLoss, core/utils/loss.py:91-223): anchor-ratio assignment with
+-0.5-cell neighbour expansion, CIoU box loss, IoU-valued objectness BCE
with per-scale balance (``level_balance``, YOLOv5 v5.0's for any number
of levels), label-smoothed class BCE, total scaled by the batch size.

Every (target, anchor, neighbour offset) triple is a slot of a fixed-size
candidate set, B * M * na * 5 per scale, with a validity mask, as in the JAX
package. When two targets claim one (cell, anchor), the objectness target
is the larger IoU (``scatter_reduce_`` with ``amax``), not the last write.

With several processes (``parallel.multihost``) each holds its rows of the
global batch and returns its share of the global batch's loss: the
normalizers (each scale's valid-candidate count, the batch size of the
objectness mean and of the ``* B``) are summed over the processes, without
gradient, before dividing, so the shares add up to the loss of the global
batch, which is what the JAX package's single program computes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops.boxes import bbox_iou
from desenet_tpu_torch.parallel.multihost import global_sum
from desenet_tpu_torch.parallel.mesh import process_count


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Positive/negative label-smoothing targets (loss.py:13-15)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise torch BCEWithLogitsLoss (no reduction)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_bce_with_logits(logits, targets, gamma: float, alpha: float = 0.25,
                          pos_weight: float = 1.0):
    """FocalLoss wrapper around BCE, TF-style modulation (loss.py:35-62)."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def qfocal_bce_with_logits(logits, targets, gamma: float, alpha: float = 0.25,
                           pos_weight: float = 1.0):
    """Quality focal loss wrapper (loss.py:65-88)."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (targets - p).abs() ** gamma


def bce_blur_with_logits(logits, targets, alpha: float = 0.05):
    """Missing-label-tolerant BCE (loss.py:18-32). Returns the mean."""
    loss = bce_with_logits(logits, targets)
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


# candidate offsets: center, left, up, right, down (loss.py:179-182), x0.5
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def level_balance(nl: int) -> Tuple[float, ...]:
    """The objectness loss's weight of each of ``nl`` levels, as YOLOv5
    v5.0's ComputeLoss takes it: ``(4.0, 1.0, 0.4)`` at three, else the
    first ``nl`` of ``(4.0, 1.0, 0.25, 0.06, 0.02)`` (a P6 model's four).
    The JAX package holds the three-level tuple alone."""
    return (4.0, 1.0, 0.4) if nl == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)[:nl]


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """An f32 constant on ``device``, made once: building it from Python
    values on every call would copy to the card and wait for it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class DetectionLoss:
    """Functional ComputeLoss.

    anchors: (nl, na, 2) in grid units (pixel anchors / stride, as
    ``Detect.anchors_grid_units()`` gives them). ``balance``: a weight a
    level, ``level_balance(nl)`` when None."""

    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]
    nc: int
    box_gain: float = 0.05
    obj_gain: float = 0.7
    cls_gain: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    label_smoothing: float = 0.0
    fl_gamma: float = 0.0
    anchor_t: float = 4.0
    gr: float = 1.0
    balance: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.balance is None:
            object.__setattr__(self, "balance", level_balance(self.nl))
        if len(self.balance) != self.nl:
            raise ValueError(f"balance {self.balance} has not one weight "
                             f"for each of the {self.nl} levels")

    @property
    def nl(self):
        return len(self.anchors)

    @property
    def na(self):
        return len(self.anchors[0])

    def _bce(self, logits, targets, pos_weight):
        if self.fl_gamma > 0:
            return focal_bce_with_logits(logits, targets, self.fl_gamma,
                                         pos_weight=pos_weight)
        return bce_with_logits(logits, targets, pos_weight)

    def __call__(self, preds: Sequence[torch.Tensor], targets: torch.Tensor,
                 target_mask: torch.Tensor):
        """preds: per-scale (B, na, ny, nx, no) raw logits.
        targets: (B, M, 5) [cls, x, y, w, h] normalized; target_mask: (B, M).
        Returns (total, (lbox, lobj, lcls)) with total = sum * B
        (loss.py:166-168), each a 0-d f32 tensor; with several processes
        this process's share of them, B the global batch size."""
        B, M = targets.shape[:2]
        na = self.na
        dev = targets.device
        # the global batch size, and this process's share of it
        b_all, b_share = B, 1.0
        if process_count() > 1:
            b_all = global_sum(torch.full((), float(B), device=dev))
            b_share = B / b_all
        cp, cn = smooth_bce(self.label_smoothing)
        targets = targets.float()

        # flatten batch targets and attach image indices
        n_flat = B * M
        b_idx = torch.arange(B, device=dev).repeat_interleave(M)
        t_cls = targets[..., 0].reshape(-1)
        t_xywh = targets[..., 1:5].reshape(-1, 4)
        t_valid = target_mask.reshape(-1).bool()
        offs = _const(_OFFSETS, dev)
        K = n_flat * na * 5

        lbox = torch.zeros((), device=dev)
        lobj = torch.zeros((), device=dev)
        lcls = torch.zeros((), device=dev)
        g = 0.5
        for i, pi in enumerate(preds):
            pi = pi.float()
            _, _, ny, nx, no = pi.shape
            anchors_i = _const(self.anchors[i], dev)  # (na, 2)
            gain = _const((float(nx), float(ny)), dev)
            gxy = t_xywh[:, :2] * gain  # (N, 2)
            gwh = t_xywh[:, 2:] * gain

            # anchor-ratio filter (loss.py:192-195): (N, na)
            r = gwh[:, None, :] / anchors_i[None]
            ratio_ok = torch.maximum(r, 1.0 / r).amax(-1) < self.anchor_t
            ratio_ok &= t_valid[:, None]

            # neighbour conditions (loss.py:198-204): (N,)
            frac = gxy % 1.0
            inv = gain - gxy
            off_ok = torch.stack([
                torch.ones_like(t_valid),
                (frac[:, 0] < g) & (gxy[:, 0] > 1.0),
                (frac[:, 1] < g) & (gxy[:, 1] > 1.0),
                (inv[:, 0] % 1.0 < g) & (inv[:, 0] > 1.0),
                (inv[:, 1] % 1.0 < g) & (inv[:, 1] > 1.0),
            ], 1)  # (N, 5)

            # the full candidate grid (N, na, 5), flattened to K slots
            valid_f = (ratio_ok[:, :, None] & off_ok[:, None, :]).reshape(
                K).float()
            cand_xy = (gxy[:, None, None, :] - offs[None, None]).expand(
                n_flat, na, 5, 2)
            gij = torch.floor(cand_xy).long()
            gi = gij[..., 0].clamp(0, nx - 1).reshape(K)
            gj = gij[..., 1].clamp(0, ny - 1).reshape(K)
            a_idx = torch.arange(na, device=dev)[None, :, None].expand(
                n_flat, na, 5).reshape(K)
            bb = b_idx[:, None, None].expand(n_flat, na, 5).reshape(K)
            cc = t_cls[:, None, None].expand(n_flat, na, 5).reshape(K).long()

            # regression targets: xy relative to the assigned cell (loss.py:219)
            txy = (gxy[:, None, None, :].expand(n_flat, na, 5, 2).reshape(K, 2)
                   - torch.stack([gi, gj], -1).float())
            twh = gwh[:, None, None, :].expand(n_flat, na, 5, 2).reshape(K, 2)
            anc = anchors_i[a_idx]  # (K, 2)

            # predictions at the assigned cells
            flat_idx = ((bb * na + a_idx) * ny + gj) * nx + gi
            ps = pi.reshape(-1, no)[flat_idx]  # (K, no)
            pxy = torch.sigmoid(ps[:, :2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * anc
            iou = bbox_iou(torch.cat([pxy, pwh], -1), torch.cat([txy, twh], -1),
                           x1y1x2y2=False, CIoU=True)  # (K,)

            n_valid = global_sum(valid_f.sum()).clamp(min=1.0)
            lbox = lbox + ((1.0 - iou) * valid_f).sum() / n_valid

            # objectness target: deterministic scatter-max of the detached IoU
            score = iou.detach().clamp(min=0.0)
            score = (1.0 - self.gr) + self.gr * score
            score = torch.where(valid_f > 0, score, -1.0)
            tobj = torch.full((B * na * ny * nx,), -1.0, device=dev)
            tobj.scatter_reduce_(0, flat_idx, score, reduce="amax",
                                 include_self=True)
            tobj = tobj.clamp(min=0.0).reshape(B, na, ny, nx)
            obji = self._bce(pi[..., 4], tobj, self.obj_pw).mean() * b_share
            lobj = lobj + obji * self.balance[i]

            if self.nc > 1:
                # one-hot by comparison: a class id outside [0, nc) (an
                # invalid slot's padding) gives an all-negative row, as the
                # JAX scatter drops it
                hot = cc[:, None] == torch.arange(self.nc, device=dev)
                t = torch.where(hot, cp, cn)
                cls_l = self._bce(ps[:, 5:], t, self.cls_pw)  # (K, nc)
                lcls = lcls + (cls_l * valid_f[:, None]).sum() / (
                    n_valid * self.nc)

        lbox = lbox * self.box_gain
        lobj = lobj * self.obj_gain
        lcls = lcls * self.cls_gain
        return (lbox + lobj + lcls) * b_all, (lbox, lobj, lcls)
