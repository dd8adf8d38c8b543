"""The plain reference of the joint training step, in float32.

The reference recipe's loss and update as plain PyTorch over a dict of
weights (``desenet.forward`` in training mode): the detection loss
(YOLOv5's ComputeLoss: anchor-ratio assignment with the +-0.5-cell
neighbours, CIoU box loss, objectness BCE against the IoU, class BCE,
``(lbox + lobj + lcls) * B``), the seg loss (pixel cross-entropy of the 8x
align_corners upsample of the 1/8 logits), ``det_gain * det + seg_gain *
seg``, autograd, and SGD with Nesterov momentum over three groups (BN
weights, other weights with weight decay, biases) with the warmup ramps of
the learning rates and the momentum. The detection loss is a frozen copy
of the program's fixed-capacity form (``losses/detection.py``, with the
objectness target the larger IoU where two targets claim a cell), without
its multi-process normalizers.

``steps(cfg, weights, batches, hyp)`` takes ``len(batches)`` steps from
``weights`` and returns each step's loss, the gradient as the optimizer
got it at the first step (its momentum buffer after that step), and every
weight's change after the last.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.desenet import Training, forward, param_specs, rows

_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))
BN_WEIGHT, WEIGHT, BIAS = 0, 1, 2


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7):
    """Elementwise CIoU of (..., 4) xywh boxes (alpha without gradient)."""
    b1x1, b1x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
    b1y1, b1y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
    b2y1, b2y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             .clamp(min=0) * (torch.minimum(b1y2, b2y2)
                              - torch.maximum(b1y1, b2y1)).clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def _bce(logits, targets):
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def detection_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor,
                   mask: torch.Tensor, anchors, nc: int, gains: dict):
    """preds: per-scale (B, na, ny, nx, 5 + nc) raw maps; targets (B, M, 5)
    [cls, x, y, w, h] normalized; mask (B, M); anchors (nl, na, 2) in grid
    units. Returns ``(lbox + lobj + lcls) * B``."""
    B, M = targets.shape[:2]
    na = len(anchors[0])
    dev = targets.device
    n = B * M
    b_idx = torch.arange(B, device=dev).repeat_interleave(M)
    t_cls = targets[..., 0].reshape(-1)
    t_xywh = targets[..., 1:5].reshape(-1, 4)
    t_valid = mask.reshape(-1).bool()
    offs = torch.tensor(_OFFSETS, device=dev)
    K = n * na * 5
    lbox = lobj = lcls = torch.zeros((), device=dev)
    for i, pi in enumerate(preds):
        pi = pi.float()
        _, _, ny, nx, no = pi.shape
        anc_i = torch.tensor(anchors[i], dtype=torch.float32, device=dev)
        gain = torch.tensor((float(nx), float(ny)), device=dev)
        gxy, gwh = t_xywh[:, :2] * gain, t_xywh[:, 2:] * gain
        r = gwh[:, None, :] / anc_i[None]
        ratio_ok = (torch.maximum(r, 1.0 / r).amax(-1) < gains["anchor_t"]) \
            & t_valid[:, None]
        frac, inv = gxy % 1.0, gain - gxy
        off_ok = torch.stack([
            torch.ones_like(t_valid),
            (frac[:, 0] < 0.5) & (gxy[:, 0] > 1.0),
            (frac[:, 1] < 0.5) & (gxy[:, 1] > 1.0),
            (inv[:, 0] % 1.0 < 0.5) & (inv[:, 0] > 1.0),
            (inv[:, 1] % 1.0 < 0.5) & (inv[:, 1] > 1.0)], 1)
        valid = (ratio_ok[:, :, None] & off_ok[:, None, :]).reshape(K).float()
        cxy = (gxy[:, None, None, :] - offs[None, None]).expand(n, na, 5, 2)
        gij = torch.floor(cxy).long()
        gi = gij[..., 0].clamp(0, nx - 1).reshape(K)
        gj = gij[..., 1].clamp(0, ny - 1).reshape(K)
        a_idx = torch.arange(na, device=dev)[None, :, None].expand(
            n, na, 5).reshape(K)
        bb = b_idx[:, None, None].expand(n, na, 5).reshape(K)
        cc = t_cls[:, None, None].expand(n, na, 5).reshape(K).long()
        txy = (gxy[:, None, None, :].expand(n, na, 5, 2).reshape(K, 2)
               - torch.stack([gi, gj], -1).float())
        twh = gwh[:, None, None, :].expand(n, na, 5, 2).reshape(K, 2)
        flat = ((bb * na + a_idx) * ny + gj) * nx + gi
        ps = pi.reshape(-1, no)[flat]
        pxy = torch.sigmoid(ps[:, :2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * anc_i[a_idx]
        iou = ciou(torch.cat([pxy, pwh], -1), torch.cat([txy, twh], -1))
        n_valid = valid.sum().clamp(min=1.0)
        lbox = lbox + ((1.0 - iou) * valid).sum() / n_valid
        score = torch.where(valid > 0, iou.detach().clamp(min=0.0), -1.0)
        tobj = torch.full((B * na * ny * nx,), -1.0, device=dev)
        tobj.scatter_reduce_(0, flat, score, reduce="amax", include_self=True)
        tobj = tobj.clamp(min=0.0).reshape(B, na, ny, nx)
        lobj = lobj + _bce(pi[..., 4], tobj).mean() * gains["balance"][i]
        if nc > 1:
            t = (cc[:, None] == torch.arange(nc, device=dev)).float()
            lcls = lcls + (_bce(ps[:, 5:], t) * valid[:, None]).sum() / (
                n_valid * nc)
    return (lbox * gains["box"] + lobj * gains["obj"]
            + lcls * gains["cls"]) * B


def seg_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean pixel cross-entropy of the align_corners bilinear upsample of
    the 1/8 logits to the labels' size."""
    up = F.interpolate(logits.float(), size=tuple(labels.shape[1:]),
                       mode="bilinear", align_corners=True)
    return F.cross_entropy(up, labels.long())


def loss_gains(cfg: dict, hyp: dict, imgsz: int) -> dict:
    """The recipe's loss gains at this config and size (train.py:258-260)."""
    nl = len(cfg["anchors"])
    nc = int(cfg["de_nc"])
    return {"box": hyp["box"] * 3.0 / nl,
            "obj": hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl,
            "cls": hyp["cls"] * nc / 80.0 * 3.0 / nl,
            "anchor_t": hyp["anchor_t"], "balance": (4.0, 1.0, 0.4)}


def groups(cfg: dict) -> Dict[str, int]:
    out = {}
    for name, _, kind, _ in param_specs(cfg):
        if kind in ("bn_running_mean", "bn_running_var"):
            continue
        out[name] = (BN_WEIGHT if kind == "bn_weight" else
                     WEIGHT if kind == "conv" else BIAS)
    return out


def steps(cfg: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
          hyp: dict, store=None) -> dict:
    """``len(batches)`` steps from ``weights`` (not changed). ``store``: a
    float8 dtype every block's output is rounded to (the control).
    Returns ``{"loss": [...], "grad": {name: first gradient},
    "change": {name: change after the last step}}``, for the weights that
    take a gradient."""
    dev = next(iter(weights.values())).device
    tags = groups(cfg)
    P = Training({k: v.detach().float().clone() for k, v in weights.items()})
    P.store = store
    for k in tags:
        P[k].requires_grad_(True)
    start = {k: P[k].detach().clone() for k in tags}
    mu = {k: torch.zeros_like(P[k]) for k in tags}
    gains = loss_gains(cfg, hyp, int(batches[0]["image"].shape[1]))
    strides = next(r["strides"] for r in rows(cfg) if r["name"] == "Detect")
    anchors = [np.asarray(a, np.float64).reshape(-1, 2) / s
               for a, s in zip(cfg["anchors"], strides)]
    anchors = [[tuple(float(v) for v in row) for row in a] for a in anchors]
    out = {"loss": []}
    for ni, batch in enumerate(batches):
        x = batch["image"].permute(0, 3, 1, 2).float() / 255.0
        det, seg = forward(cfg, P, x)
        loss = (hyp["det_gain"] * detection_loss(
            det, batch["det_targets"].float(), batch["det_mask"], anchors,
            int(cfg["de_nc"]), gains)
            + hyp["seg_gain"] * seg_loss(seg, batch["seg_labels"]))
        grads = torch.autograd.grad(loss, [P[k] for k in tags],
                                    allow_unused=True)
        out["loss"].append(float(loss.detach()))
        t = np.float32(min(ni / max(hyp["warmup_iters"], 1), 1.0))
        lr_main = hyp["lr0"] * hyp["lf0"]
        lr_bias = hyp["warmup_bias_lr"] + (lr_main - hyp["warmup_bias_lr"]) * t
        lr_other = lr_main * t
        mom = hyp["warmup_momentum"] + (hyp["momentum"]
                                        - hyp["warmup_momentum"]) * t
        with torch.no_grad():
            for (k, tag), g in zip(tags.items(), grads):
                g = torch.zeros_like(P[k]) if g is None else g
                if tag == WEIGHT:
                    g = g + hyp["weight_decay"] * P[k]
                mu[k].mul_(float(mom)).add_(g)
                d = g + float(mom) * mu[k]
                P[k].sub_(float(lr_bias if tag == BIAS else lr_other) * d)
        if ni == 0:
            out["grad"] = {k: mu[k].clone() for k in tags}
    out["change"] = {k: (P[k].detach() - start[k]) for k in tags}
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """``prog``: the program's losses and, per weight it trains, the norms
    of its first gradient and of its change; ``ref``: ``steps``' result.
    The three numbers of a training cell: the widest relative gap of a
    step's loss; and, by the worst leaf, the gap between the program's and
    the reference's norms of the first gradient and of the change, each
    over the larger of the reference's norm of that leaf and the median
    leaf's. Leaves whose first gradient in the reference is under a
    thousandth of the median leaf's (zero up to rounding, such as biases
    under a softmax) are left out of the change's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    out = {"loss_gap": loss}
    g_ref = {k: float(v.norm()) for k, v in ref["grad"].items()
             if k in prog["grad"]}
    g_med = float(np.median(list(g_ref.values())))
    moving = {k for k, v in g_ref.items() if v >= 1e-3 * g_med}
    for key, ref_norms, names in (
            ("grad_gap", g_ref, list(g_ref)),
            ("change_gap", {k: float(v.norm()) for k, v in
                            ref["change"].items()}, sorted(moving))):
        med = float(np.median([ref_norms[k] for k in names]))
        out[key] = max(abs(prog[key[:-4]][k] - ref_norms[k])
                       / max(ref_norms[k], med) for k in names)
    return out
