"""Seeded weights of the YOLOv5 v7.0 instance-segmentation model, made on
the device in a few large calls.

The recipe of ``harness/weights.py`` (the l and x6 cells') over this
model's weights (``reference/v7seg.param_specs``), with the differences
a Segment head needs:
- BN gamma and beta from ``init.bn``, running statistics set from
  ``bn_calibration_frames`` seeded frames by the float32 reference, each
  variance floored at ``bn_var_floor`` times its layer's mean;
- every conv weight but the Segment head's 1x1 convs times
  ``conv_weight_gain`` (Proto's three convs included), those times
  ``det_weight_gain``;
- the Segment head's biases: torch's uniform base, v7.0's prior on
  objectness and on the ``nc`` class columns only (``_initialize_biases``:
  obj + log(8 / (640 / s)^2), cls + log(0.6 / (nc - 0.99))), the class
  biases shifted by ``det_bias_shift.cls``; the mask coefficients' biases
  keep the uniform base, as v7.0 leaves them;
- objectness shifted (``calibrate_objectness``) so that the calibration
  frames give ``det_candidates`` NMS candidates a frame at conf 0.25,
  the classes read from columns 5 to 5 + nc.

One uniform draw of every weight's elements from a ``torch.Generator``
on the device; each weight an affine map of its slice. The same seed
gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.v7seg import param_specs, segment_row


def make_state_dict(cfg: dict, init: dict, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=g, device=device,
                      dtype=torch.float32)
    seg = segment_row(cfg)
    nc, no = seg["nc"], 5 + seg["nc"] + seg["nm"]
    bn = init["bn"]
    det_convs = {n[:-len(".bias")] + ".weight" for n, _, k, _ in specs
                 if k.startswith("det_bias.")}
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        if kind.startswith("bn_"):
            lo, hi = bn[kind[3:]]
            out[name] = u * (hi - lo) + lo
            continue
        bound = 1.0 / math.sqrt(fan_in)
        w = u * (2 * bound) - bound
        if name in det_convs:
            w = w * init["det_weight_gain"]
        elif kind == "conv":
            w = w * init["conv_weight_gain"]
        if kind.startswith("det_bias."):
            stride = float(kind.split(".", 1)[1])
            w = w.view(-1, no).clone()
            w[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
            if nc > 1:
                w[:, 5:5 + nc] += (math.log(0.6 / (nc - 0.99))
                                   + init["det_bias_shift"]["cls"])
            w = w.view(-1)
        out[name] = w
    return out


def seeded_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` on ``device``
    (``make_state_dict``, then BN's running statistics and the objectness
    shift from ``init.bn_calibration_frames`` seeded frames, 3/4 of
    ``imgsz`` high, by the float32 reference with TF32 off)."""
    from benchmark.harness.frames import letterbox_input, make_frames
    from benchmark.reference.precision import no_tf32
    from benchmark.reference.v7seg import calibrate_bn

    cfg = conf["model"]
    sd = make_state_dict(cfg, conf["init"], seed, device)
    size = conf["imgsz"]
    frames = make_frames(conf["init"]["bn_calibration_frames"],
                         size * 3 // 4, size, seed + 1, device)
    x = letterbox_input(frames, size)
    with no_tf32():
        calibrate_bn(cfg, sd, x, conf["init"]["bn_var_floor"])
        calibrate_objectness(cfg, sd, x, conf["init"]["det_candidates"])
    return sd


def calibrate_objectness(cfg: dict, sd: Dict[str, torch.Tensor],
                         x: torch.Tensor, per_frame: float,
                         conf_thres: float = 0.25) -> float:
    """Add one constant to every objectness bias of the Segment head, in
    place, so that the reference's decode of ``x`` has ``per_frame``
    candidates a frame on average (``obj > conf_thres`` and ``obj * best
    class > conf_thres``). Returns the constant."""
    from benchmark.reference.v7seg import forward

    seg = segment_row(cfg)
    nc, no = seg["nc"], 5 + seg["nc"] + seg["nm"]
    with torch.no_grad():
        dec, _ = forward(cfg, sd, x)
    p = dec[..., 4].double().clamp(1e-12, 1 - 1e-12)
    logit = torch.log(p / (1 - p))
    best = dec[..., 5:5 + nc].double().amax(-1)
    want = per_frame * x.shape[0]

    def count(s: float) -> float:
        obj = torch.sigmoid(logit + s)
        return float(((obj > conf_thres) & (obj * best > conf_thres)).sum())

    lo, hi = -30.0, 30.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if count(mid) < want else (lo, mid)
    shift = (lo + hi) / 2
    for name, _, kind, _ in param_specs(cfg):
        if kind.startswith("det_bias."):
            sd[name].view(-1, no)[:, 4] += shift
    return shift
