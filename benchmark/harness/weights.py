"""Seeded weights, made on the device in a few large calls.

The distribution is a frozen copy of the program's documented init
(torch's default conv init, U(+-1/sqrt(fan_in)) for conv weights and
biases, and the reference Detect head's bias prior), with departures that
a configuration file states under ``init`` and ``assumed``:
- ``bn``: ranges for BN's affine parameters (small gammas, so that SiLU
  works near its linear part and bf16 rounding does not grow with depth);
  its running statistics are then calibrated on ``bn_calibration_frames``
  seeded frames by the float32 reference, each variance floored at
  ``bn_var_floor`` times its layer's mean (the documented init leaves BN
  at identity, where activations vanish with depth);
- ``conv_weight_gain``: every conv weight but Detect's scaled, so that
  conv outputs stay well above BN's eps at these gammas;
- ``det_weight_gain``, ``det_bias_shift`` and ``det_candidates``: the
  Detect head's 1x1 convs' weights scaled, a constant added to its class
  biases, and its objectness biases shifted (``calibrate_objectness``) so
  that the calibration frames give ``det_candidates`` NMS candidates a
  frame on average: random weights give NMS candidates to work on, about
  as many whatever the seed.

One uniform draw of every weight's elements comes from a
``torch.Generator`` on the device; each weight is then an affine map of
its slice. The same seed gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.desenet import param_specs


def make_state_dict(cfg: dict, init: dict, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=g, device=device,
                      dtype=torch.float32)
    nc = int(cfg["de_nc"])
    shift = init["det_bias_shift"]
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
            no = nc + 5
            w = w.view(-1, no).clone()
            w[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
            if nc > 1:
                w[:, 5:] += math.log(0.6 / (nc - 0.99)) + shift["cls"]
            w = w.view(-1)
        out[name] = w
    return out


def seeded_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` on ``device``: drawn by
    ``make_state_dict``, then BN's running statistics set from
    ``init.bn_calibration_frames`` seeded frames (3/4 of ``imgsz`` high,
    ``imgsz`` wide: 640x480 at 640) by the float32
    reference with TF32 off (``reference.desenet.calibrate_bn``)."""
    from benchmark.harness.frames import letterbox_input, make_frames
    from benchmark.reference.desenet import calibrate_bn
    from benchmark.reference.precision import no_tf32

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
    """Add one constant to every Detect objectness bias, in place, so that
    the reference's decode of ``x`` has ``per_frame`` candidates a frame
    on average (``obj > conf_thres`` and ``obj * best class >
    conf_thres``). Returns the constant."""
    from benchmark.reference.desenet import forward

    with torch.no_grad():
        dec, _ = forward(cfg, sd, x)
    p = dec[..., 4].double().clamp(1e-12, 1 - 1e-12)
    logit = torch.log(p / (1 - p))
    best = dec[..., 5:].double().amax(-1)
    want = per_frame * x.shape[0]

    def count(s: float) -> float:
        obj = torch.sigmoid(logit + s)
        return float(((obj > conf_thres) & (obj * best > conf_thres)).sum())

    lo, hi = -30.0, 30.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if count(mid) < want else (lo, mid)
    shift = (lo + hi) / 2
    no = int(cfg["de_nc"]) + 5
    for name, _, kind, _ in param_specs(cfg):
        if kind.startswith("det_bias."):
            sd[name].view(-1, no)[:, 4] += shift
    return shift
