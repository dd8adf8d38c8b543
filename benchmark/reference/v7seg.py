"""The plain reference of YOLOv5 v7.0's instance-segmentation model
(``models/segment/yolov5x-seg.yaml``), in float32.

Plain PyTorch functional ops over a dict of weights, written from the
published model (github.com/ultralytics/yolov5, tag v7.0:
``models/yolo.py`` Detect, Segment; ``models/common.py`` Conv, C3, SPPF,
Proto; ``utils/segment/general.py`` process_mask, crop_mask). It imports
nothing of the program under test: the rows are walked here from the
config dict, and the weights are held under the torch state-dict names
that the program loads too (v7.0's, the model's rows as ``model.{i}``).
It borrows the DeSeNet reference's helpers (BN in eval, calibration,
training mode: ``reference/desenet.py``).

``param_specs(cfg)`` lists every weight (name, shape, kind, fan_in) in a
fixed order; ``forward(cfg, P, x)`` maps (B, 3, H, W) float images in
[0, 1] to ``(decode (B, A, 5 + nc + nm), proto (B, nm, H/4, W/4))``;
``mask_logits`` and ``masks`` give a kept box's mask as ``process_mask``
writes it with ``upsample=False``.

Departures from v7.0, each immaterial to what is compared:
- The rows are a JSON config in the program's schema: ``de_nc`` for v7.0's
  ``nc``, and the Segment row's args ``["de_nc", "anchors", nm, npr]``.
- A conv's BN (eps 1e-3, as v7.0's ``initialize_weights`` sets it) is
  skipped on a 1x1 input map, as the program's ``Conv`` does (no such map
  occurs at these sizes).
- The decode's xy is ``(2 s - 0.5 + grid) * stride`` where v7.0 adds its
  0.5-shifted grid, ``(2 s + (grid - 0.5)) * stride``: the same value up
  to a float32 rounding.
- ``mask_logits`` returns ``c . P`` before the sigmoid; ``masks`` takes
  ``v > 0`` for v7.0's ``sigmoid(v) > 0.5`` (the same decision, but for
  ``v`` within a float32 rounding of 0, where the sigmoid rounds to 0.5).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.desenet import (Training, _bn, _Specs,
                                         make_divisible, round_depth)


def rows(cfg: dict) -> List[dict]:
    """The config's rows resolved: index, inputs, block, output width and
    the block's arguments (v7.0's ``parse_model``)."""
    gd, gw = float(cfg["depth_multiple"]), float(cfg["width_multiple"])
    chs, strides, out = [3], [1], []
    for i, (f, n, name, args) in enumerate(cfg["backbone"] + cfg["head"]):
        fs = [x if x >= 0 else i + x for x in (f if isinstance(f, list)
                                               else [f])]
        args = [cfg[a] if isinstance(a, str) and a in cfg else a
                for a in args]
        c_in = [chs[x + 1] for x in fs]
        s_in = strides[fs[0] + 1]
        r = {"i": i, "f": fs, "name": name, "c1": c_in, "stride": s_in}
        if name in ("Conv", "C3", "SPPF"):
            r.update(c2=make_divisible(args[0] * gw, 8))
            if name == "Conv":
                k = args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                p = args[3] if len(args) > 3 else k // 2
                r.update(k=k, s=s, p=p, stride=s_in * s)
            elif name == "C3":
                r.update(n=round_depth(n, gd),
                         shortcut=bool(args[1]) if len(args) > 1 else True)
            else:
                r.update(k=int(args[1]) if len(args) > 1 else 5)
            if round_depth(n, gd) > 1 and name != "C3":
                raise NotImplementedError(f"row {i}: outer repeats")
        elif name == "nn.Upsample":
            r.update(c2=c_in[0], scale=int(args[1]),
                     stride=s_in // int(args[1]))
        elif name == "Concat":
            r.update(c2=sum(c_in))
        elif name == "Segment":
            r.update(c2=0, nc=int(args[0]), anchors=args[1], nm=int(args[2]),
                     npr=make_divisible(args[3] * gw, 8),
                     strides=[strides[x + 1] for x in fs])
        else:
            raise NotImplementedError(f"row {i}: {name}")
        out.append(r)
        chs.append(r["c2"])
        strides.append(r["stride"])
    return out


def segment_row(cfg: dict) -> dict:
    return next(r for r in rows(cfg) if r["name"] == "Segment")


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every weight of the model: (state-dict name, shape, kind, fan_in),
    the kinds of ``reference/desenet.param_specs`` (``det_bias.<stride>``
    for the Segment head's 1x1 convs' biases)."""
    sp = _Specs()
    for r in rows(cfg):
        p, c1, name = f"model.{r['i']}", r["c1"][0], r["name"]
        if name == "Conv":
            sp.cba(p, c1, r["c2"], r["k"])
        elif name == "C3":
            c_ = r["c2"] // 2
            sp.cba(f"{p}.cv1", c1, c_, 1)
            sp.cba(f"{p}.cv2", c1, c_, 1)
            sp.cba(f"{p}.cv3", 2 * c_, r["c2"], 1)
            for j in range(r["n"]):
                sp.cba(f"{p}.m.{j}.cv1", c_, c_, 1)
                sp.cba(f"{p}.m.{j}.cv2", c_, c_, 3)
        elif name == "SPPF":
            c_ = c1 // 2
            sp.cba(f"{p}.cv1", c1, c_, 1)
            sp.cba(f"{p}.cv2", 4 * c_, r["c2"], 1)
        elif name == "Segment":
            no, na = 5 + r["nc"] + r["nm"], len(r["anchors"][0]) // 2
            for j, c in enumerate(r["c1"]):
                sp.conv(f"{p}.m.{j}", c, no * na, 1, bias=True,
                        kind=f"det_bias.{r['strides'][j]}")
            sp.cba(f"{p}.proto.cv1", c1, r["npr"], 3)
            sp.cba(f"{p}.proto.cv2", r["npr"], r["npr"], 3)
            sp.cba(f"{p}.proto.cv3", r["npr"], r["nm"], 1)
    return sp.items


# ---- the forward ----------------------------------------------------------


def _conv(P: Dict[str, torch.Tensor], name: str, x: torch.Tensor, k: int = 1,
          s: int = 1, p: int = None) -> torch.Tensor:
    """v7.0's ``Conv``: conv (bias-free, pad ``p``, default k // 2), BN,
    SiLU."""
    y = F.conv2d(x, P[f"{name}.conv.weight"], None, s,
                 k // 2 if p is None else p)
    if x.shape[2] * x.shape[3] > 1:
        y = _bn(P, f"{name}.bn", y)
    return F.silu(y)


def _segment(P, p: str, xs, r: dict):
    """The decode (B, A, 5 + nc + nm), anchors ordered scale, anchor, y,
    x, the sigmoid on columns 0 to 4 + nc; the prototypes of xs[0]."""
    proto = F.interpolate(_conv(P, f"{p}.proto.cv1", xs[0], 3),
                          scale_factor=2, mode="nearest")
    proto = _conv(P, f"{p}.proto.cv3", _conv(P, f"{p}.proto.cv2", proto, 3))
    nc, nm = r["nc"], r["nm"]
    no, na = 5 + nc + nm, len(r["anchors"][0]) // 2
    out = []
    for j, x in enumerate(xs):
        y = F.conv2d(x, P[f"{p}.m.{j}.weight"], P[f"{p}.m.{j}.bias"])
        b, _, ny, nx = y.shape
        y = y.view(b, na, no, ny, nx).permute(0, 1, 3, 4, 2)
        if isinstance(P, Training):
            out.append(y)
            continue
        s = torch.sigmoid(y[..., :5 + nc])
        gy, gx = torch.meshgrid(torch.arange(ny, device=y.device),
                                torch.arange(nx, device=y.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).to(y.dtype)[None, None]
        anchor = torch.tensor(r["anchors"][j], dtype=y.dtype,
                              device=y.device).view(1, na, 1, 1, 2)
        xy = (s[..., 0:2] * 2.0 - 0.5 + grid) * r["strides"][j]
        wh = (s[..., 2:4] * 2.0) ** 2 * anchor
        out.append(torch.cat([xy, wh, s[..., 4:], y[..., 5 + nc:]], -1)
                   .reshape(b, -1, no))
    return (out if isinstance(P, Training) else torch.cat(out, 1)), proto


def forward(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor):
    """(B, 3, H, W) images in [0, 1] -> (decode (B, A, 5 + nc + nm), proto
    (B, nm, H/4, W/4)), in the dtype of ``x`` and ``P``. With ``P`` a
    ``reference.desenet.Calibrating`` dict, every BN's running statistics
    are set from ``x`` on the way (``calibrate_bn``)."""
    rs = rows(cfg)
    keep = {x2 for r in rs for x2 in r["f"] if x2 != r["i"] - 1}
    cache, prev, out = {}, x, None
    for r in rs:
        ins = [prev if j == r["i"] - 1 else cache[j] for j in r["f"]]
        p, name, y = f"model.{r['i']}", r["name"], None
        if name == "Conv":
            y = _conv(P, p, ins[0], r["k"], r["s"], r["p"])
        elif name == "C3":
            a = _conv(P, f"{p}.cv1", ins[0])
            for j in range(r["n"]):
                t = _conv(P, f"{p}.m.{j}.cv2",
                          _conv(P, f"{p}.m.{j}.cv1", a), 3)
                a = a + t if r["shortcut"] else t
            y = _conv(P, f"{p}.cv3",
                      torch.cat([a, _conv(P, f"{p}.cv2", ins[0])], 1))
        elif name == "SPPF":
            a = [_conv(P, f"{p}.cv1", ins[0])]
            for _ in range(3):
                a.append(F.max_pool2d(a[-1], r["k"], 1, r["k"] // 2))
            y = _conv(P, f"{p}.cv2", torch.cat(a, 1))
        elif name == "nn.Upsample":
            y = F.interpolate(ins[0], scale_factor=r["scale"], mode="nearest")
        elif name == "Concat":
            y = torch.cat(ins, 1)
        elif name == "Segment":
            y = out = _segment(P, p, ins, r)
        if r["i"] in keep:
            cache[r["i"]] = y
        prev = y
    return out


def calibrate_bn(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
                 var_floor: float = 0.0) -> None:
    """``reference/desenet.calibrate_bn`` over this model's rows."""
    from benchmark.reference.desenet import Calibrating

    cal = Calibrating(P)
    cal.var_floor = var_floor
    with torch.no_grad():
        forward(cfg, cal, x)


# ---- the masks ------------------------------------------------------------


def mask_logits(proto: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(nm, hp, wp) prototypes of one image and (n, nm) coefficients ->
    (n, hp, wp) ``c . P`` (v7.0's ``masks_in @ protos`` before the
    sigmoid), in the inputs' dtype."""
    nm, hp, wp = proto.shape
    return (coef @ proto.reshape(nm, -1)).view(-1, hp, wp)


def crop(boxes: torch.Tensor, hp: int, wp: int, img_hw) -> torch.Tensor:
    """(n, 4) xyxy boxes in input pixels -> (n, hp, wp) bool, v7.0's
    ``crop_mask`` of the boxes scaled by the prototypes' size over the
    input's (``process_mask``'s ``downsampled_bboxes``)."""
    b = boxes.clone()
    b[:, 0] *= wp / img_hw[1]
    b[:, 2] *= wp / img_hw[1]
    b[:, 1] *= hp / img_hw[0]
    b[:, 3] *= hp / img_hw[0]
    r = torch.arange(wp, device=b.device, dtype=b.dtype)[None, None, :]
    c = torch.arange(hp, device=b.device, dtype=b.dtype)[None, :, None]
    x1, y1, x2, y2 = (b[:, k, None, None] for k in range(4))
    return (r >= x1) & (r < x2) & (c >= y1) & (c < y2)


def masks(proto: torch.Tensor, coef: torch.Tensor, boxes: torch.Tensor,
          img_hw) -> torch.Tensor:
    """``process_mask(proto, coef, boxes, img_hw, upsample=False)``:
    (n, hp, wp) bool masks of one image's kept boxes."""
    hp, wp = proto.shape[1:]
    return (mask_logits(proto, coef) > 0) & crop(boxes, hp, wp, img_hw)
