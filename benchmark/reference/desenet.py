"""The plain reference of the served DeSeNet forward, in float32.

Plain PyTorch functional ops over a dict of weights, written from the
model's published description (YOLOv5's CSP backbone and PANet neck at the
config's depth and width multipliers, the ``Detect`` head with its decode,
and the ``SegMaskPSP2`` seg head up to its 1/8-resolution logits). It
imports nothing of the program under test: the rows are walked here from
the config dict alone, and the weights are held under the reference's
torch state-dict names, which the program loads too.

``param_specs(cfg)`` lists every weight (name, shape, kind, fan_in) in a
fixed order; ``forward(cfg, params, x)`` maps (B, 3, H, W) float images in
[0, 1] to ``(decode (B, A, 5 + nc), seg logits (B, se_nc, H/8, W/8))``;
with the weights wrapped in ``Training``, to ``(per-scale raw Detect maps
(B, na, ny, nx, 5 + nc), seg logits)`` with BN on the batch's statistics.

Semantics kept from the reference implementation, which the comparison
depends on:
- ``Conv``: conv (bias-free, pad k // 2) -> eval BN (eps 1e-3) -> SiLU,
  with the BN skipped where the conv's input map is 1x1 (the global branch
  and the k=1 pyramid branch of the seg head).
- ``Focus``: the (even, even), (odd, even), (even, odd), (odd, odd) pixel
  slices concatenated before its conv.
- The seg head's deeper stem levels and pyramid branches are resized with
  align_corners bilinear; its global branch is broadcast.
- ``Detect``: ``xy = (2 s - 0.5 + grid) * stride``, ``wh = (2 s)^2 *
  anchor``, anchors in pixels; anchors ordered scale, anchor, y, x.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def round_depth(n: int, gd: float) -> int:
    return max(round(n * gd), 1) if n > 1 else n


class _Specs:
    """Collects (name, shape, kind, fan_in) in build order."""

    def __init__(self):
        self.items: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def conv(self, name: str, c1: int, c2: int, k: int, bias: bool = False,
             kind: str = "conv_bias"):
        fan_in = c1 * k * k
        self.items.append((f"{name}.weight", (c2, c1, k, k), "conv", fan_in))
        if bias:
            self.items.append((f"{name}.bias", (c2,), kind, fan_in))

    def bn(self, name: str, c: int):
        for field in ("weight", "bias", "running_mean", "running_var"):
            self.items.append((f"{name}.{field}", (c,), f"bn_{field}", c))

    def cba(self, name: str, c1: int, c2: int, k: int):
        self.conv(f"{name}.conv", c1, c2, k)
        self.bn(f"{name}.bn", c2)


def rows(cfg: dict) -> List[dict]:
    """The config's rows resolved: index, inputs, block, output width and
    the block's arguments."""
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
        if name in ("Focus", "Conv", "C3", "SPP"):
            c2 = make_divisible(args[0] * gw, 8)
            r.update(c2=c2)
            if name == "Focus":
                r.update(k=args[1], stride=s_in * 2)
            elif name == "Conv":
                k = args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                r.update(k=k, s=s, stride=s_in * s)
            elif name == "C3":
                r.update(n=round_depth(n, gd),
                         shortcut=bool(args[1]) if len(args) > 1 else True)
            else:
                r.update(ks=tuple(args[1]))
            if round_depth(n, gd) > 1 and name != "C3":
                raise NotImplementedError(f"row {i}: outer repeats")
        elif name == "nn.Upsample":
            r.update(c2=c_in[0], scale=int(args[1]), stride=s_in // int(args[1]))
        elif name == "Concat":
            r.update(c2=sum(c_in))
        elif name == "SegMaskPSP2":
            r.update(c2=int(args[0]), n_seg=int(args[0]),
                     c_hid=make_divisible(args[2] * gw, 8))
        elif name == "Detect":
            r.update(c2=0, nc=int(args[0]), anchors=args[1],
                     strides=[strides[x + 1] for x in fs])
        else:
            raise NotImplementedError(f"row {i}: {name}")
        out.append(r)
        chs.append(r["c2"])
        strides.append(r["stride"])
    return out


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every weight of the model: (state-dict name, shape, kind, fan_in).
    Kinds: ``conv`` (a conv weight), ``conv_bias``, ``obj_bias`` /
    ``det_bias`` (Detect's), ``bn_weight``, ``bn_bias``,
    ``bn_running_mean``, ``bn_running_var``."""
    sp = _Specs()
    for r in rows(cfg):
        p, c1 = f"model.{r['i']}", r["c1"][0]
        name = r["name"]
        if name == "Focus":
            sp.cba(f"{p}.conv", 4 * c1, r["c2"], r["k"])
        elif name == "Conv":
            sp.cba(p, c1, r["c2"], r["k"])
        elif name == "C3":
            c_ = r["c2"] // 2
            sp.cba(f"{p}.cv1", c1, c_, 1)
            sp.cba(f"{p}.cv2", c1, c_, 1)
            sp.cba(f"{p}.cv3", 2 * c_, r["c2"], 1)
            for j in range(r["n"]):
                sp.cba(f"{p}.m.{j}.cv1", c_, c_, 1)
                sp.cba(f"{p}.m.{j}.cv2", c_, c_, 3)
        elif name == "SPP":
            c_ = c1 // 2
            sp.cba(f"{p}.cv1", c1, c_, 1)
            sp.cba(f"{p}.cv2", c_ * (len(r["ks"]) + 1), r["c2"], 1)
        elif name == "SegMaskPSP2":
            ch, c_hid = r["c1"], r["c_hid"]
            inter, c_ctx = 3 * c_hid // 6, c_hid // 6
            for lvl, c in zip(("m8", "m16", "m32"), ch):
                sp.cba(f"{p}.{lvl}.0", c, c_hid, 1)
            s = f"{p}.spatial_path"
            sp.cba(f"{s}.branch0.0", 3 * c_hid, inter, 1)
            sp.cba(f"{s}.branch0.1", inter, inter, 3)
            for b in ("branch1", "branch2"):
                sp.conv(f"{s}.{b}.0", inter, inter, 3)
                sp.bn(f"{s}.{b}.1", inter)
            sp.cba(f"{s}.branch_global.1", inter, inter, 1)
            sp.cba(f"{s}.ConvLinear", 4 * inter, c_hid, 1)
            sp.cba(f"{p}.context_path.0", 3 * c_hid, c_ctx, 1)
            for k in range(4):
                sp.cba(f"{p}.context_path.1.conv{k + 1}", c_ctx, c_ctx // 4, 1)
            sp.cba(f"{p}.ffm.convblk", c_hid + 4 * (c_ctx // 4), c_hid, 3)
            sp.conv(f"{p}.ffm.channel_attention.1", c_hid, c_hid, 1)
            sp.conv(f"{p}.ffm.channel_attention.3", c_hid, c_hid, 1)
            sp.conv(f"{p}.out.0", c_hid, r["n_seg"], 1, bias=True)
        elif name == "Detect":
            no, na = r["nc"] + 5, len(r["anchors"][0]) // 2
            for j, c in enumerate(r["c1"]):
                sp.conv(f"{p}.m.{j}", c, no * na, 1, bias=True,
                        kind=f"det_bias.{r['strides'][j]}")
    return sp.items


# ---- the forward ----------------------------------------------------------


def _cba(P: Dict[str, torch.Tensor], name: str, x: torch.Tensor, k: int = 1,
         s: int = 1, d: int = 1) -> torch.Tensor:
    y = F.conv2d(x, P[f"{name}.conv.weight"], None, s, d * (k // 2), d)
    if x.shape[2] * x.shape[3] > 1:
        y = _bn(P, f"{name}.bn", y)
    y = F.silu(y)
    store = getattr(P, "store", None)
    if store is not None and y.shape[2] * y.shape[3] > 1:
        y = y.to(store).to(x.dtype)
    return y


class Calibrating(dict):
    """Weights whose BN running statistics ``forward`` sets from the
    batch it is given (``calibrate_bn``)."""

    var_floor = 0.0


def calibrate_bn(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
                 var_floor: float = 0.0) -> None:
    """Set every BN's running mean and (biased) variance, in place, to the
    statistics of its input over ``x``, layer after layer: BN as training
    on such images would leave it, so that activations keep their scale
    through the depth of a random network. A channel's variance is
    floored at ``var_floor`` times its layer's mean: a channel that barely
    varies over ``x`` would otherwise be scaled up by as much as
    1/sqrt(eps) on other images."""
    cal = Calibrating(P)
    cal.var_floor = var_floor
    with torch.no_grad():
        forward(cfg, cal, x)


class Training(dict):
    """Weights for ``forward`` in training mode: BN normalizes with the
    batch's statistics (its running statistics are not moved: nothing
    compared reads them), and ``Detect`` returns its raw per-scale maps."""

    store = None  # a float8 dtype: every block's output rounded to it


def _bn(P, name, y):
    if isinstance(P, Training):
        return F.batch_norm(y, None, None, P[f"{name}.weight"],
                            P[f"{name}.bias"], True, 0.0, BN_EPS)
    if isinstance(P, Calibrating):
        yd = y.double()
        var = yd.var((0, 2, 3), unbiased=False)
        P[f"{name}.running_mean"].copy_(yd.mean((0, 2, 3)))
        P[f"{name}.running_var"].copy_(
            var.clamp(min=P.var_floor * float(var.mean())))
    return F.batch_norm(y, P[f"{name}.running_mean"],
                        P[f"{name}.running_var"], P[f"{name}.weight"],
                        P[f"{name}.bias"], False, 0.0, BN_EPS)


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(int(v) for v in hw), mode="bilinear",
                         align_corners=True)


def _seg_psp2(P, p: str, xs, c_hid: int) -> torch.Tensor:
    f8 = _cba(P, f"{p}.m8.0", xs[0])
    hw = f8.shape[2:]
    feat = torch.cat([f8, _up(_cba(P, f"{p}.m16.0", xs[1]), hw),
                      _up(_cba(P, f"{p}.m32.0", xs[2]), hw)], 1)
    s = f"{p}.spatial_path"
    x0 = _cba(P, f"{s}.branch0.1", _cba(P, f"{s}.branch0.0", feat), 3)
    x1 = F.silu(_bn(P, f"{s}.branch1.1", F.conv2d(
        x0, P[f"{s}.branch1.0.weight"], None, 1, 2, 2)))
    x2 = F.silu(_bn(P, f"{s}.branch2.1", F.conv2d(
        x1, P[f"{s}.branch2.0.weight"], None, 1, 3, 3)))
    g = _cba(P, f"{s}.branch_global.1", x2.mean((2, 3), keepdim=True))
    spatial = _cba(P, f"{s}.ConvLinear",
                   torch.cat([x0, x1, x2, g.expand_as(x2)], 1))
    ctx = _cba(P, f"{p}.context_path.0", feat)
    pyr = [_up(_cba(P, f"{p}.context_path.1.conv{j + 1}",
                    F.adaptive_avg_pool2d(ctx, k)), hw)
           for j, k in enumerate((1, 2, 3, 6))]
    fused = _cba(P, f"{p}.ffm.convblk", torch.cat([spatial] + pyr, 1), 3)
    att = torch.sigmoid(F.conv2d(F.silu(F.conv2d(
        fused.mean((2, 3), keepdim=True),
        P[f"{p}.ffm.channel_attention.1.weight"])),
        P[f"{p}.ffm.channel_attention.3.weight"]))
    y = fused * att + fused
    return F.conv2d(y, P[f"{p}.out.0.weight"], P[f"{p}.out.0.bias"])


def _detect(P, p: str, xs, r: dict) -> torch.Tensor:
    no, na = r["nc"] + 5, len(r["anchors"][0]) // 2
    out = []
    for j, x in enumerate(xs):
        y = F.conv2d(x, P[f"{p}.m.{j}.weight"], P[f"{p}.m.{j}.bias"])
        b, _, ny, nx = y.shape
        y = y.view(b, na, no, ny, nx).permute(0, 1, 3, 4, 2)
        if isinstance(P, Training):
            out.append(y)
            continue
        y = torch.sigmoid(y)
        gy, gx = torch.meshgrid(torch.arange(ny, device=y.device),
                                torch.arange(nx, device=y.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).to(y.dtype)[None, None]
        anchor = torch.tensor(r["anchors"][j], dtype=y.dtype,
                              device=y.device).view(1, na, 1, 1, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * r["strides"][j]
        wh = (y[..., 2:4] * 2.0) ** 2 * anchor
        out.append(torch.cat([xy, wh, y[..., 4:]], -1).reshape(b, -1, no))
    return out if isinstance(P, Training) else torch.cat(out, 1)


def forward(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor):
    """(B, 3, H, W) images in [0, 1] -> (decode (B, A, 5 + nc), seg logits
    (B, se_nc, H/8, W/8)), in the dtype of ``x`` and ``P``."""
    rs = rows(cfg)
    keep = {x2 for r in rs for x2 in r["f"] if x2 != r["i"] - 1}
    cache, prev, det, seg = {}, x, None, None
    for r in rs:
        ins = [prev if j == r["i"] - 1 else cache[j] for j in r["f"]]
        p, name, y = f"model.{r['i']}", r["name"], None
        if name == "Focus":
            v = ins[0]
            v = torch.cat([v[:, :, ::2, ::2], v[:, :, 1::2, ::2],
                           v[:, :, ::2, 1::2], v[:, :, 1::2, 1::2]], 1)
            y = _cba(P, f"{p}.conv", v, r["k"])
        elif name == "Conv":
            y = _cba(P, p, ins[0], r["k"], r["s"])
        elif name == "C3":
            a = _cba(P, f"{p}.cv1", ins[0])
            for j in range(r["n"]):
                t = _cba(P, f"{p}.m.{j}.cv2", _cba(P, f"{p}.m.{j}.cv1", a), 3)
                a = a + t if r["shortcut"] else t
            y = _cba(P, f"{p}.cv3", torch.cat([a, _cba(P, f"{p}.cv2",
                                                       ins[0])], 1))
        elif name == "SPP":
            a = _cba(P, f"{p}.cv1", ins[0])
            y = _cba(P, f"{p}.cv2", torch.cat(
                [a] + [F.max_pool2d(a, k, 1, k // 2) for k in r["ks"]], 1))
        elif name == "nn.Upsample":
            y = F.interpolate(ins[0], scale_factor=r["scale"], mode="nearest")
        elif name == "Concat":
            y = torch.cat(ins, 1)
        elif name == "SegMaskPSP2":
            y = seg = _seg_psp2(P, p, ins, r["c_hid"])
        elif name == "Detect":
            y = det = _detect(P, p, ins, r)
        if r["i"] in keep:
            cache[r["i"]] = y
        prev = y
    return det, seg


def seg_upsample(logits: torch.Tensor, scale: int = 8) -> torch.Tensor:
    """The served seg map's logits at full resolution: the 1/8 logits
    resized ``scale`` times with align_corners bilinear, in float32."""
    h, w = logits.shape[2:]
    return _up(logits.float(), (h * scale, w * scale))
