"""NN building blocks (torch.nn, NCHW) for the served ``yolov5s_seg`` graph.

Counterpart of ``desenet_tpu/models/layers.py``, limited to the blocks the
serving slice runs. Blocks use the reference layout and the reference's
torch state-dict names (a Focus slice-concat plus a kxk conv; C3 with
separate ``cv1``/``cv2``); the JAX package's TPU layout workarounds (fused
stem, fused ``cv12``, split-conv concats) are not carried over.

Numerics that differ from PyTorch defaults and are kept on purpose:

- BatchNorm eps 1e-3 and momentum 0.03 (torch defaults: 1e-5 / 0.1), and
  in training the running variance takes the biased batch variance, as
  flax's BatchNorm does (torch's takes the unbiased one).
- ``ConvBnAct`` skips its BN when the conv's INPUT map is 1x1 (a reference
  quirk; the JAX package decides it at trace time, here at run time). Those
  BNs still exist in the state dict and keep their init.

Every ``forward`` takes and returns NCHW tensors; the JAX modules take NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from desenet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    max_pool_same,
    resize_bilinear,
    resize_nearest,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int, p=None) -> int:
    """'same' padding = k//2."""
    return k // 2 if p is None else p


def make_divisible(x, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of divisor."""
    return int(math.ceil(x / divisor) * divisor)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step moves the running variance
    toward the biased batch variance, as flax's BatchNorm does (the JAX
    package's ``layers.BatchNorm``, momentum 0.97 there). Normalization,
    the running mean and eval mode are torch's; ``num_batches_tracked`` is
    not advanced. With ``momentum=None`` (torch's cumulative average, which
    flax does not have) the module is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        # F.batch_norm moves a copy of the variance by m * var * n / (n - 1)
        # (autograd keeps that copy); the n / (n - 1) is taken back from its
        # own statistics, with no pass over x
        rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            old = self.running_var
            old.copy_(rv - (rv - old * (1.0 - self.momentum)) / n)
        return y


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BN + SiLU: the reference ``Conv`` block, with the
    BN skipped on a 1x1 input map."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), dilation=d,
                              groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if x.shape[2] * x.shape[3] > 1:
            y = self.bn(y)
        return self.act(y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return y + x if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference layout: separate cv1/cv2)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: parallel stride-1 max pools."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [max_pool_same(y, k) for k in self.k],
                                  1))


class Focus(nn.Module):
    """Space-to-depth stem: 4-way pixel slice + conv.

    Slice order (y, x) = (even, even), (odd, even), (even, odd), (odd, odd),
    as in the reference, so its weights line up."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, s, p, g, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([
            x[:, :, ::2, ::2],
            x[:, :, 1::2, ::2],
            x[:, :, ::2, 1::2],
            x[:, :, 1::2, 1::2],
        ], 1))


class FFM(nn.Module):
    """Feature-fusion module: conv + channel attention, residual add:
    ``att = sigmoid(fc2(silu(fc1(mean(feat)))))``, ``out = feat*att + feat``.
    ``channel_attention`` indices 1 and 3 are the reference's fc1/fc2."""

    def __init__(self, c1: int, c2: int, reduction: int = 1, k: int = 1):
        super().__init__()
        self.convblk = ConvBnAct(c1, c2, k, 1)
        self.channel_attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(c2, c2 // reduction, 1, bias=False),
            nn.SiLU(),
            nn.Conv2d(c2 // reduction, c2, 1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        feat = self.convblk(torch.cat(list(xs), 1))
        return feat * self.channel_attention(feat) + feat


class DilatedConvBnSiLU(nn.Sequential):
    """Dilated 3x3 conv (bias=False) + BN + SiLU, always with its BN; indices
    0/1 are the reference's conv/bn names."""

    def __init__(self, c1: int, c2: int, d: int):
        super().__init__(
            nn.Conv2d(c1, c2, 3, 1, padding=d, dilation=d, bias=False),
            batch_norm(c2),
            nn.SiLU(),
        )


class GlobalBranch(nn.Sequential):
    """AdaptiveAvgPool(1) + 1x1 ConvBnAct (its BN never runs: 1x1 input),
    broadcast back to ``out_hw`` by a nearest resize."""

    def __init__(self, c1: int, c2: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), ConvBnAct(c1, c2, 1))

    def forward(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        return resize_nearest(self[1](self[0](x)), out_hw)

    def quirk_bn_prefixes(self):
        return ["1.bn."]


class ACSP(nn.Module):
    """Cascaded dilated branches plus a global branch fed from the cascade
    tail: the SegMaskPSP2 spatial path."""

    def __init__(self, c1: int, c2: int, map_reduce: int = 4,
                 d: Sequence[int] = (2, 3), has_global: bool = False):
        super().__init__()
        inter = c1 // map_reduce
        self.branch0 = nn.Sequential(ConvBnAct(c1, inter, 1, 1),
                                     ConvBnAct(inter, inter, 3, 1))
        self.branch1 = DilatedConvBnSiLU(inter, inter, d[0])
        self.branch2 = DilatedConvBnSiLU(inter, inter, d[1])
        self.branch_global = GlobalBranch(inter, inter) if has_global else None
        self.ConvLinear = ConvBnAct(inter * (4 if has_global else 3), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.branch0(x)
        x1 = self.branch1(x0)
        x2 = self.branch2(x1)
        feats = [x0, x1, x2]
        if self.branch_global is not None:
            feats.append(self.branch_global(x2, x.shape[2:]))
        return self.ConvLinear(torch.cat(feats, 1))


class PyramidPooling(nn.Module):
    """PSPNet pyramid pooling: adaptive-avg to k in {1,2,3,6}, 1x1 ConvBnAct
    to C/4 each, bilinear (align_corners=True) back, concat (+input if
    short_cut). The k=1 branch's BN never runs (1x1 input)."""

    def __init__(self, c1: int, k: Sequence[int] = (1, 2, 3, 6),
                 short_cut: bool = False):
        super().__init__()
        self.k = tuple(k)
        self.short_cut = short_cut
        for i in range(len(self.k)):
            setattr(self, f"conv{i + 1}", ConvBnAct(c1, c1 // 4, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        feats = [x] if self.short_cut else []
        for i, k in enumerate(self.k):
            y = getattr(self, f"conv{i + 1}")(adaptive_avg_pool(x, k))
            feats.append(resize_bilinear(y, hw, align_corners=True))
        return torch.cat(feats, 1)

    def quirk_bn_prefixes(self):
        return [f"conv{i + 1}.bn." for i, k in enumerate(self.k) if k == 1]
