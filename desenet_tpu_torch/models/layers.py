"""NN building blocks (torch.nn, NCHW).

Counterpart of ``desenet_tpu/models/layers.py``: every block the model DSL
can name, and the blocks of the seg heads. Blocks use the reference layout
and the reference's torch state-dict names (a Focus slice-concat plus a kxk
conv; C3 with separate ``cv1``/``cv2``); ``FusedFocus`` is the JAX
package's one-conv stem, which equals Focus on rearranged weights. The JAX
package's TPU layout workarounds (fused ``cv12``, split-conv concats, the
phase-layout stem) are not carried over, nor are the blocks the DSL cannot
name (ARM, RFB1, DAPPM, ASPPs, Sum, Classify, ConvBNReLU).

Numerics that differ from PyTorch defaults and are kept on purpose:

- BatchNorm eps 1e-3 and momentum 0.03 (torch defaults: 1e-5 / 0.1), and
  in training the running variance takes the biased batch variance, as
  flax's BatchNorm does (torch's takes the unbiased one). With a process
  group of more than one process, training BN takes its statistics over
  the global batch, as the JAX step's BN over a sharded batch does.
- ``ConvBnAct`` skips its BN when the conv's INPUT map is 1x1 (a reference
  quirk; the JAX package decides it at trace time, here at run time). Those
  BNs still exist in the state dict and keep their init.

Every ``forward`` takes and returns NCHW tensors; the JAX modules take NHWC.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from desenet_tpu_torch.parallel import multihost
from desenet_tpu_torch.parallel.mesh import process_count
from desenet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    max_pool_same,
    resize_bilinear,
    resize_nearest,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None):
    """'same' padding = k//2 (per dimension for a kernel-size tuple)."""
    if p is not None:
        return p
    return k // 2 if isinstance(k, int) else tuple(v // 2 for v in k)


def make_divisible(x, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of divisor."""
    return int(math.ceil(x / divisor) * divisor)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step moves the running variance
    toward the biased batch variance, as flax's BatchNorm does (the JAX
    package's ``layers.BatchNorm``, momentum 0.97 there). Normalization,
    the running mean and eval mode are torch's; ``num_batches_tracked`` is
    not advanced. With ``momentum=None`` (torch's cumulative average, which
    flax does not have) the module is torch's own. With a process group of
    more than one process the statistics are the global batch's
    (``_global_batch_norm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        if process_count() > 1:
            return self._global_batch_norm(x)
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

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """BN over the batch of every process: one sum of per-channel
        [count, sum, sum of squares] over the processes, in at least f32,
        with autograd through it; flax's variance (the mean of squares less
        the squared mean, floored at 0), biased, which the running variance
        moves toward as flax's does. Not ``nn.SyncBatchNorm``, whose running
        variance takes the unbiased variance."""
        c = x.shape[1]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        count = torch.full((1,), x.numel() // c, dtype=xs.dtype,
                           device=x.device)
        stats = multihost.global_sum_grad(torch.cat(
            [count, xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3))]))
        n = stats[0]
        mean = stats[1:c + 1] / n
        var = torch.clamp(stats[c + 1:] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * scale
        y = xs * scale[:, None, None] + shift[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * m)
        return y.to(x.dtype)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BN + SiLU: the reference ``Conv`` block, with the
    BN skipped on a 1x1 input map."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 d: int = 1, act: bool = True):
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


class ConvBnSiLU(ConvBnAct):
    """ConvBnAct whose BN runs on any map, as the JAX package's bare
    conv + BatchNorm pairs do (CrossConv)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class FusedFocus(ConvBnAct):
    """The JAX package's one-conv stem (``parse_config(fuse_focus=True)``):
    Focus's slice-concat plus kxk conv as one 2k x 2k / s2 conv, pad k-1, on
    the raw image. Focus weights cross by ``utils/convert.focus_to_fused``.
    The BN-skip quirk looks at the raw image here, at the slice-concat in
    Focus: the two differ only for a 2x2 image, as in the JAX package."""

    def __init__(self, c1: int, c2: int, k: int = 6, s: int = 2, p: int = 2,
                 act: bool = True):
        super().__init__(c1, c2, k, s, p, act=act)


class DWConv(ConvBnAct):
    """Depthwise-ish conv: ConvBnAct with groups gcd(c1, c2)
    (common.py:59-62)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class Dropout(nn.Module):
    """Inverted dropout with its mask drawn from ``generator``: in training
    each element is zeroed with probability ``p`` and the rest are scaled
    by 1/(1-p), as flax's ``nn.Dropout`` does; identity in eval. The JAX
    heads draw from flax's ``dropout`` rng, whose bits torch cannot
    reproduce; ``generator`` (a torch.Generator on the input's device, set
    by the training step; None takes the device's default one) makes the
    port's draws repeatable."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


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


class BottleneckCSP(nn.Module):
    """Legacy CSP bottleneck (common.py:114-130): bare 1x1 convs cv2/cv3,
    a BN over their concat and LeakyReLU(0.1) before cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1)
        self.bn = batch_norm(2 * c_)
        self.act = nn.LeakyReLU(0.1)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(self.act(self.bn(y)))


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference layout: separate cv1/cv2).
    ``inner(c_)`` builds the stack ``m`` in place of the n Bottlenecks (the
    C3SPP, C3Ghost and C3TR variants)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5,
                 inner: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, 1)
        self.m = inner(c_) if inner is not None else nn.Sequential(
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


class SPPF(nn.Module):
    """Serial-pool SPP (common.py:188-203): three chained k x k max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k))
        return self.cv2(torch.cat(ys, 1))


class C3SPP(C3):
    """C3 with an SPP as its inner stack (common.py:156-161)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 1, True, g, e,
                         inner=lambda c_: SPP(c_, c_, k))


class GhostConv(nn.Module):
    """GhostNet conv (common.py:630-639): a primary conv to c2/2 and a
    cheap 5x5 depthwise conv of it, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, None, g, act=act)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (common.py:642-655): GhostConv, a stride-2 DWConv
    when s is 2, GhostConv; the shortcut is a DWConv + 1x1 conv at s 2, the
    input where the widths agree, else none."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                       ConvBnAct(c1, c2, 1, 1, act=False))
                         if s == 2 else nn.Identity())
        self.add = s == 2 or c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + self.shortcut(x) if self.add else y


class C3Ghost(C3):
    """C3 with GhostBottlenecks as its inner stack (common.py:164-169)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, inner=lambda c_: (
            nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))))


class TransformerLayer(nn.Module):
    """ViT-style layer without LayerNorm (common.py:65-79) over (L, B, C)
    tokens: multi-head attention of the q/k/v projections plus the input,
    then two bias-free linears plus their input."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ma(self.q(x), self.k(x), self.v(x), need_weights=False)[0] + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """A 1x1 ConvBnAct where the widths differ, then TransformerLayers over
    the map's pixels as tokens, row-major, with a learned linear embedding
    added (common.py:82-98)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = ConvBnAct(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(
            *(TransformerLayer(c2, num_heads) for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, _, h, w = x.shape
        p = x.flatten(2).permute(2, 0, 1)  # (H*W, B, C)
        p = self.tr(p + self.linear(p))
        return p.permute(1, 2, 0).reshape(b, self.c2, h, w)


class C3TR(C3):
    """C3 with a 4-head TransformerBlock of n layers as its inner stack
    (common.py:148-153)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e,
                         inner=lambda c_: TransformerBlock(c_, c_, 4, n))


class CrossConv(nn.Module):
    """1xk then kx1 conv, each with BN and SiLU, with an optional residual
    (experimental.py:11-22). Its BNs run on any map, as in the JAX
    package."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnSiLU(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnSiLU(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2 and s == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class MixConv2d(nn.Module):
    """Mixed-kernel conv (experimental.py:39-55, equal channel split):
    bias-free convs of sizes ``k`` side by side, BN, SiLU (the JAX
    package's activation; no residual)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3),
                 s: int = 1):
        super().__init__()
        n = len(k)
        idx = np.floor(np.linspace(0, n - 1e-6, c2)).astype(int)
        ch = [int((idx == g).sum()) for g in range(n)]
        self.m = nn.ModuleList(
            nn.Conv2d(c1, ch[g], k[g], s, k[g] // 2, bias=False)
            for g in range(n))
        self.bn = batch_norm(c2)
        self.act = nn.SiLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(torch.cat([m(x) for m in self.m], 1)))


class Contract(nn.Module):
    """Pixel-unshuffle (common.py:658-668): (B, C, H, W) -> (B, C*g*g, H/g,
    W/g), channels ordered (row phase, column phase, C)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.gain
        x = x.view(b, c, h // g, g, w // g, g).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * g * g, h // g, w // g)


class Expand(nn.Module):
    """Pixel-shuffle, the inverse of Contract (common.py:671-683)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.gain
        x = x.view(b, g, g, c // g ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // g ** 2, h * g, w * g)


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

    def forward(self, xs) -> torch.Tensor:
        """``xs``: one map, or a list of maps to concatenate first."""
        x = torch.cat(list(xs), 1) if isinstance(xs, (list, tuple)) else xs
        feat = self.convblk(x)
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


class ASPP(nn.Module):
    """Parallel branches on the input (common.py:268-310): a 1x1 ConvBnAct
    and three dilated 3x3s to c1 // map_reduce each, plus the global branch
    if ``has_global``, concatenated into a 1x1 ConvBnAct."""

    def __init__(self, c1: int, c2: int, d: Sequence[int] = (3, 6, 9),
                 has_global: bool = True, map_reduce: int = 4):
        super().__init__()
        hid = c1 // map_reduce
        self.branch0 = nn.Sequential(ConvBnAct(c1, hid, 1, 1))
        self.branch1 = DilatedConvBnSiLU(c1, hid, d[0])
        self.branch2 = DilatedConvBnSiLU(c1, hid, d[1])
        self.branch3 = DilatedConvBnSiLU(c1, hid, d[2])
        self.branch4 = GlobalBranch(c1, hid) if has_global else None
        self.ConvLinear = ConvBnAct(hid * (5 if has_global else 4), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [self.branch0(x), self.branch1(x), self.branch2(x),
                 self.branch3(x)]
        if self.branch4 is not None:
            feats.append(self.branch4(x, x.shape[2:]))
        return self.ConvLinear(torch.cat(feats, 1))


class RFB2(nn.Module):
    """Cascaded-dilation block of the PSP and BiSe heads
    (common.py:504-545): branch0 = 1x1 + 3x3, branch1 = dilated d0 on
    branch0, branch2 = dilated d1 on branch1, branch3 = a 1x1 on the input,
    and if ``has_global`` a global branch fed from branch2."""

    def __init__(self, c1: int, c2: int, map_reduce: int = 4,
                 d: Sequence[int] = (2, 3), has_global: bool = False):
        super().__init__()
        inter = c1 // map_reduce
        self.branch0 = nn.Sequential(ConvBnAct(c1, inter, 1, 1),
                                     ConvBnAct(inter, inter, 3, 1))
        self.branch1 = DilatedConvBnSiLU(inter, inter, d[0])
        self.branch2 = DilatedConvBnSiLU(inter, inter, d[1])
        self.branch3 = nn.Sequential(ConvBnAct(c1, inter, 1, 1))
        self.branch4 = GlobalBranch(inter, inter) if has_global else None
        self.ConvLinear = ConvBnAct(inter * (5 if has_global else 4), c2, 1,
                                    1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.branch0(x)
        x1 = self.branch1(x0)
        x2 = self.branch2(x1)
        feats = [x0, x1, x2, self.branch3(x)]
        if self.branch4 is not None:
            feats.append(self.branch4(x2, x.shape[2:]))
        return self.ConvLinear(torch.cat(feats, 1))


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
