"""Detection and segmentation heads (torch.nn, NCHW inputs).

Counterpart of ``desenet_tpu/models/heads.py``: ``Detect`` and the shipped
``SegMaskPSP2`` head. State-dict names are the reference's (``m.{i}`` for
the Detect convs; ``m8.0``/``m16.0``/``m32.0``, ``spatial_path``,
``context_path``, ``ffm``, ``out.0`` for the seg head).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from desenet_tpu_torch.models.layers import (
    ACSP,
    FFM,
    ConvBnAct,
    PyramidPooling,
)
from desenet_tpu_torch.ops.resize import resize_bilinear


def detect_bias_init(na: int, no: int, stride: float, fan_in: int,
                     generator: torch.Generator) -> torch.Tensor:
    """torch-uniform base plus the focal prior of the reference Detect init:
    obj += log(8/(640/stride)^2), cls += log(0.6/(nc-0.99)). Returns the
    (na*no,) bias on the CPU."""
    nc = no - 5
    bound = 1.0 / math.sqrt(fan_in)
    b = torch.empty(na, no).uniform_(-bound, bound, generator=generator)
    b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
    if nc > 1:
        b[:, 5:] += math.log(0.6 / (nc - 0.99))
    return b.view(-1)


def anchors_grid_units(anchors, strides) -> np.ndarray:
    """(nl, na, 2) f32 anchors in grid units from the config's (nl, na*2)
    pixel anchors and the per-scale strides."""
    a = np.asarray(anchors, np.float32).reshape(len(strides), -1, 2)
    return a / np.asarray(strides, np.float32)[:, None, None]


class Detect(nn.Module):
    """Anchor-based multi-scale detection head with the inference decode.

    ``forward(xs)`` takes the per-scale NCHW feature maps and returns
    ``(decoded (B, A, 5+nc), feats [per-scale (B, na, ny, nx, no)])``, the
    JAX head's eval-mode outputs; in training mode only ``feats``, with no
    decode, which the detection loss consumes. ``A`` runs over scale, anchor, y, x in
    that order, so NMS picks break ties as in the JAX package. With
    ``decode_cat=False`` ``decoded`` is the per-scale list of
    (B, A_s, 5+nc) decodes, for the scale-local NMS prefilter."""

    def __init__(self, nc: int, anchors: Sequence[Sequence[float]],
                 ch: Sequence[int], strides: Sequence[int],
                 decode_cat: bool = True):
        super().__init__()
        self.decode_cat = decode_cat
        self.nc = nc
        self.no = nc + 5
        self.nl = len(anchors)
        self.na = len(anchors[0]) // 2
        self.strides = tuple(float(s) for s in strides)
        # f32 constants outside the module's buffers, so that casting the
        # model to bf16 does not round the anchors (373 -> 372)
        self._anchors_px = np.asarray(anchors, np.float32).reshape(
            self.nl, self.na, 2)
        self._consts = {}
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)

    def anchors_grid_units(self) -> np.ndarray:
        """(nl, na, 2) anchors divided by stride: what the detection loss
        consumes (yolo.py:316)."""
        return anchors_grid_units(self._anchors_px, self.strides)

    def _grid_and_anchors(self, i: int, ny: int, nx: int,
                          device: torch.device):
        """(1,1,ny,nx,2) cell grid (gx, gy) and (1,na,1,1,2) pixel anchors of
        scale i, f32 on ``device``, cached."""
        key = (i, ny, nx, device)
        if key not in self._consts:
            gy, gx = np.meshgrid(np.arange(ny, dtype=np.float32),
                                 np.arange(nx, dtype=np.float32),
                                 indexing="ij")
            grid = np.stack([gx, gy], axis=-1)[None, None]
            anchor = self._anchors_px[i][None, :, None, None, :]
            self._consts[key] = (torch.from_numpy(grid).to(device),
                                 torch.from_numpy(anchor).to(device))
        return self._consts[key]

    def forward(self, xs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats, decoded = [], []
        for i, x in enumerate(xs):
            y = self.m[i](x)
            b, _, ny, nx = y.shape
            # channel = anchor * no + field: na is the major factor
            y = y.view(b, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2)
            feats.append(y)
            if self.training:
                continue
            grid, anchor = self._grid_and_anchors(i, ny, nx, y.device)
            s = torch.sigmoid(y.float())
            xy = (s[..., 0:2] * 2.0 - 0.5 + grid) * self.strides[i]
            wh = (s[..., 2:4] * 2.0) ** 2 * anchor
            z = torch.cat([xy, wh, s[..., 4:]], -1)
            decoded.append(z.reshape(b, -1, self.no))
        if self.training:
            return feats
        if not self.decode_cat:
            return decoded, feats
        return torch.cat(decoded, 1), feats


def _seg_stem(head: "SegMaskPSP2", xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The m8/m16/m32 stem: 1x1 ConvBnAct to c_hid per level, 2x/4x
    align_corners bilinear upsample of the deeper levels, channel concat
    (the JAX package's ``_SegStem``)."""
    f8 = head.m8(xs[0])
    hw = f8.shape[2:]
    f16 = resize_bilinear(head.m16(xs[1]), hw, align_corners=True)
    f32 = resize_bilinear(head.m32(xs[2]), hw, align_corners=True)
    return torch.cat([f8, f16, f32], 1)


class SegMaskPSP2(nn.Module):
    """The shipped seg head: stem -> dual path {spatial = ACSP(has_global),
    context = 1x1 (c_hid/6) -> PyramidPooling} -> FFM -> 1x1 class conv ->
    8x bilinear upsample (align_corners=True).

    ``upsample=False`` returns the 1/8-resolution logits the served program
    feeds to the seg-tail kernel (``ops/seg_pallas.py``)."""

    def __init__(self, ch: Sequence[int], n_segcls: int = 19, c_hid: int = 256,
                 upsample: bool = True):
        super().__init__()
        map_reduce = 6
        c_ctx = c_hid // map_reduce
        self.upsample = upsample
        self.m8 = nn.Sequential(ConvBnAct(ch[0], c_hid, 1))
        self.m16 = nn.Sequential(ConvBnAct(ch[1], c_hid, 1))
        self.m32 = nn.Sequential(ConvBnAct(ch[2], c_hid, 1))
        self.spatial_path = ACSP(3 * c_hid, c_hid, map_reduce=map_reduce,
                                 d=(2, 3), has_global=True)
        self.context_path = nn.Sequential(
            ConvBnAct(3 * c_hid, c_ctx, 1, 1),
            PyramidPooling(c_ctx, k=(1, 2, 3, 6), short_cut=False))
        self.ffm = FFM(c_hid + 4 * (c_ctx // 4), c_hid, k=3)
        self.out = nn.Sequential(nn.Conv2d(c_hid, n_segcls, 1, bias=True))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        feat = _seg_stem(self, xs)
        out = self.out(self.ffm([self.spatial_path(feat),
                                 self.context_path(feat)]))
        if not self.upsample:
            return out
        h, w = out.shape[2:]
        return resize_bilinear(out, (h * 8, w * 8), align_corners=True)
