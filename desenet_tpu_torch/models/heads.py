"""Detection and segmentation heads (torch.nn, NCHW inputs).

Counterpart of ``desenet_tpu/models/heads.py``: ``Detect``, the shipped
``SegMaskPSP2`` head and the four other seg heads (``SegMaskPSP``,
``SegMaskBiSe``, ``SegMaskLab``, ``SegMaskBase``). State-dict names are the
reference's (``m.{i}`` for the Detect convs; for SegMaskPSP2 ``m8.0``/
``m16.0``/``m32.0``, ``spatial_path``, ``context_path``, ``ffm``, ``out.0``;
the others' in their docstrings).

``Segment`` and ``Proto`` are YOLOv5 v7.0's instance-segmentation head
(``models/yolo.py`` Segment, ``models/common.py`` Proto; no JAX
counterpart): ``Detect`` with ``nm`` mask coefficients behind each
anchor's classes, and mask prototypes at 1/4 of the input from the P3
map. State-dict names are v7.0's (``m.{i}``, ``proto.cv1``/``cv2``/
``cv3``).

Every seg head takes ``upsample``: False returns the 1/8-resolution logits
that the served program feeds to the seg-tail kernel
(``ops/seg_pallas.py``), True their 8x align_corners bilinear upsample.
SegMaskBiSe in training always upsamples and returns ``[out, aux16,
aux32]``; SegMaskBiSe and SegMaskBase apply ``layers.Dropout(0.1)`` before
their class conv in training.

SegMaskPSP2 and SegMaskPSP have ``qforward`` (``layers.QuantAware``): the
JAX package's int8 head (the stem resized in int8 and kept as an implicit
concat, the class conv an int8 conv with bias and fp logits out), its
calibration and its fp8 storage. SegMaskBiSe, SegMaskLab and SegMaskBase
have a ``qforward`` too, their fp8-storage forward (every block stores,
the adds, resizes and class convs upcast first, as in the JAX package);
in the int8 program they run in fp on dequantized inputs. Detect always
runs in fp.

Under a spatial scope (``parallel/spatial.py``) the heads run on height
bands: their convs and pools as ``layers`` says, the 2x and 4x
align_corners upsamples within a head on the band
(``resize_bilinear_band``), and each head's outputs gathered whole onto
every spatial rank (``gather_rows``) before the final 8x upsample, so
that the losses and the seg tail see whole maps. Detect is 1x1 convs;
the model walker gathers its inputs (``models/build.py``). Dropout draws
its mask over the band, so BiSe and Base in training are not bitwise the
one-process program.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.models.layers import (
    ACSP,
    ASPP,
    C3,
    C3SPP,
    FFM,
    RFB2,
    Conv2d,
    ConvBnAct,
    Dropout,
    PyramidPooling,
    QuantAware,
    int8_block,
    maybe_cat,
    qt_maybe_cat,
    resize_store,
    to_compute,
)
from desenet_tpu_torch.ops import int8_conv
from desenet_tpu_torch.ops.conv_epilogue import (conv_epilogue_phases,
                                                 fold_phases)
from desenet_tpu_torch.ops.resize import (resize_bilinear,
                                          resize_bilinear_band,
                                          upsample_nearest,
                                          upsample_nearest_repeat)
from desenet_tpu_torch.parallel.spatial import active, gather_rows
from desenet_tpu_torch.quant import QTensor
from desenet_tpu_torch.utils.profiling import count, span


def detect_bias_init(na: int, no: int, stride: float, fan_in: int,
                     generator: torch.Generator, nc: int = None
                     ) -> torch.Tensor:
    """torch-uniform base plus the focal prior of the reference Detect init:
    obj += log(8/(640/stride)^2), cls += log(0.6/(nc-0.99)) on the ``nc``
    class columns (default: every column after obj; a Segment head's mask
    coefficients keep the uniform base, as v7.0's ``_initialize_biases``
    leaves them). Returns the (na*no,) bias on the CPU."""
    nc = no - 5 if nc is None else nc
    bound = 1.0 / math.sqrt(fan_in)
    b = torch.empty(na, no).uniform_(-bound, bound, generator=generator)
    b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
    if nc > 1:
        b[:, 5:5 + nc] += math.log(0.6 / (nc - 0.99))
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
            yf = y.float()
            nd = 5 + self.nc  # the sigmoid's columns; a Segment's rest raw
            s = torch.sigmoid(yf if nd == self.no else yf[..., :nd])
            xy = (s[..., 0:2] * 2.0 - 0.5 + grid) * self.strides[i]
            wh = (s[..., 2:4] * 2.0) ** 2 * anchor
            z = torch.cat([xy, wh, s[..., 4:]]
                          + ([] if nd == self.no else [yf[..., nd:]]), -1)
            decoded.append(z.reshape(b, -1, self.no))
        if self.training:
            return feats
        if not self.decode_cat:
            return decoded, feats
        return torch.cat(decoded, 1), feats


class Proto(nn.Module):
    """YOLOv5 v7.0's mask prototypes (``models/common.py`` Proto): a 3x3
    ConvBnAct, a nearest 2x upsample, a 3x3 ConvBnAct and a 1x1 ConvBnAct
    to ``c2`` prototypes, so (B, c1, H/8, W/8) -> (B, c2, H/4, W/4).
    ``qforward``: under fp8 storage each conv stores its output and the
    upsample repeats the stored values.

    After ``fuse_phases`` (``DeSeNet.fuse``) an eval call without autograd
    runs the upsample and ``cv2`` as one 2x2 conv of the folded weight
    over the small map and the phase pass
    (``ops/conv_epilogue.py``: ``fold_phases``, ``conv_epilogue_phases``),
    so the 2x map is written once, by that pass. The folded weight is
    among ``cv2``'s derived constants (``layers.QuantAware``), under
    "phases": moving, reloading or ``train(True)`` drops it, and the
    upsample and conv run apart again. While tracing, each eval call adds
    1 to the counter ``proto.phased`` (after the pass) or ``proto.plain``.
    """

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c_, 3)
        self.cv2 = ConvBnAct(c_, c_, 3)
        self.cv3 = ConvBnAct(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        if not self.training:
            k = self.cv2._derived.get("phases")
            if k is not None and not torch.is_grad_enabled():
                y = conv_epilogue_phases(F.conv2d(y, k, padding=1),
                                         *self.cv2._derived["epilogue"])
                count("proto.phased", 1)
                return self.cv3(y)
            count("proto.plain", 1)
        return self.cv3(self.cv2(upsample_nearest(y, 2)))

    def fuse_phases(self) -> None:
        """Keep ``cv2``'s weight folded with the upsample
        (``fold_phases``), in the weight's layout, and its BN's affine
        (``ConvBnAct.fuse_epilogue``), for ``forward``'s phase path."""
        self.cv2.fuse_epilogue()
        w = self.cv2.conv.weight
        k = fold_phases(w)
        if w.is_contiguous(memory_format=torch.channels_last):
            k = k.contiguous(memory_format=torch.channels_last)
        self.cv2._derived["phases"] = k

    def qforward(self, x: torch.Tensor) -> torch.Tensor:
        y = upsample_nearest_repeat(self.cv1.qforward(x), 2)
        return self.cv3.qforward(self.cv2.qforward(y))


class Segment(Detect):
    """YOLOv5 v7.0's instance-segmentation head (``models/yolo.py``
    Segment): ``Detect`` with ``no = 5 + nc + nm`` columns an anchor, the
    last ``nm`` a mask's coefficients, and ``Proto(ch[0], npr, nm)`` on the
    first (P3) map. The decode applies the sigmoid to columns 0 to 4 + nc
    and leaves the coefficients raw, in float32.

    ``forward(xs)`` returns ``((decoded, feats), proto)``, proto (B, nm,
    2 H3, 2 W3) in the maps' dtype (in training ``(feats, proto)``).
    With tracing on and the maps on a card, Proto is the device span
    ``forward.proto``."""

    def __init__(self, nc: int, anchors: Sequence[Sequence[float]], nm: int,
                 npr: int, ch: Sequence[int], strides: Sequence[int],
                 decode_cat: bool = True):
        super().__init__(nc, anchors, ch, strides, decode_cat=decode_cat)
        self.nm = nm
        self.no = 5 + nc + nm
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, xs: Sequence[torch.Tensor]):
        with span("forward.proto", device=xs[0].device):
            p = self.proto(xs[0])
        return super().forward(xs), p

    def qforward(self, xs: Sequence[torch.Tensor]):
        """Under fp8 storage: Proto's convs store their outputs (the
        prototypes come back in the maps' dtype); the detection part runs
        as ``forward``, on the fp maps that feed it."""
        with span("forward.proto", device=xs[0].device):
            p = to_compute(self.proto.qforward(xs[0]), xs[0].dtype)
        return super().forward(xs), p


def _up(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``scale``x bilinear upsample, align_corners=True (of a band: its
    band of the result)."""
    return resize_bilinear_band(x, scale)


def _out(x: torch.Tensor, scale: int, upsample: bool = True) -> torch.Tensor:
    """A head's output: the whole map (``gather_rows`` of a band), its
    ``scale``x align_corners upsample where ``upsample``."""
    x = gather_rows(x)
    if not upsample:
        return x
    h, w = x.shape[2:]
    return resize_bilinear(x, (h * scale, w * scale), align_corners=True)


def _stem_up(x: torch.Tensor, hw) -> torch.Tensor:
    """A deeper stem level resized to the 1/8 map's ``hw``
    (align_corners)."""
    if active():  # bands of one rank keep the levels' ratio
        return resize_bilinear_band(x, int(hw[0]) // x.shape[2])
    return resize_bilinear(x, hw, align_corners=True)


def _seg_stem(head: nn.Module, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The m8/m16/m32 stem: 1x1 ConvBnAct to c_hid per level, 2x/4x
    align_corners bilinear upsample of the deeper levels, channel concat
    (the JAX package's ``_SegStem``)."""
    f8 = head.m8(xs[0])
    hw = f8.shape[2:]
    f16 = _stem_up(head.m16(xs[1]), hw)
    f32 = _stem_up(head.m32(xs[2]), hw)
    return torch.cat([f8, f16, f32], 1)


def _seg_stem_q(head, xs):
    """``_seg_stem`` of ``qforward``: the deeper levels resized at their
    own scale in int8, the three kept as an implicit concat where every
    part is wide enough (``qt_maybe_cat`` / ``maybe_cat``)."""
    f8 = head.m8[0].qforward(xs[0])
    f16 = head.m16[0].qforward(xs[1])
    f32 = head.m32[0].qforward(xs[2])
    if isinstance(f8, QTensor):
        hw = f8.data.shape[2:]
        f16 = Q.qt_resize_bilinear(f16, hw, align_corners=True)
        f32 = Q.qt_resize_bilinear(f32, hw, align_corners=True)
        return qt_maybe_cat([f8, f16, f32])
    hw = f8.shape[2:]
    return maybe_cat([f8, resize_store(f16, hw), resize_store(f32, hw)])


def _seg_out_q(head, conv: nn.Conv2d, fused):
    """The 1x1 class conv of ``qforward``: on an int8 map an int8 conv with
    bias and fp logits out (no output requant), in the compute dtype."""
    if isinstance(fused, QTensor):
        dt = head.cdtype or conv.weight.dtype

        def make(scales, chans):
            return int8_conv.prepare(conv.weight, scales, chans,
                                     bias=conv.bias)

        return int8_block(head, "out", fused, make, out_dtype=dt)
    return conv(to_compute(fused, conv.weight.dtype))


class SegMaskPSP2(QuantAware, nn.Module):
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
        return _out(out, 8, self.upsample)

    def qmap(self) -> dict:
        return {"m8.0": "stem/m8", "m16.0": "stem/m16", "m32.0": "stem/m32",
                "spatial_path": "spatial_path",
                "context_path.0": "context_red",
                "context_path.1": "context_pp", "ffm": "ffm"}

    def qforward(self, xs):
        feat = _seg_stem_q(self, xs)
        spatial = self.spatial_path.qforward(feat)
        ctx = self.context_path[1].qforward(
            self.context_path[0].qforward(feat))
        out = _seg_out_q(self, self.out[0],
                         self.ffm.qforward([spatial, ctx]))
        return _up(out, 8) if self.upsample else out


class SegMaskPSP(QuantAware, nn.Module):
    """PSP head (yolo.py:156-197): the m8/m16/m32 stem -> RFB2(map_reduce
    6) -> PyramidPooling(short_cut) -> FFM(k=3) -> 1x1 class conv, as
    ``out.0`` to ``out.3``."""

    def __init__(self, ch: Sequence[int], n_segcls: int = 19, n: int = 1,
                 c_hid: int = 256, shortcut: bool = False,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.m8 = nn.Sequential(ConvBnAct(ch[0], c_hid, 1))
        self.m16 = nn.Sequential(ConvBnAct(ch[1], c_hid, 1))
        self.m32 = nn.Sequential(ConvBnAct(ch[2], c_hid, 1))
        self.out = nn.Sequential(
            RFB2(3 * c_hid, c_hid, map_reduce=6, d=(2, 3)),
            PyramidPooling(c_hid, k=(1, 2, 3, 6), short_cut=True),
            FFM(c_hid + 4 * (c_hid // 4), c_hid, k=3),
            nn.Conv2d(c_hid, n_segcls, 1))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = self.out(_seg_stem(self, xs))
        return _out(out, 8, self.upsample)

    def qmap(self) -> dict:
        return {"m8.0": "stem/m8", "m16.0": "stem/m16", "m32.0": "stem/m32",
                "out.0": "rfb", "out.1": "pp", "out.2": "ffm"}

    def qforward(self, xs):
        y = self.out[0].qforward(_seg_stem_q(self, xs))
        y = self.out[2].qforward(self.out[1].qforward(y))
        out = _seg_out_q(self, self.out[3], y)
        return _up(out, 8) if self.upsample else out


class SegMaskBiSe(nn.Module):
    """BiSeNet-style head (yolo.py:35-91), 128 channels wide at any width:
    ``m8.0`` a 1x1 ConvBnAct, ``m16.0``/``m32.0`` RFB2 (the deeper one with
    a global branch), ``up32.0``/``up16.0`` 3x3 refines each followed by a
    2x upsample, ``out`` = FFM, Dropout, 1x1 class conv; in training also
    the aux heads ``aux16``/``aux32`` (3x3 ConvBnAct, 1x1 class conv) on the
    refined 1/8 and 1/16 maps, upsampled to full resolution."""

    def __init__(self, ch: Sequence[int], n_segcls: int = 19, n: int = 1,
                 c_hid: int = 256, shortcut: bool = False,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.m8 = nn.Sequential(ConvBnAct(ch[0], 128, 1))
        self.m16 = nn.Sequential(RFB2(ch[1], 128, map_reduce=4, d=(2, 3)))
        self.m32 = nn.Sequential(RFB2(ch[2], 128, map_reduce=8, d=(2, 3),
                                      has_global=True))
        self.up32 = nn.Sequential(ConvBnAct(128, 128, 3))
        self.up16 = nn.Sequential(ConvBnAct(128, 128, 3))
        self.out = nn.Sequential(FFM(256, 256, k=3), Dropout(0.1),
                                 nn.Conv2d(256, n_segcls, 1))
        self.aux16 = nn.Sequential(ConvBnAct(128, 128, 3),
                                   nn.Conv2d(128, n_segcls, 1))
        self.aux32 = nn.Sequential(ConvBnAct(128, 128, 3),
                                   nn.Conv2d(128, n_segcls, 1))

    def forward(self, xs: Sequence[torch.Tensor]):
        f8 = self.m8(xs[0])
        feat3 = _up(self.up32(self.m32(xs[2])), 2)
        feat2 = _up(self.up16(self.m16(xs[1]) + feat3), 2)
        out = self.out([f8, feat2])
        if not self.training:
            return _out(out, 8, self.upsample)
        return [_out(out, 8), _out(self.aux16(feat2), 8),
                _out(self.aux32(feat3), 16)]

    def qforward(self, xs):
        """Eval under fp8 storage: the convs and RFB2s store; the add and
        the 2x resizes take the JAX package's fp8 form (``resize_store``)."""
        f8 = self.m8[0].qforward(xs[0])
        feat3 = self.up32[0].qforward(self.m32[0].qforward(xs[2]))
        feat3 = resize_store(feat3, [2 * v for v in feat3.shape[2:]])
        dt = self.up16[0].conv.weight.dtype
        feat2 = self.up16[0].qforward(to_compute(self.m16[0].qforward(xs[1]),
                                                 dt) + to_compute(feat3, dt))
        feat2 = resize_store(feat2, [2 * v for v in feat2.shape[2:]])
        out = _seg_out_q(self, self.out[2], self.out[0].qforward([f8, feat2]))
        return _out(out, 8, self.upsample)

    def train_only_prefixes(self):
        return ["aux16.", "aux32."]


class SegMaskLab(nn.Module):
    """DeepLabV3+-style head (yolo.py:98-129): ``detail`` (1x1 and 3x3
    ConvBnAct to 48 at 1/8), ``encoder`` (1x1 ConvBnAct to 2 c_hid, then
    ASPP to 256 with map_reduce 5 - n, at 1/16, upsampled 2x), ``decoder``
    (FFM(k=1) over both, 3x3 ConvBnAct to c_hid, 1x1 class conv)."""

    def __init__(self, ch: Sequence[int], n_segcls: int = 19, n: int = 1,
                 c_hid: int = 256, shortcut: bool = False,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.detail = nn.Sequential(ConvBnAct(ch[0], 48, 1),
                                    ConvBnAct(48, 48, 3))
        self.encoder = nn.Sequential(
            ConvBnAct(ch[1], c_hid * 2, 1),
            ASPP(c_hid * 2, 256, d=(3, 6, 9), has_global=False,
                 map_reduce=5 - n))
        self.decoder = nn.Sequential(FFM(48 + 256, 256, k=1),
                                     ConvBnAct(256, c_hid, 3),
                                     nn.Conv2d(c_hid, n_segcls, 1))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = self.decoder([self.detail(xs[0]), _up(self.encoder(xs[1]), 2)])
        return _out(out, 8, self.upsample)

    def qforward(self, xs):
        """Eval under fp8 storage (see ``SegMaskBiSe.qforward``)."""
        detail = self.detail[1].qforward(self.detail[0].qforward(xs[0]))
        enc = self.encoder[1].qforward(self.encoder[0].qforward(xs[1]))
        enc = resize_store(enc, [2 * v for v in enc.shape[2:]])
        y = self.decoder[1].qforward(self.decoder[0].qforward([detail, enc]))
        return _out(_seg_out_q(self, self.decoder[2], y), 8, self.upsample)


class SegMaskBase(nn.Module):
    """Single-input head (yolo.py:134-153) as ``m``: C3(c_hid, n), C3SPP to
    1.5 c_hid, Dropout, a bias-free 3x3 class conv."""

    def __init__(self, ch: Sequence[int], n_segcls: int = 19, n: int = 1,
                 c_hid: int = 256, shortcut: bool = False,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        c_spp = int(c_hid * 1.5)
        self.m = nn.Sequential(
            C3(ch[0], c_hid, n, shortcut), C3SPP(c_hid, c_spp, (5, 9, 13)),
            Dropout(0.1), Conv2d(c_spp, n_segcls, 3, 1, 1, bias=False))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return _out(self.m(xs[0]), 8, self.upsample)

    def qforward(self, xs):
        """Eval under fp8 storage: the C3 (its ``cv12`` form) and the C3SPP
        store; the class conv upcasts."""
        y = self.m[1].qforward(self.m[0].qforward(xs[0]))
        return _out(_seg_out_q(self, self.m[3], y), 8, self.upsample)
