"""Model DSL -> torch.nn model.

Counterpart of ``desenet_tpu/models/build.py``: the same row DSL
(``[from, number, module, args]`` with depth/width multiples) compiled ahead
of time into a static ``ModelSpec``, and a ``DeSeNet`` module that walks it.
Every row the JAX package's DSL knows builds here.

A Focus row is built as the reference's slice-concat plus kxk conv by
default (``LayerSpec.name`` ``"Focus"``), so that state dicts keep the
reference's names; ``fuse_focus=True`` builds it as the JAX package does by
default, one (2k)x(2k)/s2 conv on the raw image (``"FusedFocus"``).

``build_model(quant=...)`` builds the int8 W8A8 inference model, its
calibration model or its weights-only ablation (``quant.QuantCfg``);
``act_store="fp8"`` the fp8 activation-storage model, of any config. Their
eval forward is the JAX walker's (``DeSeNet.forward``).

``build_model(stem_s2d=True)`` builds the JAX package's phase-layout stem:
rows 0 and 1 (a FusedFocus(6, 2, 2) on the input and a 3x3/s2 Conv on it,
``_check_stem_s2d``) become ``layers.PhaseStemA``/``PhaseStemB``, which
take the input in space-to-depth-4 layout (``ops/s2d.py``) and own the
same parameters under the same keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.models import heads as H
from desenet_tpu_torch.models import layers as L
from desenet_tpu_torch.ops.resize import (resize_bilinear, upsample_nearest,
                                          upsample_nearest_repeat)
from desenet_tpu_torch.ops.seg_head_pallas import MAX_P8, fused_psp2_eval
from desenet_tpu_torch.parallel import spatial
from desenet_tpu_torch.utils.profiling import count, span

# width-scaled blocks take their output width first; the C3-like ones
# repeat their inner stack n times, the others repeat as a whole
_BLOCKS_WITH_WIDTH = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF",
    "DWConv", "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3",
    "C3TR", "C3SPP", "C3Ghost",
}
_REPEAT_INNER = {"BottleneckCSP", "C3", "C3TR", "C3Ghost"}
# blocks whose stride is their args[2] (args[0] being the output width)
_STRIDED = {"Conv", "DWConv", "GhostConv", "CrossConv", "MixConv2d",
            "GhostBottleneck"}
SEG_HEADS = {"SegMaskLab", "SegMaskBase", "SegMaskPSP", "SegMaskPSP2",
             "SegMaskBiSe"}
# the detection heads: Detect, and YOLOv5 v7.0's instance-segmentation
# Segment (Detect plus mask coefficients and Proto)
DET_HEADS = {"Detect", "Segment"}
_MIN_ARGS = {"nn.Upsample": 2, "Detect": 2, "Segment": 2, "Contract": 1,
             "Expand": 1, **{h: 1 for h in SEG_HEADS}}
_BLOCKS = {
    "Conv": L.ConvBnAct, "GhostConv": L.GhostConv,
    "Bottleneck": L.Bottleneck, "GhostBottleneck": L.GhostBottleneck,
    "SPP": L.SPP, "SPPF": L.SPPF, "DWConv": L.DWConv,
    "MixConv2d": L.MixConv2d, "Focus": L.Focus, "FusedFocus": L.FusedFocus,
    "CrossConv": L.CrossConv, "BottleneckCSP": L.BottleneckCSP, "C3": L.C3,
    "C3TR": L.C3TR, "C3SPP": L.C3SPP, "C3Ghost": L.C3Ghost,
}


# rows that carry QTensors through the int8 path (the JAX walker's
# _QUANT_AWARE); every other row gets dequantized inputs and runs in fp
QUANT_AWARE = frozenset({
    "Conv", "C3", "Focus", "FusedFocus", "SPP", "SPPF", "Bottleneck",
    "Upsample", "Concat", "SegMaskPSP", "SegMaskPSP2",
})
_PASSTHROUGH = {"Concat", "Upsample", "Contract", "Expand"}
# nn.Upsample's modes; the JAX package runs "nearest" only
_UPSAMPLE_MODES = ("nearest", "linear", "bilinear", "bicubic", "trilinear",
                   "area", "nearest-exact")
# a P6 model's extra level: the rows at this output stride are timed as the
# device span forward.p6
P6_STRIDE = 64
# the consumers a Concat may hand an implicit concat (a part list)
_SPLIT_CONSUMERS = {"C3", "Conv", "C3TR", "C3Ghost", "BottleneckCSP", "SPP",
                    "SPPF"}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    i: int
    f: Tuple[int, ...]  # absolute 'from' layer indices (-1 = model input)
    name: str  # registry module name
    args: Tuple  # positional args after channel resolution
    c2: int  # output channels
    stride: int  # cumulative stride vs input resolution (0 for heads)
    n: int = 1  # outer repeat count (only for non-inner-repeat modules)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]  # layer indices whose outputs later layers consume
    de_nc: int
    se_nc: int
    anchors: Tuple[Tuple[float, ...], ...]
    det_strides: Tuple[int, ...]
    det_layer: int  # index of Detect layer (-1 if absent)
    seg_layer: int  # index of SegMask layer (-1 if absent)
    ch_in: int = 3


def _round_depth(n: int, gd: float) -> int:
    return max(round(n * gd), 1) if n > 1 else n


def _load_config(path) -> dict:
    path = os.fspath(path)
    with open(path, "r", encoding="utf-8") as fh:
        if path.endswith(".json"):
            return json.load(fh)
        import yaml  # only for .yaml configs; the bundled ones are JSON

        return yaml.safe_load(fh)


def parse_config(cfg, nc: Optional[int] = None,
                 se_nc: Optional[int] = None,
                 anchors: Optional[Sequence] = None,
                 fuse_focus: bool = False) -> ModelSpec:
    """Compile a model dict / .json / .yaml path into a ModelSpec.

    nc / se_nc override the config's class counts, ``anchors`` (pixels,
    any shape that reshapes to (scales, na, 2); autoanchor's output) its
    anchors. ``fuse_focus``: a Focus row becomes ``FusedFocus``, one
    (2k)x(2k)/s2 conv with pad k-1 (the JAX package's default)."""
    if isinstance(cfg, (str, os.PathLike)):
        cfg = _load_config(cfg)
    if not isinstance(cfg, Mapping):
        raise ValueError(
            f"model config must be a mapping, got {type(cfg).__name__}")
    missing = [k for k in ("depth_multiple", "width_multiple", "anchors",
                           "backbone", "head")
               if k not in cfg]
    if nc is None and "de_nc" not in cfg:
        missing.insert(0, "de_nc")
    if missing:
        raise ValueError(
            f"model config missing required key(s) {missing}; expected the "
            "reference schema (de_nc/se_nc, depth_multiple, width_multiple, "
            "anchors, backbone, head; see docs/MODEL_DSL.md)")

    de_nc = int(nc if nc is not None else cfg["de_nc"])
    se_nc = int(se_nc if se_nc is not None else cfg.get("se_nc", 0))
    cfg = dict(cfg)
    cfg["de_nc"] = de_nc
    cfg["se_nc"] = se_nc
    if anchors is not None:
        cfg["anchors"] = [list(np.asarray(a).reshape(-1)) for a in
                          np.asarray(anchors).reshape(len(cfg["anchors"]),
                                                      -1, 2)]
    gd = float(cfg["depth_multiple"])
    gw = float(cfg["width_multiple"])
    anchors = cfg["anchors"]

    chs = [3]  # per-layer output channels (chs[0] = the RGB input)
    strides = [1]  # per-layer cumulative stride
    layers = []
    save = set()
    det_layer = seg_layer = -1
    det_strides: Tuple[int, ...] = ()

    rows = list(cfg["backbone"]) + list(cfg["head"])
    for i, row in enumerate(rows):
        try:
            f, n, mname, args = row
        except (TypeError, ValueError):
            raise ValueError(
                f"model config row {i} must be [from, number, module, args], "
                f"got {row!r}") from None
        if mname not in _BLOCKS_WITH_WIDTH | SEG_HEADS | DET_HEADS | {
                "nn.Upsample", "Concat", "nn.BatchNorm2d", "Contract",
                "Expand"}:
            raise ValueError(f"unknown module {mname!r} in model config row {i}")
        fs = tuple(
            (x if x >= 0 else i + x) for x in (f if isinstance(f, list) else [f])
        )
        if not fs:
            raise ValueError(
                f"row {i} ({mname}): 'from' must name at least one input "
                f"layer, got {f!r}")
        for x in fs:
            if not (-1 <= x < i):
                raise ValueError(
                    f"row {i} ({mname}): 'from' index {x} out of range — "
                    f"must reference the input (-1 relative / earlier layer "
                    f"0..{i - 1})")
        n_rep_req = int(n)
        if not 0 < n_rep_req <= 1000:
            raise ValueError(
                f"row {i} ({mname}): repeat count must be in 1..1000, "
                f"got {n!r}")
        n_out = _round_depth(n_rep_req, gd)
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str) and a in cfg:
                args[j] = cfg[a]
        min_args = _MIN_ARGS.get(
            mname, 1 if mname in _BLOCKS_WITH_WIDTH else 0)
        if len(args) < min_args:
            raise ValueError(
                f"row {i} ({mname}): needs at least {min_args} arg(s), "
                f"got {args!r}")

        in_stride = strides[fs[0] + 1]
        stride = in_stride
        if mname in _BLOCKS_WITH_WIDTH:
            c2 = L.make_divisible(args[0] * gw, 8)
            margs = [c2, *args[1:]]
            if mname in _REPEAT_INNER:
                margs.insert(1, n_out)  # inner repeat count
                n_rep = 1
            else:
                n_rep = n_out
            if mname == "Focus":
                stride = in_stride * 2
                if fuse_focus:
                    k = margs[1] if len(margs) > 1 else 1
                    mname, margs = "FusedFocus", [c2, 2 * k, 2, k - 1]
            elif mname in _STRIDED:
                stride = in_stride * int(margs[2] if len(margs) > 2 else 1)
            spec = LayerSpec(i, fs, mname, tuple(
                tuple(a) if isinstance(a, list) else a for a in margs
            ), c2, stride, n_rep)
        elif mname == "nn.Upsample":
            scale = int(args[1])
            if scale < 1:
                raise ValueError(
                    f"row {i} (nn.Upsample): scale must be >= 1, got {scale}")
            mode = args[2] if len(args) > 2 else "nearest"
            if mode not in _UPSAMPLE_MODES:
                raise ValueError(f"row {i} (nn.Upsample): mode must be one "
                                 f"of {_UPSAMPLE_MODES}, got {mode!r}")
            if mode != "nearest":
                raise NotImplementedError(
                    f"row {i} (nn.Upsample): mode {mode!r} is not ported")
            spec = LayerSpec(i, fs, "Upsample", (scale, mode),
                             chs[fs[0] + 1], in_stride // scale)
        elif mname == "Concat":
            spec = LayerSpec(i, fs, "Concat", (),
                             sum(chs[x + 1] for x in fs), in_stride)
        elif mname == "nn.BatchNorm2d":
            spec = LayerSpec(i, fs, "BatchNorm", (), chs[fs[0] + 1],
                             in_stride)
        elif mname in ("Contract", "Expand"):
            g = int(args[0])
            if g < 1:
                raise ValueError(
                    f"row {i} ({mname}): gain must be >= 1, got {g}")
            c_in = chs[fs[0] + 1]
            spec = (LayerSpec(i, fs, mname, (g,), c_in * g * g,
                              in_stride * g) if mname == "Contract" else
                    LayerSpec(i, fs, mname, (g,), c_in // (g * g),
                              in_stride // g))
        elif mname in DET_HEADS:
            det_layer = i
            det_strides = tuple(strides[x + 1] for x in fs)
            anc = args[1]
            if isinstance(anc, int):  # 'anchors: N' shorthand
                if not 0 < anc <= 64:
                    raise ValueError(
                        f"row {i} ({mname}): 'anchors: N' shorthand must "
                        f"have 0 < N <= 64 anchors per scale, got {anc}")
                anc = [list(range(anc * 2))] * len(fs)
            anchors = anc
            head_args = (int(args[0]),
                         tuple(tuple(float(v) for v in r) for r in anc))
            if mname == "Segment":  # [nc, anchors, nm, npr]: npr scaled
                head_args += (int(args[2]) if len(args) > 2 else 32,
                              L.make_divisible(
                                  (args[3] if len(args) > 3 else 256) * gw,
                                  8))
            spec = LayerSpec(i, fs, mname, head_args, 0, 0)
        else:  # a seg head
            seg_layer = i
            n_seg = _round_depth(int(args[1]), gd) if len(args) > 1 else 1
            c_hid = L.make_divisible(args[2] * gw, 8) if len(args) > 2 else 256
            shortcut = bool(args[3]) if len(args) > 3 else False
            spec = LayerSpec(i, fs, mname,
                             (int(args[0]), n_seg, c_hid, shortcut),
                             int(args[0]), strides[fs[0] + 1])

        layers.append(spec)
        chs.append(spec.c2)
        strides.append(spec.stride)
        for x in fs:
            if x != i - 1:
                save.add(x)

    return ModelSpec(
        layers=tuple(layers),
        save=tuple(sorted(save)),
        de_nc=de_nc,
        se_nc=se_nc,
        anchors=tuple(tuple(float(v) for v in row) for row in anchors),
        det_strides=det_strides,
        det_layer=det_layer,
        seg_layer=seg_layer,
    )


def _instantiate(ls: LayerSpec, c1, spec: ModelSpec, seg_upsample: bool,
                 decode_cat: bool = True) -> nn.Module:
    """LayerSpec -> torch module (nn.Identity for parameterless rows).
    ``c1`` is the input channel count, or the list of them for heads."""
    a = ls.args
    if ls.name in ("Upsample", "Concat"):
        return nn.Identity()
    if ls.name == "Detect":
        return H.Detect(a[0], a[1], c1, spec.det_strides,
                        decode_cat=decode_cat)
    if ls.name == "Segment":
        return H.Segment(a[0], a[1], a[2], a[3], c1, spec.det_strides,
                         decode_cat=decode_cat)
    if ls.name == "SegMaskPSP2":
        # n is ignored, as in the JAX package and the reference
        n_segcls, _, c_hid, _ = a
        return H.SegMaskPSP2(c1, n_segcls=n_segcls, c_hid=c_hid,
                             upsample=seg_upsample)
    if ls.name in SEG_HEADS:
        n_segcls, n, c_hid, shortcut = a
        return getattr(H, ls.name)(c1, n_segcls=n_segcls, n=n, c_hid=c_hid,
                                   shortcut=shortcut, upsample=seg_upsample)
    if ls.name == "BatchNorm":
        return L.batch_norm(c1)
    if ls.name in ("Contract", "Expand"):
        return getattr(L, ls.name)(a[0])
    block = _BLOCKS[ls.name]
    if ls.n > 1:
        # outer repeats mirror the reference's nn.Sequential wrapping
        return nn.Sequential(*(block(c1 if j == 0 else ls.c2, *a)
                               for j in range(ls.n)))
    return block(c1, *a)


def _check_stem_s2d(spec: ModelSpec, quant) -> None:
    """ValueError unless ``stem_s2d`` is an exact rewrite of the model's
    stem: l0 = FusedFocus(k 6, s 2, p 2) on the input, l1 = Conv(k 3, s 2)
    on l0 read by nothing else, and no int8 quant (the JAX package's
    rule)."""
    ok = (
        quant is None
        and len(spec.layers) >= 2
        and spec.layers[0].name == "FusedFocus"
        and tuple(spec.layers[0].args[1:4]) == (6, 2, 2)
        and spec.layers[0].f == (-1,)
        and spec.layers[0].n == 1
        and spec.layers[1].name == "Conv"
        and spec.layers[1].f == (0,)
        and spec.layers[1].n == 1
        and len(spec.layers[1].args) >= 3
        and tuple(spec.layers[1].args[1:3]) == (3, 2)
        and all(a is None or a == 1 or a is True
                for a in spec.layers[1].args[3:])
        and 0 not in spec.save  # nothing downstream reads the phase map
    )
    if not ok:
        raise ValueError(
            "stem_s2d=True requires l0=Focus(k=3)/FusedFocus(6,2,2) on the "
            "input and l1=Conv(k=3,s=2) on l0 (and no int8 quant); this "
            "config does not match — build without stem_s2d")


def det_fp_layers(spec: "ModelSpec", hops: int) -> set:
    """The rows that stay full precision under int8 and fp8 storage: those
    feeding Detect, through pass-through rows (Concat, Upsample, Contract,
    Expand cost no hop), and ``hops - 1`` compute rows further up."""
    srcs = (set(spec.layers[spec.det_layer].f) if spec.det_layer >= 0
            else set())
    budget = {i: int(hops) for i in srcs}
    frontier = list(srcs)
    while frontier:
        i = frontier.pop()
        if i < 0:
            continue
        row = spec.layers[i]
        nb = budget[i] if row.name in _PASSTHROUGH else budget[i] - 1
        if nb <= 0:
            continue
        for j in row.f:
            if j >= 0 and budget.get(j, 0) < nb:
                srcs.add(j)
                budget[j] = nb
                frontier.append(j)
    return srcs


class DeSeNet(nn.Module):
    """The compiled joint detection+segmentation model.

    ``forward(x)`` takes NCHW images in [0, 1] and returns
    ``((decoded (B, A, 5+nc), det_feats [per-scale (B, na, ny, nx, no)]),
    seg)``, the JAX model's eval-mode outputs, with ``seg`` NCHW:
    full-resolution logits, or 1/8-resolution ones when built with
    ``seg_upsample=False``. A model with a ``Segment`` row (YOLOv5 v7.0's
    instance segmentation, ``heads.Segment``) returns ``((decoded (B, A,
    5+nc+nm), det_feats), proto (B, nm, H/4, W/4))`` in its place. In training mode (``.train()``) it returns
    ``(det_feats, seg)`` as the JAX model's ``train=True`` does: no decode,
    BN on batch statistics (``layers.BatchNorm2d``). Module ``model.{i}`` is
    DSL row i.

    ``decode_cat=False``: ``decoded`` is the per-scale list of decodes (the
    NMS front end then selects candidates per scale). ``seg_head_fused``:
    in eval mode a SegMaskPSP2 head with at most ``MAX_P8`` positions at
    1/8 resolution runs as kernel K4 (``ops/seg_head_pallas.py``; its plain
    version on a CPU tensor) instead of the module graph. A SegMaskBiSe
    head in training mode returns ``[out, aux16, aux32]`` as ``seg``.

    ``quant`` (a ``quant.QuantCfg``) or ``act_store`` (a float8 dtype):
    the eval forward carries QTensors or fp8 maps, as the JAX walker's.
    The rows feeding Detect stay fp (``det_fp_layers`` with
    ``det_fp_hops``), and so do Detect and the heads without an int8
    path. ``compute_dtype`` (int8
    and calibration models, whose parameters stay f32 so that the int8
    weights come from f32 ones, as the JAX package's do): the dtype of
    the input and of the fp pieces (``torch.autocast`` around them).

    ``stem_s2d``: rows 0 and 1 are the phase-layout stem
    (``layers.PhaseStemA``/``PhaseStemB``; ValueError where
    ``_check_stem_s2d`` rejects the config) and ``forward`` takes the
    input in space-to-depth-4 layout, (B, 16 ch_in, H/4, W/4) NCHW of
    ``ops.s2d.space_to_depth4``'s (pr, pc, ci) channels. Not under a
    spatial scope (NotImplementedError).

    ``remat``: in training, each DSL row's module (not Upsample, Concat,
    Detect or the seg head; each outer repeat alone) runs under
    ``torch.utils.checkpoint``, as the JAX walker wraps it in ``nn.remat``:
    its activations are recomputed in the backward pass instead of kept
    (``layers.checkpointed``; BN moves its running statistics once). Never
    in eval.

    Under ``parallel.spatial.scope`` the input is this rank's height band
    of the batch and the outputs are whole on every spatial rank (Detect's
    inputs and the seg head's output gathered, ``models/heads.py``, or
    K4's inputs); the quantized and fp8-storage programs refuse a
    scope.

    ``forward`` also takes the uint8 image itself, the (B, 3, H, W)
    channels_last view of a (B, H, W, 3) uint8 batch, where row 0 is a
    served stem that can take it (``layers.ConvBnAct``: an eval bf16 model
    after ``fuse()``, no autograd, neither quantized nor fp8 storage, not
    ``stem_s2d``, no spatial scope; ``uint8_refusal``): row 0 widens it
    and runs conv, BN and SiLU in one pass. Any other uint8 input is a
    ValueError that says why.

    With tracing on (``utils/profiling``) and the input on a card,
    ``forward`` records three kinds of device span (``Span.device_ms``):
    ``forward.stem`` around row 0 (with a uint8 input, the widen too),
    ``forward.seg_head`` around the seg head's row, and ``forward.p6``
    around each run of consecutive rows at output stride 64 (a P6
    model's: rows 9-12 and 30-32 of ``yolov5x6_seg``; none in the P5
    models). An eval forward on a float input counts ``stem.plain``; one
    on a uint8 input counts ``stem.fused`` in ``served_stem``."""

    def __init__(self, spec: ModelSpec, seg_upsample: bool = True,
                 decode_cat: bool = True, seg_head_fused: bool = False,
                 quant=None, act_store=None, det_fp_hops: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, stem_s2d: bool = False):
        super().__init__()
        if stem_s2d:
            _check_stem_s2d(spec, quant)
        self.stem_s2d = stem_s2d
        self.spec = spec
        self.remat = remat
        self.seg_upsample = seg_upsample
        self.seg_head_fused = seg_head_fused
        self.quant = quant
        self.act_store = act_store
        self.compute_dtype = compute_dtype
        chs = [spec.ch_in]
        mods = []
        for ls in spec.layers:
            if ls.name in DET_HEADS or ls.name in SEG_HEADS:
                c1 = [chs[x + 1] for x in ls.f]
            elif ls.name == "Concat":
                c1 = sum(chs[x + 1] for x in ls.f)
            else:
                c1 = chs[ls.f[0] + 1]
            if stem_s2d and ls.i == 0:
                mods.append(L.PhaseStemA(spec.ch_in, ls.c2))
            elif stem_s2d and ls.i == 1:
                mods.append(L.PhaseStemB(c1, ls.c2))
            else:
                mods.append(_instantiate(ls, c1, spec, seg_upsample,
                                         decode_cat))
            chs.append(ls.c2)
        self.model = nn.ModuleList(mods)
        p6 = [ls.stride == P6_STRIDE for ls in spec.layers]
        self._p6_first = {i for i, on in enumerate(p6)
                          if on and not (i and p6[i - 1])}
        self._p6_last = {i for i, on in enumerate(p6)
                         if on and not (i + 1 < len(p6) and p6[i + 1])}
        self._fp_rows = set()
        if quant is not None or act_store is not None:
            self._setup_quant(det_fp_hops)

    def _setup_quant(self, det_fp_hops: int) -> None:
        self._fp_rows = det_fp_layers(self.spec, det_fp_hops)
        for ls, m in zip(self.spec.layers, self.model):
            if ls.name not in QUANT_AWARE or ls.name in _PASSTHROUGH:
                continue
            q = None if ls.i in self._fp_rows else self.quant
            if ls.n > 1:  # outer repeats: the JAX package's l{i}s{j}
                for j, sub in enumerate(m):
                    L.set_quant(sub, q, f"l{ls.i}s{j}", self.compute_dtype)
            else:
                L.set_quant(m, q, f"l{ls.i}", self.compute_dtype)

    def forward(self, x: torch.Tensor):
        """The JAX walker (``desenet_tpu/models/build.py:DeSeNet.__call__``).
        In eval with ``quant`` or ``act_store``: the input quantized once at
        1/127 for int8, QTensors through the quant-aware rows, dequantized
        at every other row, the storage dtype scoped per row (never for
        Detect or the fp rows)."""
        qmode = not self.training and (self.quant is not None
                                       or self.act_store is not None)
        if self.stem_s2d and spatial.active():
            raise NotImplementedError(
                "the phase-layout stem (stem_s2d) does not run on height "
                "bands (ROADMAP.md, Queue 1)")
        if qmode and spatial.active():
            raise ValueError("the int8 and fp8-storage programs do not run "
                             "on height bands (parallel/spatial.py)")
        if x.dtype == torch.uint8:
            why = self.uint8_refusal(x)
            if why is not None:
                raise ValueError("DeSeNet takes a uint8 image only through "
                                 f"the served stem: {why}")
        elif not self.training:
            count("stem.plain", 1)
        int8 = qmode and self.quant is not None and self.quant.is_int8
        card = x.device  # of the device spans (before x is quantized)
        cd = fp_ctx = None
        if qmode:
            cd = self.compute_dtype or next(self.parameters()).dtype
            x = x.to(cd)
            fp_ctx = self._fp_ctx(x)
        with (fp_ctx if qmode and not int8 else contextlib.nullcontext()):
            if int8 and self.spec.layers[0].name in QUANT_AWARE:
                x = Q.quantize(x, 1.0 / 127.0)
            cache = {-1: x}
            prev = x
            det_out = seg_out = None
            with contextlib.ExitStack() as p6:  # the open forward.p6 span
                for ls, m in zip(self.spec.layers, self.model):
                    if len(ls.f) == 1:
                        inp = prev if ls.f[0] == ls.i - 1 else cache[ls.f[0]]
                    else:
                        inp = [prev if j == ls.i - 1 else cache[j]
                               for j in ls.f]
                    if ls.i in self._p6_first:
                        p6.enter_context(span("forward.p6", device=card))
                    with contextlib.ExitStack() as scope:
                        if ls.i == 0:
                            scope.enter_context(span("forward.stem",
                                                     device=card))
                        if ls.name in SEG_HEADS:
                            scope.enter_context(span("forward.seg_head",
                                                     device=card))
                        if qmode:
                            inp = self._enter_row(scope, ls, inp, cd,
                                                  fp_ctx if int8 else None)
                        out = self._row(ls, m, inp, cd, qmode)
                    if ls.i in self._p6_last:
                        p6.close()
                    if ls.name == "Detect":
                        det_out = out
                    elif ls.name == "Segment":  # ((decode, feats), proto)
                        det_out, seg_out = out
                    elif ls.name in SEG_HEADS:
                        seg_out = out
                    if ls.i in self.spec.save:
                        cache[ls.i] = out
                    prev = out
        return det_out, seg_out

    def uint8_refusal(self, x: torch.Tensor) -> Optional[str]:
        """Why ``forward`` cannot take the uint8 image ``x`` through the
        served stem (class docstring), or None."""
        if self.quant is not None or self.act_store is not None:
            return "the int8 or fp8-storage program"
        if self.stem_s2d:
            return "the phase-layout stem (stem_s2d)"
        if spatial.active():
            return "a spatial scope (height bands)"
        m = self.model[0]
        if type(m) not in (L.ConvBnAct, L.FusedFocus):
            return f"row 0 is {type(m).__name__}, not a ConvBnAct"
        return m.stem_refusal(x)

    def _fp_ctx(self, x: torch.Tensor):
        """autocast to the compute dtype where it is not the parameters'."""
        cd = self.compute_dtype
        if cd is None or cd == next(self.parameters()).dtype:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=cd)

    def _enter_row(self, scope: contextlib.ExitStack, ls: LayerSpec, inp,
                   cd, fp_ctx):
        """A row of the quantized or fp8-storage forward: its inputs
        dequantized where it is not quant-aware (and then, for int8, run
        under ``fp_ctx``), its storage dtype scoped."""
        quant_row = ls.name in QUANT_AWARE and ls.i not in self._fp_rows
        if not quant_row:
            inp = ([Q.dequantize(v, cd) for v in inp]
                   if isinstance(inp, list) else Q.dequantize(inp, cd))
            if fp_ctx is not None:
                scope.enter_context(fp_ctx)
        scope.enter_context(L.act_store_scope(
            self.act_store if ls.name != "Detect"
            and ls.i not in self._fp_rows else None))
        return inp

    def _row(self, ls: LayerSpec, m: nn.Module, inp, cd, qmode: bool):
        """One row; ``qmode``: of the quantized or fp8-storage forward,
        where every module runs its ``qforward`` (``layers.qrun``)."""
        if ls.name == "Upsample":
            if isinstance(inp, Q.QTensor):
                return Q.qt_upsample_nearest(inp, ls.args[0])
            return (upsample_nearest_repeat if qmode
                    else upsample_nearest)(inp, ls.args[0])
        if ls.name == "Concat":
            # implicit (a list) when the only consumer is the next row, a
            # conv-entry block, and every part is wide enough
            nxt = (self.spec.layers[ls.i + 1]
                   if ls.i + 1 < len(self.spec.layers) else None)
            splittable = (qmode and ls.i not in self.spec.save
                          and nxt is not None
                          and nxt.name in _SPLIT_CONSUMERS and nxt.n == 1
                          and tuple(nxt.f) == (ls.i,))
            if any(isinstance(v, Q.QTensor) for v in inp):
                return (L.qt_maybe_cat(inp, cd) if splittable
                        else Q.qt_concat(inp))
            if splittable:
                return L.maybe_cat(inp)
            if len({v.dtype for v in inp}) > 1:
                inp = [L.to_compute(v, cd) for v in inp]
            return torch.cat(inp, 1)
        if ls.name in DET_HEADS:
            # of bands: the whole maps on every spatial rank (1x1 convs,
            # then the decode and the loss as on one device)
            xs = [spatial.gather_rows(v)
                  for v in (inp if isinstance(inp, list) else [inp])]
            return m.qforward(xs) if qmode and ls.name == "Segment" else m(xs)
        if ls.name in SEG_HEADS:
            xs = inp if isinstance(inp, list) else [inp]
            if qmode and hasattr(m, "qforward"):
                return m.qforward(xs)
            return self._seg_head(ls, m, xs)
        if qmode:
            out = inp
            for sub in (list(m) if ls.n > 1 else [m]):
                out = L.qrun(sub, out)
            return out
        x = torch.cat(inp, 1) if isinstance(inp, list) else inp
        if self.remat and self.training:
            # each outer repeat on its own, as the JAX walker's nn.remat
            for sub in (list(m) if ls.n > 1 and isinstance(m, nn.Sequential)
                        else [m]):
                x = L.checkpointed(sub, x)
            return x
        return m(x)

    def _seg_head(self, ls: LayerSpec, m: nn.Module, xs) -> torch.Tensor:
        """The seg head: kernel K4 under the conditions of the JAX
        package (eval, SegMaskPSP2, neither int8 nor fp8 storage, P8 <=
        MAX_P8), else the module. Under a spatial scope K4 takes the
        whole maps (``gather_rows`` of its inputs, as GSPMD gathers the
        pallas_call's operands) and its output is whole."""
        ctx = spatial.current()
        h8 = xs[0].shape[2] if ctx is None else spatial.band_of(
            ctx, xs[0].shape[2])[2]
        if not (self.seg_head_fused and not self.training
                and ls.name == "SegMaskPSP2" and self.quant is None
                and self.act_store is None
                and h8 * xs[0].shape[3] <= MAX_P8):
            return m(xs)
        nhwc = [spatial.gather_rows(x).permute(0, 2, 3, 1).contiguous()
                for x in xs]
        out = fused_psp2_eval(nhwc, m, int(ls.args[0])).to(xs[0].dtype)
        out = out.permute(0, 3, 1, 2)  # NCHW view of the NHWC logits
        if self.seg_upsample:
            h8, w8 = out.shape[2:]
            out = resize_bilinear(out, (h8 * 8, w8 * 8), align_corners=True)
        return out

    def fuse(self) -> "DeSeNet":
        """Prepare the served eval forward's fused epilogues: every
        ``ConvBnAct`` (``ConvBnSiLU``, ``FusedFocus`` and ``DWConv``
        included) keeps its BN's affine in f32 (``fuse_epilogue``), and an
        eval call whose BN runs then does BN, activation and the Bottleneck
        shortcut in one pass over the conv's output (``ops.conv_epilogue``);
        a served stem in row 0 also keeps its tap matrix, and then takes a
        uint8 image (class docstring); a ``Segment`` head's ``Proto``
        keeps its upsample and 3x3 conv folded into one 2x2 conv
        (``heads.Proto.fuse_phases``).
        Call it on an eval model whose weights are final: moving,
        reloading or training the model drops the constants, and the
        model runs the separate ops again. The state dict is unchanged.
        ValueError in training mode."""
        if self.training:
            raise ValueError("fuse() prepares the eval forward: call it on "
                             "a model in eval mode")
        for mod in self.modules():
            if isinstance(mod, L.ConvBnAct):
                mod.fuse_epilogue()
            elif isinstance(mod, H.Proto):
                mod.fuse_phases()
        return self

    def quirk_bn_keys(self) -> list:
        """State-dict keys of the BNs that never run (their conv's input is
        1x1). The JAX package has no variables for them; they keep their
        init when weights come from it."""
        keys = []
        for name, mod in self.named_modules():
            for p in getattr(mod, "quirk_bn_prefixes", lambda: [])():
                keys += [f"{name}.{p}{leaf}" for leaf in
                         ("weight", "bias", "running_mean", "running_var",
                          "num_batches_tracked")]
        return sorted(keys)

    def train_only_keys(self) -> list:
        """State-dict keys of the modules that run only in training
        (SegMaskBiSe's aux heads). The JAX package initializes its models
        in eval mode, so its variables lack them; they keep their init."""
        return sorted(f"{name}.{k}" for name, mod in self.named_modules()
                      for p in getattr(mod, "train_only_prefixes",
                                       lambda: [])()
                      for k in mod.state_dict() if k.startswith(p))


def mask_coefficients(spec: ModelSpec) -> int:
    """The mask coefficients an anchor of a ``Segment`` model (its ``nm``),
    0 for a model whose detection head is ``Detect``."""
    if spec.det_layer < 0 or spec.layers[spec.det_layer].name != "Segment":
        return 0
    return int(spec.layers[spec.det_layer].args[2])


def require_seg_head(spec: ModelSpec, what: str) -> None:
    """Raise ValueError where ``spec`` has no seg head: the JAX package's
    served, validation and training programs all take the seg output
    (detection-only configs such as ``yolov5s`` fail there deep inside).
    A ``Segment`` row (instance masks) counts as one; the programs that
    cannot take it refuse it themselves."""
    if spec.seg_layer < 0 and not mask_coefficients(spec):
        raise ValueError(
            f"{what} needs a model with a seg head (a SegMask* row); this "
            f"config has none (se_nc {spec.se_nc}), like the bundled "
            "detection-only yolov5s, which the JAX package cannot serve, "
            "validate or train either")


def build_model(cfg, nc: Optional[int] = None, se_nc: Optional[int] = None,
                seg_upsample: bool = True, decode_cat: bool = True,
                seg_head_fused: bool = False, train: bool = False,
                anchors: Optional[Sequence] = None,
                fuse_focus: bool = False, quant=None, act_store=None,
                det_fp_hops: int = 1,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False,
                stem_s2d: bool = False) -> Tuple[DeSeNet, ModelSpec]:
    """Parse ``cfg`` and build the model in eval mode (BN on its running
    statistics), or in training mode with ``train=True`` (the training
    step's model, usually with ``seg_upsample=False`` for the fused seg
    loss); ``anchors`` and ``fuse_focus`` as ``parse_config``.
    ``quant``: a ``quant.QuantCfg``; ``act_store``: "fp8" (e4m3),
    "fp8_e5m2" or a float8 dtype; the two are exclusive (ValueError);
    ``det_fp_hops``, ``compute_dtype``, ``remat`` and ``stem_s2d`` as
    ``DeSeNet`` (``stem_s2d`` needs ``fuse_focus=True``)."""
    if isinstance(act_store, str):
        act_store = L.F8_NAMES[act_store]
    if act_store is not None and quant is not None:
        raise ValueError("act_store (fp8 storage) and quant (int8 W8A8) are "
                         "mutually exclusive inference modes")
    spec = parse_config(cfg, nc=nc, se_nc=se_nc, anchors=anchors,
                        fuse_focus=fuse_focus)
    model = DeSeNet(spec, seg_upsample=seg_upsample, decode_cat=decode_cat,
                    seg_head_fused=seg_head_fused, quant=quant,
                    act_store=act_store, det_fp_hops=det_fp_hops,
                    compute_dtype=compute_dtype, remat=remat,
                    stem_s2d=stem_s2d)
    return model.train(train), spec


@torch.no_grad()
def init_weights(model: DeSeNet, generator: torch.Generator) -> DeSeNet:
    """Seeded init, the JAX package's distribution: torch-default uniform
    U(+-1/sqrt(fan_in)) conv and linear weights and conv biases, zero
    linear biases, BN at identity, and the Detect bias prior; attention
    projections normal with std 1/sqrt(fan_in) (flax's lecun_normal, not
    truncated) and zero biases. Draws on the CPU from ``generator`` in
    module order, then copies to wherever the parameters live."""

    def uniform(t: torch.Tensor, bound: float):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                               generator=generator))

    det = model.model[model.spec.det_layer] if model.spec.det_layer >= 0 \
        else None
    det_convs = {id(c): i for i, c in enumerate(det.m)} if det else {}
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            uniform(mod.weight, bound)
            if mod.bias is None:
                continue
            if id(mod) in det_convs:
                mod.bias.copy_(H.detect_bias_init(
                    det.na, det.no, det.strides[det_convs[id(mod)]], fan_in,
                    generator, nc=det.nc))
            else:
                uniform(mod.bias, bound)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, nn.MultiheadAttention):
            for w, b in ((mod.in_proj_weight, mod.in_proj_bias),
                         (mod.out_proj.weight, mod.out_proj.bias)):
                w.copy_(torch.empty(w.shape).normal_(
                    0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator))
                b.zero_()
        elif isinstance(mod, nn.Linear) and not isinstance(
                mod, nn.modules.linear.NonDynamicallyQuantizableLinear):
            uniform(mod.weight, 1.0 / math.sqrt(mod.weight.shape[1]))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
