"""NN building blocks (torch.nn, NCHW).

Counterpart of ``desenet_tpu/models/layers.py``: every block the model DSL
can name, the blocks of the seg heads, and the blocks the DSL cannot name
(ARM, ASPPs, RFB1, DAPPM, ConvBNReLU, Classify, Sum; at the end, with the
JAX modules' child names). Blocks use the reference layout
and the reference's torch state-dict names (a Focus slice-concat plus a kxk
conv; C3 with separate ``cv1``/``cv2``); ``FusedFocus`` is the JAX
package's one-conv stem, which equals Focus on rearranged weights. The JAX
package's TPU layout workarounds (fused ``cv12``, split-conv concats) are
not carried over; its phase-layout stem is (``PhaseStemA``/``PhaseStemB``,
``build_model(stem_s2d=True)``).

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

Under ``parallel.spatial.scope`` (``--spatial``) each map is this rank's
height band of the global map, and the ops that see across rows take
their neighbours' rows: every conv of kernel or stride above 1
(``Conv2d``, which every block here builds), the SPP pools
(``max_pool_same``), the global pools of GlobalBranch and FFM and the
PyramidPooling bins (``adaptive_avg_pool``), PyramidPooling's resize
back (``resize_bilinear_onto``). Focus's slices and the neck's nearest
upsample are local on whole bands; BN's statistics are the world's sums
already. C3TR, whose attention spans the whole map, refuses a band.

The quant-aware blocks (``QuantAware``: ConvBnAct, FusedFocus, Focus,
Bottleneck, C3, SPP, SPPF, FFM, DilatedConvBnSiLU, GlobalBranch, ACSP, RFB2,
PyramidPooling) also have ``qforward``: the JAX package's eval forward
of the int8 W8A8 mode, its weights-only ablation, its calibration mode
(``quant.py``) and its fp8 activation storage (``act_store_scope``), with
its structure kept where the numbers depend on it: implicit concats
(lists of parts) under the same 128-channel gate (``maybe_cat``,
``qt_maybe_cat``), the fused C3 ``cv12`` (cv1 and cv2 as one conv, its BN
never skipped), the int8 glue. The other blocks (GhostConv,
GhostBottleneck, C3Ghost, CrossConv, MixConv2d, BottleneckCSP, C3TR,
C3SPP, the standalone BN and the seg heads' blocks) have a ``qforward``
too, their fp8-storage forward: every ConvBnAct or DilatedConvBnSiLU inside
stores its output in the scoped dtype and every raw add, concat, pool or
matmul upcasts its fp8 inputs first (``to_compute``), at the JAX
package's places. The model walker (``models/build.py``) calls
``qforward`` for every row of a model built with ``quant`` or
``act_store`` (``qrun``).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.ops import conv_epilogue, int8_conv, stem_pallas
from desenet_tpu_torch.parallel import multihost, spatial
from desenet_tpu_torch.parallel.mesh import process_count
from desenet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    adaptive_avg_pool_separable,
    broadcast_hw,
    max_pool_same,
    resize_bilinear,
    resize_bilinear_onto,
    resize_bilinear_separable,
    resize_nearest,
)
from desenet_tpu_torch.quant import F8_DTYPES, QTensor, to_f8
from desenet_tpu_torch.utils.fold import bn_affine
from desenet_tpu_torch.utils.profiling import count

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


# True while torch.utils.checkpoint recomputes a block's forward in the
# backward pass (``checkpointed``): BN then normalizes with the batch's
# statistics as the first forward did and leaves its running statistics,
# which that forward moved already (flax returns them as an output, so the
# JAX package's remat never moves them twice)
_RECOMPUTE: contextvars.ContextVar = contextvars.ContextVar(
    "desenet_torch_recompute", default=False)


def checkpointed(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant, the RNG state kept, so
    dropout draws the same bits); the recompute runs under ``_RECOMPUTE``
    and the forward's spatial scope.
    """
    from torch.utils.checkpoint import checkpoint

    calls = [0]
    # the recompute may run on autograd's device thread, outside the
    # forward's spatial scope: it takes the scope the forward ran in
    band = spatial.current()

    def run(inp):
        token = _RECOMPUTE.set(calls[0] > 0)
        calls[0] += 1
        try:
            with spatial.reenter(band):
                return mod(inp)
        finally:
            _RECOMPUTE.reset(token)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=True)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step moves the running variance
    toward the biased batch variance, as flax's BatchNorm does (the JAX
    package's ``layers.BatchNorm``, momentum 0.97 there). Normalization,
    the running mean and eval mode are torch's; ``num_batches_tracked`` is
    not advanced. With ``momentum=None`` (torch's cumulative average, which
    flax does not have) the module is torch's own. With a process group of
    more than one process the statistics are the global batch's
    (``_global_batch_norm``). In a recompute (``checkpointed``) the
    running statistics stay as they are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        if process_count() > 1:
            return self._global_batch_norm(x)
        # F.batch_norm moves a copy of the variance by m * var * n / (n - 1)
        # (autograd keeps that copy); the n / (n - 1) is taken back from its
        # own statistics, with no pass over x. A recompute moves copies of
        # both and drops them (the same graph, so autograd saves as many
        # tensors as in the first forward)
        recompute = _RECOMPUTE.get()
        rm = self.running_mean.clone() if recompute else self.running_mean
        rv = self.running_var.clone()
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if recompute:
            return y
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
        variance takes the unbiased variance. A recompute (``checkpointed``)
        sums the statistics again, every process recomputing in the same
        order in its backward pass, and moves no running statistic."""
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
        if _RECOMPUTE.get():
            return y.to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * m)
        return y.to(x.dtype)

    def qforward(self, x: torch.Tensor) -> torch.Tensor:
        """The standalone BN row under fp8 storage: an fp8 input upcast
        first, the output in the compute dtype (as in the JAX package)."""
        return self(to_compute(x, self.weight.dtype))


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def qrun(mod: nn.Module, x):
    """``mod.qforward(x)`` where the module has one, else ``mod(x)`` (the
    parameterless and pass-through modules)."""
    return mod.qforward(x) if hasattr(mod, "qforward") else mod(x)


# ---------------------------------------------------------------------------
# fp8 activation storage (the JAX package's layers.py:225-315): in eval,
# under a storage dtype scoped by the model walker, block outputs are cast to
# float8 and their consumers upcast them; compute stays in the model dtype.

F8_NAMES = {"fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
            "fp8_e5m2": torch.float8_e5m2}

_ACT_STORE: contextvars.ContextVar = contextvars.ContextVar(
    "desenet_torch_act_store", default=None)


@contextlib.contextmanager
def act_store_scope(dtype):
    """Scope a storage dtype for block outputs (None: a no-op scope)."""
    token = _ACT_STORE.set(dtype)
    try:
        yield
    finally:
        _ACT_STORE.reset(token)


def _store_act(y):
    """Cast a block output to the scoped storage dtype. Maps of one pixel
    (channel-attention gates, global-pool branches) stay in the compute
    dtype."""
    st = _ACT_STORE.get()
    if (st is None or not isinstance(y, torch.Tensor) or y.dtype == st
            or not y.is_floating_point()):
        return y
    if y.dim() >= 3 and math.prod(y.shape[2:]) <= 1:
        return y
    return to_f8(y, st)


def to_compute(x, dtype):
    """Upcast an fp8-stored activation for ops that cannot take fp8; other
    tensors as they are."""
    if isinstance(x, torch.Tensor) and x.dtype in F8_DTYPES:
        return x.to(dtype)
    return x


def widen_mixed(xs):
    """A part list of mixed storage / compute dtypes unified to the widest
    compute dtype (fp8 counted as bf16), for a materialized concat."""
    if len({v.dtype for v in xs}) > 1:
        wide = functools.reduce(torch.promote_types, [
            torch.bfloat16 if v.dtype in F8_DTYPES else v.dtype for v in xs])
        xs = [v.to(wide) for v in xs]
    return list(xs)


def cat_parts(xs):
    """Channel concat of tensors of one dtype (float8 included)."""
    return torch.cat(list(xs), 1) if len(xs) > 1 else xs[0]


# Minimum channel width of every part for a concat to stay implicit (a list
# convolved part by part): the JAX package's SPLIT_CONV_MIN_PART. It
# decides numbers, not only layout, in the quantized paths (a materialized
# per-tensor int8 concat requantizes its parts; a list keeps them).
SPLIT_CONV_MIN_PART = 128


def _width(v) -> int:
    return (v.data if isinstance(v, QTensor) else v).shape[1]


def maybe_cat(xs):
    """The list (implicit concat) when every part is at least
    SPLIT_CONV_MIN_PART channels wide, else the materialized concat."""
    if all(_width(v) >= SPLIT_CONV_MIN_PART for v in xs):
        return list(xs)
    return cat_parts(widen_mixed(xs))


def qt_maybe_cat(xs, fp_dtype=torch.float32):
    """int8 ``maybe_cat``: wide lists stay implicit (fp parts among them
    are quantized by the consumer at its input site); narrow ones
    materialize through ``qt_concat``, or in fp when a part is fp."""
    if all(_width(v) >= SPLIT_CONV_MIN_PART for v in xs):
        return list(xs)
    if all(isinstance(v, QTensor) for v in xs):
        return Q.qt_concat(xs)
    fp_dt = next((v.dtype for v in xs if not isinstance(v, QTensor)),
                 fp_dtype)
    parts = [Q.dequantize(v, fp_dt) if isinstance(v, QTensor) else v
             for v in xs]
    return cat_parts(widen_mixed(parts))


def _parts(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _spatial(x):
    x = x[0] if isinstance(x, (list, tuple)) else x
    return tuple((x.data if isinstance(x, QTensor) else x).shape[2:])


def quantize_at_boundary(mod, x, site: str):
    """Quantize the fp entries of ``x`` (a tensor or a part list) at the
    module's calibrated input ``site`` scale, each part at its slice of a
    per-channel scale: the entry of an int8 block whose producer stayed
    fp."""
    if isinstance(x, (list, tuple)):
        if all(isinstance(v, QTensor) for v in x):
            return list(x)
        s_in = mod.quant.scale_for(Q.site_key(mod, site))
        parts, off = [], 0
        for v in x:
            c = _width(v)
            if not isinstance(v, QTensor):
                v = Q.quantize(v, s_in if not isinstance(s_in, tuple)
                               else s_in[off:off + c])
            parts.append(v)
            off += c
        return parts
    if not isinstance(x, QTensor):
        return Q.quantize(x, mod.quant.scale_for(Q.site_key(mod, site)))
    return x


def int8_block(mod, tag: str, x, make, *, act: bool = False,
               residual: Optional[QTensor] = None, out_scale=None,
               out_dtype=torch.float32, groups: int = 1):
    """One int8 conv block of ``mod`` (``quant.py:int8_conv_block``):
    ``x`` a QTensor or a list of them; ``make(scales, channels)`` folds the
    site's constants (``ops.int8_conv.prepare``) at the first call with
    these input scales, as the JAX package folds them at trace time
    (``QuantAware`` drops them when the block is moved or loaded). Returns
    a QTensor at ``out_scale``, or fp logits in ``out_dtype`` where it is
    None."""
    parts = _parts(x)
    if groups != 1 and any(isinstance(p.scale, tuple) for p in parts):
        parts = [Q.requantize(p, Q.scale_max(p.scale)) for p in parts]
    scales = tuple(p.scale for p in parts)
    chans = tuple(p.data.shape[1] for p in parts)
    dev = parts[0].data.device
    key = (tag, scales, chans)
    prep = mod._derived.get(key)
    if prep is None:
        with torch.no_grad():
            prep = mod._derived[key] = make(scales, chans)
    if out_scale is not None:
        mode = int8_conv.OUT_INT8
    else:
        mode = (int8_conv.OUT_BF16 if out_dtype == torch.bfloat16
                else int8_conv.OUT_F32)
    y = int8_conv.run(
        [p.data for p in parts], prep,
        residual=None if residual is None else residual.data,
        res_scale=None if residual is None else Q.scale_t(residual.scale,
                                                          dev),
        out_scale=None if out_scale is None else Q.scale_t(out_scale, dev),
        act=act, out_mode=mode)
    if out_scale is None:
        return y.to(out_dtype)
    return QTensor(y, out_scale)


def _w8_weight(w: torch.Tensor, mse_clip: bool) -> torch.Tensor:
    """A kernel round-tripped through per-output-channel int8 (f32)."""
    qw, s_w = Q.quantize_kernel(w, mse_clip=mse_clip)
    return qw.float() * s_w.view(-1, 1, 1, 1)


def _bias_correction(wdq, w, mean, bn=None):
    """E[conv(x, dq(q(W)) - W)] per output channel from the calibrated
    input means, through the BN scale where the BN runs."""
    corr = torch.einsum("oihw,i->o", wdq - w.float(),
                        torch.from_numpy(np.asarray(mean, np.float32))
                        .to(w.device))
    if bn is not None:
        corr = corr * Q.bn_fold_constants(bn)[0]
    return corr


class QuantAware:
    """Mixin of the blocks with a quantized / fp8-storage eval forward.
    ``quant`` (a ``quant.QuantCfg`` or None), ``qkey`` (the JAX package's
    flax scope path of the block, the prefix of its site keys) and
    ``cdtype`` (the compute dtype of its fp pieces) are set by
    ``set_quant``; ``qmap`` names the quant-aware children after the JAX
    modules."""

    quant = None
    qkey = ""
    cdtype = None

    @property
    def _derived(self) -> dict:
        """Constants derived from the block's weights, outside the state
        dict: the folded int8 constants of its convs (``int8_block``), by
        conv and input scales, and ``ConvBnAct``'s BN affine for its fused
        epilogue under "epilogue" (a served stem's tap matrix under
        "stem"). Moving, reloading or ``train(True)`` drops them all."""
        return self.__dict__.setdefault("_derived_consts", {})

    def drop_derived_constants(self) -> None:
        self.__dict__.pop("_derived_consts", None)

    def _apply(self, fn, *args, **kwargs):
        self.drop_derived_constants()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.drop_derived_constants()
        super()._load_from_state_dict(*args, **kwargs)

    def train(self, mode: bool = True):
        if mode:
            self.drop_derived_constants()
        return super().train(mode)

    def qmap(self) -> dict:
        return {}


def set_quant(mod, quant, qkey: str, cdtype) -> None:
    """Give ``mod`` and its quant-aware children their config, JAX scope
    path and compute dtype."""
    mod.quant, mod.qkey, mod.cdtype = quant, qkey, cdtype
    mod.drop_derived_constants()
    for path, name in mod.qmap().items():
        set_quant(mod.get_submodule(path), quant, f"{qkey}/{name}", cdtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that convolves a height band with its halo under a
    spatial scope (``parallel.spatial.conv2d``) where its kernel or stride
    spans rows; ``nn.Conv2d``'s forward otherwise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.kernel_size[0] > 1 or self.stride[0] > 1) \
                and spatial.active():
            return spatial.conv2d(self, x)
        return super().forward(x)


class ConvBnAct(QuantAware, nn.Module):
    """Conv2d(bias=False) + BN + SiLU: the reference ``Conv`` block, with the
    BN skipped on a 1x1 input map. Sites: ``in`` and ``inmean`` (its input),
    ``out``. ``forward``'s ``residual`` is added after the activation (the
    Bottleneck shortcut).

    After ``fuse_epilogue`` (``DeSeNet.fuse``) an eval call without
    autograd whose BN runs does everything after the conv in one pass,
    ``ops.conv_epilogue``: the BN's affine from f32 constants, the
    activation and the residual, rounded once (the kernel on a card). The
    constants are among ``QuantAware``'s derived constants, outside the
    state dict; moving or reloading the block, or ``train(True)``, drops
    them, and the block runs BN, activation and add as separate ops
    again. While tracing, each eval call adds 1 to the counter
    ``epilogue.fused`` (in ``ops.conv_epilogue``, once the pass has run)
    or ``epilogue.plain``.

    A 6x6/s2 pad-2 block from 3 channels with CO a multiple of 8 up to
    ``stem_pallas.SERVED_CO_MAX`` (the FusedFocus stem) is a served stem:
    after ``fuse_epilogue`` it also keeps its tap matrix, and an eval call
    without autograd in bf16 takes the uint8 image itself, the (B, 3, H,
    W) channels_last view of the (B, H, W, 3) batch, widens it and does
    conv, BN and SiLU in one pass (``stem_pallas.served_stem``: the kernel
    on a card, counted ``stem.fused`` and ``epilogue.fused``). A uint8
    image that any other call gets is a ValueError that says why
    (``stem_refusal``)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 d: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p), dilation=d,
                           groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dtype == torch.uint8:
            return self._served_stem(x, residual)
        return self._tail(self.conv(x), x.shape[2] * x.shape[3] > 1,
                          residual)

    def _stem_shape_refusal(self) -> Optional[str]:
        """Why this block is no served stem by its shape, or None."""
        c = self.conv
        got = (c.in_channels, c.kernel_size, c.stride, c.padding,
               c.dilation, c.groups)
        if got != (3, (6, 6), (2, 2), (2, 2), (1, 1), 1):
            return (f"a conv of (c1, k, s, p, d, g) {got}, not 6x6/s2 pad 2 "
                    "from 3 channels")
        if c.out_channels % 8 or c.out_channels > stem_pallas.SERVED_CO_MAX:
            return (f"{c.out_channels} output channels, not a multiple of 8 "
                    f"up to {stem_pallas.SERVED_CO_MAX}")
        return None

    def stem_refusal(self, x: torch.Tensor) -> Optional[str]:
        """Why ``forward`` cannot take the uint8 image ``x`` as the served
        stem (class docstring), or None."""
        why = self._stem_shape_refusal()
        if why is not None:
            return why
        if self.training:
            return "training mode"
        if torch.is_grad_enabled():
            return "autograd enabled"
        if "stem" not in self._derived:
            return ("no fuse(), or a move, reload or train() since, has "
                    "dropped its constants")
        if self.conv.weight.dtype != torch.bfloat16:
            return f"weights in {self.conv.weight.dtype}, not bfloat16"
        if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] % 2 \
                or x.shape[3] % 2:
            return (f"an image of shape {tuple(x.shape)}, not (B, 3, H, W) "
                    "with H and W even")
        if x.device != self.conv.weight.device:
            return f"the image on {x.device}, the weights on another device"
        return None

    def _served_stem(self, x: torch.Tensor,
                     residual: Optional[torch.Tensor]) -> torch.Tensor:
        why = self.stem_refusal(x)
        if why is None and residual is not None:
            why = "a residual to add"
        if why is not None:
            raise ValueError(f"{type(self).__name__} takes a uint8 image only "
                             f"as the served stem: {why}")
        scale, shift = self._derived["epilogue"]
        y = stem_pallas.served_stem(x.permute(0, 2, 3, 1),
                                    self._derived["stem"], scale, shift,
                                    silu=isinstance(self.act, nn.SiLU))
        return y.permute(0, 3, 1, 2)  # NCHW view of the NHWC output

    def _tail(self, y: torch.Tensor, bn_runs: bool,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
        """BN (where ``bn_runs``), the activation and ``residual`` on the
        conv's output ``y``: the fused pass where the class docstring says,
        else one op each."""
        if not self.training:
            consts = self._derived.get("epilogue")
            if consts is not None and bn_runs and \
                    not torch.is_grad_enabled():
                return conv_epilogue.conv_epilogue(
                    y, *consts, isinstance(self.act, nn.SiLU), residual)
            count("epilogue.plain", 1)
        if bn_runs:
            y = self.bn(y)
        y = self.act(y)
        return y if residual is None else y + residual

    def fuse_epilogue(self) -> None:
        """Keep the BN's affine (``utils/fold.bn_affine``, in f32, or in
        float64 for a float64 block) for ``forward``'s fused pass, and a
        served stem's tap matrix (``stem_pallas.stem_weight_matrix``)."""
        dtype = torch.promote_types(self.bn.weight.dtype, torch.float32)
        self._derived["epilogue"] = bn_affine(self.bn, dtype)
        if self._stem_shape_refusal() is None:  # the tap matrix, in bf16
            w = self.conv.weight.detach()
            self._derived["stem"] = stem_pallas.stem_weight_matrix(
                w.permute(2, 3, 1, 0).float().cpu().numpy(), w.dtype).to(
                    w.device)

    def _padding(self):
        p = self.conv.padding
        return (p, p) if isinstance(p, int) else tuple(p)

    def qforward(self, x, residual=None):
        """``x``: a tensor, a QTensor or a part list; ``residual`` is added
        after the activation (the Bottleneck shortcut, folded into the
        int8 epilogue)."""
        q = self.quant
        if q is not None and q.is_int8:
            return self._int8(x, residual)
        xs = [to_compute(v, self.conv.weight.dtype) for v in _parts(x)]
        xc = cat_parts(xs)
        y = self._w8(xc) if q is not None and q.is_w8 else self(xc)
        if residual is not None:
            y = y + Q.dequantize(residual, y.dtype)
        if q is not None and q.is_calib:
            Q.sow_in_range(self, "in", xs)
            Q.sow_channel_mean(self, "inmean", xs)
            Q.sow_absmax(self, "out", y)
        return _store_act(y)

    def _int8(self, x, residual):
        q = self.quant
        if isinstance(x, (list, tuple)) and self.conv.groups != 1:
            x = Q.qt_concat(x)
        x = quantize_at_boundary(self, x, "in")
        h, w = _spatial(x)
        bn = self.bn if h * w > 1 else None
        mean = q.mean_for(Q.site_key(self, "inmean"))

        def make(scales, chans):
            return int8_conv.prepare(
                self.conv.weight, scales, chans, stride=self.conv.stride[0],
                padding=self._padding(), dilation=self.conv.dilation[0],
                groups=self.conv.groups,
                bn=None if bn is None else Q.bn_fold_constants(bn),
                in_mean=mean, mse_clip=q.mse_clip)

        return int8_block(self, f"bn{bn is not None}", x, make,
                          act=isinstance(self.act, nn.SiLU),
                          residual=residual,
                          out_scale=q.scale_for(Q.site_key(self, "out")),
                          groups=self.conv.groups)

    def _w8(self, x):
        """Weights-only: ``forward`` with the kernel round-tripped through
        per-channel int8 and the bias correction before the activation."""
        q = self.quant
        spatial = x.shape[2] * x.shape[3] > 1
        w = self.conv.weight
        wdq = _w8_weight(w, q.mse_clip)
        y = F.conv2d(x, wdq.to(x.dtype), None, self.conv.stride,
                     self._padding(), self.conv.dilation, self.conv.groups)
        if spatial:
            y = self.bn(y)
        mean = q.mean_for(Q.site_key(self, "inmean"))
        if q.bias_correct and self.conv.groups == 1 and mean is not None:
            corr = _bias_correction(wdq, w, mean, self.bn if spatial else None)
            y = y - corr.to(y.dtype).view(1, -1, 1, 1)
        return self.act(y)


class ConvBnSiLU(ConvBnAct):
    """ConvBnAct whose BN runs on any map, as the JAX package's bare
    conv + BatchNorm pairs do (CrossConv)."""

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._tail(self.conv(x), True, residual)


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


class Bottleneck(QuantAware, nn.Module):
    """1x1 -> 3x3 with optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the shortcut is cv2's residual: its fused pass adds it
        return self.cv2(self.cv1(x), x if self.add else None)

    def qmap(self) -> dict:
        return {"cv1": "cv1", "cv2": "cv2"}

    def qforward(self, x):
        y = self.cv1.qforward(x)
        if not self.add:
            return self.cv2.qforward(y)
        # the shortcut folds into cv2's epilogue; the fp path adds in the
        # compute dtype and stores once
        res = x if self.quant is not None else to_compute(
            x, self.cv1.conv.weight.dtype)
        return self.cv2.qforward(y, residual=res)


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

    def qforward(self, x):
        """fp8 storage: cv1, the bottlenecks and cv4 store their outputs;
        the bare convs, the BN and the LeakyReLU run in the compute dtype."""
        dt = self.cv2.weight.dtype
        y1 = self.cv1.qforward(x)
        for b in self.m:
            y1 = b.qforward(y1)
        xc = cat_parts([to_compute(v, dt) for v in _parts(x)])
        y = torch.cat([self.cv3(to_compute(y1, dt)), self.cv2(xc)], 1)
        return self.cv4.qforward(self.act(self.bn(y)))


class C3(QuantAware, nn.Module):
    """CSP bottleneck with 3 convs (reference layout: separate cv1/cv2).
    ``inner(c_)`` builds the stack ``m`` in place of the n Bottlenecks (the
    C3SPP, C3Ghost and C3TR variants). ``qforward`` runs cv1 and cv2 as the
    JAX package's one ``cv12`` conv (sites ``cv12_in``, ``cv12_inmean``,
    ``cv12_out``), its BN never skipped."""

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

    def qmap(self) -> dict:
        out = {f"m.{i}": f"m_{i}" for i in range(len(self.m))}
        out["cv3"] = "cv3"
        return out

    def _cv12(self):
        """cv1 and cv2 as one conv: (weight, [BN scale, BN bias] f32)."""
        w = torch.cat([self.cv1.conv.weight, self.cv2.conv.weight])
        s1, b1 = Q.bn_fold_constants(self.cv1.bn)
        s2, b2 = Q.bn_fold_constants(self.cv2.bn)
        return w, (torch.cat([s1, s2]), torch.cat([b1, b2]))

    def qforward(self, x):
        q = self.quant
        c_ = self.cv1.conv.out_channels
        if q is not None and q.is_int8:
            x = quantize_at_boundary(self, x, "cv12_in")
            mean = q.mean_for(Q.site_key(self, "cv12_inmean"))

            def make(scales, chans):
                w, bn = self._cv12()
                return int8_conv.prepare(w, scales, chans, bn=bn,
                                         in_mean=mean)

            yq = int8_block(self, "cv12", x, make,
                            act=True, out_scale=q.scale_for(
                                Q.site_key(self, "cv12_out")))
            y1, y2 = Q.qt_slice(yq, 0, c_), Q.qt_slice(yq, c_,
                                                     yq.data.shape[1])
        else:
            dt = self.cv1.conv.weight.dtype
            xs = [to_compute(v, dt) for v in _parts(x)]
            xc = cat_parts(xs)
            w, (s_bn, b_bn) = self._cv12()
            if q is not None and q.is_w8:
                wdq = _w8_weight(w, q.mse_clip)
                y = F.conv2d(xc, wdq.to(dt))
            else:
                y = F.conv2d(xc, w)
            y = torch.cat([self.cv1.bn(y[:, :c_]), self.cv2.bn(y[:, c_:])], 1)
            if q is not None and q.is_w8 and q.bias_correct:
                mean = q.mean_for(Q.site_key(self, "cv12_inmean"))
                if mean is not None:
                    corr = _bias_correction(wdq, w, mean) * s_bn
                    y = y - corr.to(y.dtype).view(1, -1, 1, 1)
            y = F.silu(y)
            if q is not None and q.is_calib:
                Q.sow_absmax(self, "cv12_out", y)
                Q.sow_in_range(self, "cv12_in", xs)
                Q.sow_channel_mean(self, "cv12_inmean", xs)
            y = _store_act(y)
            y1, y2 = y[:, :c_], y[:, c_:]
        for b in self.m:
            y1 = b.qforward(y1)
        cat = (qt_maybe_cat([y1, y2]) if isinstance(y1, QTensor)
               else maybe_cat([y1, y2]))
        return self.cv3.qforward(cat)

    def _qforward_separate(self, x):
        """The fp8-storage forward of the C3 variants (C3SPP, C3Ghost,
        C3TR), which the JAX package builds with separate cv1 and cv2 (no
        ``cv12``): both store their outputs, the inner stack runs on cv1's,
        the two are concatenated whole (upcast where their dtypes differ:
        C3TR's transformer returns the compute dtype) and cv3 stores."""
        y1 = self.cv1.qforward(x)
        y1 = (qrun(self.m, y1) if not isinstance(self.m, nn.Sequential)
              else functools.reduce(lambda y, b: b.qforward(y), self.m, y1))
        y2 = self.cv2.qforward(x)
        return self.cv3.qforward(cat_parts(widen_mixed([y1, y2])))


def _pools_q(mod, y, ks, serial: bool):
    """SPP / SPPF after cv1: the max pools (of the int8 data where ``y`` is
    a QTensor, of the upcast map where it is fp8-stored) and cv2 over
    their implicit concat."""
    if isinstance(y, QTensor):
        pools = [y]
        for k in ks:
            pools.append(Q.qt_max_pool(pools[-1] if serial else y, k))
        return mod.cv2.qforward(qt_maybe_cat(pools))
    y = to_compute(y, mod.cv1.conv.weight.dtype)
    pools = [y]
    for k in ks:
        pools.append(max_pool_same(pools[-1] if serial else y, k))
    return mod.cv2.qforward(maybe_cat(pools))


class SPP(QuantAware, nn.Module):
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

    def qmap(self) -> dict:
        return {"cv1": "cv1", "cv2": "cv2"}

    def qforward(self, x):
        return _pools_q(self, self.cv1.qforward(x), self.k, serial=False)


class SPPF(QuantAware, nn.Module):
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

    def qmap(self) -> dict:
        return {"cv1": "cv1", "cv2": "cv2"}

    def qforward(self, x):
        return _pools_q(self, self.cv1.qforward(x), (self.k,) * 3,
                        serial=True)


class C3SPP(C3):
    """C3 with an SPP as its inner stack (common.py:156-161)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 1, True, g, e,
                         inner=lambda c_: SPP(c_, c_, k))

    def qforward(self, x):
        return self._qforward_separate(x)


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

    def qforward(self, x):
        """fp8 storage: both convs store; their outputs concatenated as
        they are (one dtype)."""
        y = self.cv1.qforward(x)
        return torch.cat([y, self.cv2.qforward(y)], 1)


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

    def qforward(self, x):
        """fp8 storage: the convs store; the shortcut add upcasts both
        sides and stores the sum."""
        y = functools.reduce(lambda v, m: qrun(m, v), self.conv, x)
        if not self.add:
            return y
        sc = (functools.reduce(lambda v, m: qrun(m, v), self.shortcut, x)
              if isinstance(self.shortcut, nn.Sequential) else x)
        dt = self.conv[0].cv1.conv.weight.dtype
        return _store_act(to_compute(y, dt) + to_compute(sc, dt))


class C3Ghost(C3):
    """C3 with GhostBottlenecks as its inner stack (common.py:164-169)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, inner=lambda c_: (
            nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))))

    def qforward(self, x):
        return self._qforward_separate(x)


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
        if spatial.active():
            raise ValueError("C3TR attends over the whole map; spatial "
                             "partitioning cannot split it into bands")
        if self.conv is not None:
            x = self.conv(x)
        return self._tokens(x)

    def qforward(self, x):
        """fp8 storage: the conv (where there is one) stores; the tokens
        run in the compute dtype and so does the output."""
        if self.conv is not None:
            x = self.conv.qforward(x)
        return self._tokens(to_compute(x, self.linear.weight.dtype))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
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

    def qforward(self, x):
        return self._qforward_separate(x)


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

    def qforward(self, x):
        """fp8 storage: both convs in the compute dtype with no store
        between them (the JAX block's bare convs); only the residual sum
        is stored."""
        x = to_compute(x, self.cv1.conv.weight.dtype)
        y = self.cv2(self.cv1(x))
        return _store_act(x + y) if self.add else y


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
            Conv2d(c1, ch[g], k[g], s, k[g] // 2, bias=False)
            for g in range(n))
        self.bn = batch_norm(c2)
        self.act = nn.SiLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(torch.cat([m(x) for m in self.m], 1)))

    def qforward(self, x):
        """fp8 storage: an fp8 input upcast, the output in the compute
        dtype (the JAX block stores nothing)."""
        return self(to_compute(x, self.bn.weight.dtype))


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


class Focus(QuantAware, nn.Module):
    """Space-to-depth stem: 4-way pixel slice + conv.

    Slice order (y, x) = (even, even), (odd, even), (even, odd), (odd, odd),
    as in the reference, so its weights line up."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, s, p, g, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self._slices(x))

    @staticmethod
    def _slices(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                          x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], 1)

    def qmap(self) -> dict:
        return {"conv": "conv"}

    def qforward(self, x):
        if isinstance(x, QTensor):  # slices and concat keep the scale
            s = x.scale * 4 if isinstance(x.scale, tuple) else x.scale
            return self.conv.qforward(QTensor(self._slices(x.data), s))
        return self.conv.qforward(self._slices(x))


# ---------------------------------------------------------------------------
# The phase-layout (space-to-depth-4) stem: an exact rewrite of FusedFocus +
# Conv (the JAX package's layers.py:1543-1706). The host delivers images in
# s2d4 layout (H/4, W/4, 16 ci) with channel order (pr, pc, ci), pr/pc the
# 4x4 pixel phase (ops/s2d.py, native.assemble_batch_s2d4), and the first
# two layers become stride-1 convs at the H/4 grid with deep contractions:
#
#   l0': 3x3/s1 conv 16 ci -> 4 c0, pad 1       [6x6/s2/p2, ci -> c0]
#   l1': 2x2/s1 conv 4 c0 -> c1, pad (1,0),(1,0) [3x3/s2/p1, c0 -> c1]
#
# l0' emits (qy, qx, c0) channels, qy/qx the 2x2 output phase; l1' consumes
# them and emits the standard (H/4, W/4, c1) map. In HWIO, as the JAX
# package writes the maps (out-of-range taps are 0):
#
#   W3[dr+1, dc+1, (pr,pc,ci), (qy,qx,co)] = W6[4dr+pr-2qy+2, 4dc+pc-2qx+2,
#                                               ci, co]
#   W2[er+1, ec+1, (qy,qx,ci), co]         = W1[2er+qy+1, 2ec+qx+1, ci, co]
#
# The modules own the parameters of the FusedFocus and ConvBnAct they
# replace under the same state-dict keys (``conv.weight`` 6x6 / 3x3 OIHW,
# ``bn.*``) and gather the phase kernel inside the forward, so checkpoints,
# the EMA, optimizer state and ``utils/convert`` cross unchanged and
# autograd carries the exact gradient back to W6 / W1.


@functools.lru_cache(maxsize=None)
def _phase_index_a():
    """Row/column taps of W6 for the (dr, dc, pr, pc, qy, qx) grid, 6 where
    out of range (the zero pad row/column)."""
    dr = np.arange(-1, 2).reshape(3, 1, 1, 1, 1, 1)
    dc = np.arange(-1, 2).reshape(1, 3, 1, 1, 1, 1)
    pr = np.arange(4).reshape(1, 1, 4, 1, 1, 1)
    pc = np.arange(4).reshape(1, 1, 1, 4, 1, 1)
    qy = np.arange(2).reshape(1, 1, 1, 1, 2, 1)
    qx = np.arange(2).reshape(1, 1, 1, 1, 1, 2)
    shape = (3, 3, 4, 4, 2, 2)
    kr = np.broadcast_to(4 * dr + pr - 2 * qy + 2, shape)
    kc = np.broadcast_to(4 * dc + pc - 2 * qx + 2, shape)
    valid = (kr >= 0) & (kr < 6) & (kc >= 0) & (kc < 6)
    return np.where(valid, kr, 6), np.where(valid, kc, 6)


@functools.lru_cache(maxsize=None)
def _phase_index_b():
    """Row/column taps of W1 for the (er, ec, qy, qx) grid (all in range)."""
    er = np.arange(-1, 1).reshape(2, 1, 1, 1)
    ec = np.arange(-1, 1).reshape(1, 2, 1, 1)
    qy = np.arange(2).reshape(1, 1, 2, 1)
    qx = np.arange(2).reshape(1, 1, 1, 2)
    shape = (2, 2, 2, 2)
    return (np.broadcast_to(2 * er + qy + 1, shape).copy(),
            np.broadcast_to(2 * ec + qx + 1, shape).copy())


@functools.lru_cache(maxsize=None)
def _phase_index(which: str, device: torch.device):
    """``_phase_index_a`` or ``_b`` as index tensors on ``device``, made
    once a device (no host copy in the forward)."""
    idx = _phase_index_a() if which == "a" else _phase_index_b()
    return tuple(torch.from_numpy(np.ascontiguousarray(i)).to(device)
                 for i in idx)


def _gather_taps(w: torch.Tensor, which: str) -> torch.Tensor:
    """``w`` (O, I, K, K) at the tap grid ``which`` (rows, columns; K means
    a zero tap): (*grid, O, I)."""
    wp = F.pad(w, (0, 1, 0, 1)).permute(2, 3, 0, 1)  # (K+1, K+1, O, I)
    rows, cols = _phase_index(which, w.device)
    return wp[rows, cols]


def phase_stem_kernel_a(w6: torch.Tensor) -> torch.Tensor:
    """(co, ci, 6, 6) 6x6/s2/p2 kernel -> (4 co, 16 ci, 3, 3) phase kernel,
    OIHW, input channels (pr, pc, ci), output channels (qy, qx, co)."""
    co, ci = w6.shape[:2]
    w3 = _gather_taps(w6, "a")  # (3,3,4,4,2,2,co,ci)
    return w3.permute(4, 5, 6, 2, 3, 7, 0, 1).reshape(4 * co, 16 * ci, 3, 3)


def phase_stem_kernel_b(w1: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) 3x3/s2/p1 kernel -> (co, 4 ci, 2, 2) phase kernel,
    OIHW, input channels (qy, qx, ci)."""
    co, ci = w1.shape[:2]
    w2 = _gather_taps(w1, "b")  # (2,2,2,2,co,ci)
    return w2.permute(4, 2, 3, 5, 0, 1).reshape(co, 4 * ci, 2, 2)


class _PhaseStem(QuantAware, nn.Module):
    """A phase module: quant-aware so that the walker scopes it as the row
    it replaces (``set_quant``); no int8 path (``_check_stem_s2d``)."""

    def qforward(self, x):
        """The forward, which stores its output under fp8 storage."""
        return self(x)


class PhaseStemA(_PhaseStem):
    """Phase-layout replacement for l0 = FusedFocus (ConvBnAct c2, 6, 2, 2).

    Input (B, 16 ci, H/4, W/4) in s2d4 channel order (pr, pc, ci); output
    (B, 4 c2, H/4, W/4) in (qy, qx, c2) order. In training the BN takes its
    statistics per original channel over B x 4 phases x H/4 x W/4 (the
    port's ``BatchNorm2d`` on the map folded to (4B, c2, H/4, W/4), so the
    biased running variance and the global-batch path stay as they are);
    in eval it is the running-statistics affine tiled over the phases."""

    def __init__(self, ci: int, c2: int):
        super().__init__()
        self.conv = Conv2d(ci, c2, 6, 2, 2, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        x = to_compute(x, w.dtype)
        y = F.conv2d(x, phase_stem_kernel_a(w).to(x.dtype), None, 1, 1)
        b, c4, h, wd = y.shape
        if self.training:
            y = self.bn(y.reshape(b * 4, c4 // 4, h, wd)).reshape(
                b, c4, h, wd)
            return F.silu(y)
        # BN on running statistics as a per-channel affine in f32, tiled
        # over the four output phases (the (qy, qx, c2) order)
        bn = self.bn
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        shift = bn.bias.float() - bn.running_mean.float() * s
        s, shift = (v.repeat(4).to(y.dtype).view(1, -1, 1, 1)
                    for v in (s, shift))
        return _store_act(F.silu(y * s + shift))


class PhaseStemB(_PhaseStem):
    """Phase-layout replacement for l1 = Conv (ConvBnAct c2, 3, 2).

    Input (B, 4 ci, H/4, W/4) in (qy, qx, ci) order, PhaseStemA's output;
    output the standard (B, c2, H/4, W/4) map, so every row from 2 on is
    unchanged. The (1, 0) padding of the 2x2 conv is a padding of 1 with
    the last output row and column dropped (no padded copy of the input:
    on the card 1.04 ms at b128/640 bf16 with the crop's copy, against
    1.81 for ``F.pad`` and the conv, PERF.md)."""

    def __init__(self, ci: int, c2: int):
        super().__init__()
        self.conv = Conv2d(ci, c2, 3, 2, 1, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        x = to_compute(x, w.dtype)
        y = F.conv2d(x, phase_stem_kernel_b(w).to(x.dtype), None, 1, 1)
        y = y[:, :, :-1, :-1]
        # BN on the strided crop takes PyTorch's generic elementwise path
        # (a 1.97 ms kernel at b128/640 bf16 on the card, PERF.md); the
        # copy gives it the channels_last BN kernel
        mf = (torch.channels_last
              if x.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
        y = self.bn(y.contiguous(memory_format=mf))
        return _store_act(F.silu(y))


class FFM(QuantAware, nn.Module):
    """Feature-fusion module: conv + channel attention, residual add:
    ``att = sigmoid(fc2(silu(fc1(mean(feat)))))``, ``out = feat*att + feat``.
    ``channel_attention`` indices 1 and 3 are the reference's fc1/fc2. In
    int8 the gate multiplies the int8 map and requantizes at site
    ``gate``."""

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
        return self._gated(self.convblk(x))

    def _gated(self, feat: torch.Tensor) -> torch.Tensor:
        # channel_attention[0]'s pool, over the whole map of a band
        att = self.channel_attention[1:](adaptive_avg_pool(feat, 1))
        return feat * att + feat

    def qmap(self) -> dict:
        return {"convblk": "convblk"}

    def _attention(self, att: torch.Tensor) -> torch.Tensor:
        """fc1, SiLU, fc2 on the int8 map's (B, C, 1, 1) statistics, in
        the compute dtype (the int8 gate)."""
        dt = self.cdtype or self.convblk.conv.weight.dtype
        fc1, fc2 = self.channel_attention[1], self.channel_attention[3]
        att = F.silu(F.conv2d(att.to(dt), fc1.weight.to(dt)))
        return F.conv2d(att, fc2.weight.to(dt))

    def qforward(self, x):
        q = self.quant
        if isinstance(x, (list, tuple)):
            x = (qt_maybe_cat(list(x)) if isinstance(x[0], QTensor)
                 else maybe_cat(list(x)))
        feat = self.convblk.qforward(x)
        if isinstance(feat, QTensor):
            dev = feat.data.device
            s = Q.scale_t(feat.scale, dev)
            att = feat.data.float().mean(dim=(2, 3), keepdim=True) * s
            gate = (torch.sigmoid(self._attention(att)) + 1.0).float()
            y = feat.data.float() * (s * gate)
            s_out = q.scale_for(Q.site_key(self, "gate"))
            return QTensor(torch.clamp(torch.round(y / Q.scale_t(s_out, dev)),
                                       -Q.QMAX, Q.QMAX).to(torch.int8), s_out)
        out = self._gated(to_compute(feat, self.convblk.conv.weight.dtype))
        if q is not None and q.is_calib:
            Q.sow_absmax(self, "gate", out)
        return out


class DilatedConvBnSiLU(QuantAware, nn.Sequential):
    """Dilated 3x3 conv (bias=False) + BN + SiLU, always with its BN; indices
    0/1 are the reference's conv/bn names. Site ``out`` only (no input
    site, no bias correction; its weights-only mode is the fp block), as in
    the JAX package."""

    def __init__(self, c1: int, c2: int, d: int):
        super().__init__(
            Conv2d(c1, c2, 3, 1, padding=d, dilation=d, bias=False),
            batch_norm(c2),
            nn.SiLU(),
        )

    def qforward(self, x):
        q = self.quant
        conv, bn = self[0], self[1]
        if q is not None and q.is_int8:
            def make(scales, chans):
                return int8_conv.prepare(
                    conv.weight, scales, chans, padding=conv.padding,
                    dilation=conv.dilation[0], bn=Q.bn_fold_constants(bn))

            return int8_block(self, "conv", x, make, act=True,
                              out_scale=q.scale_for(Q.site_key(self, "out")))
        y = self(to_compute(x, conv.weight.dtype))
        if q is not None and q.is_calib:
            Q.sow_absmax(self, "out", y)
        return _store_act(y)


class GlobalBranch(QuantAware, nn.Sequential):
    """AdaptiveAvgPool(1) + 1x1 ConvBnAct (its BN never runs: 1x1 input),
    broadcast back to ``out_hw`` by a nearest resize."""

    def __init__(self, c1: int, c2: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), ConvBnAct(c1, c2, 1))

    def forward(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        # adaptive_avg_pool is self[0]'s op, over the whole map of a band
        return resize_nearest(self[1](adaptive_avg_pool(x, 1)), out_hw)

    def qmap(self) -> dict:
        return {"1": "conv"}

    def qforward(self, x, out_hw):
        if isinstance(x, QTensor):
            g = self[1].qforward(Q.qt_global_avg_pool(x, 1))
            return QTensor(broadcast_hw(g.data, out_hw), g.scale)
        g = adaptive_avg_pool_separable(
            to_compute(x, self[1].conv.weight.dtype), 1)
        return broadcast_hw(self[1].qforward(g), out_hw)

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

    def qforward(self, x):
        """fp8 storage (SegMaskLab's ASPP): the branches store, the global
        one stays in the compute dtype, their concat under ``maybe_cat``."""
        feats = [self.branch0[0].qforward(x), self.branch1.qforward(x),
                 self.branch2.qforward(x), self.branch3.qforward(x)]
        if self.branch4 is not None:
            feats.append(self.branch4.qforward(x, _spatial(x)))
        return self.ConvLinear.qforward(maybe_cat(feats))


def _cat_feats(feats):
    return (qt_maybe_cat(feats) if isinstance(feats[0], QTensor)
            else maybe_cat(feats))


class RFB2(QuantAware, nn.Module):
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

    def qmap(self) -> dict:
        out = {"branch3.0": "branch3", "branch0.0": "branch0_a",
               "branch0.1": "branch0_b", "branch1": "branch1",
               "branch2": "branch2", "ConvLinear": "conv_linear"}
        if self.branch4 is not None:
            out["branch4"] = "branch4"
        return out

    def qforward(self, x):
        x3 = self.branch3[0].qforward(x)
        x0 = self.branch0[1].qforward(self.branch0[0].qforward(x))
        x1 = self.branch1.qforward(x0)
        x2 = self.branch2.qforward(x1)
        feats = [x0, x1, x2, x3]
        if self.branch4 is not None:
            feats.append(self.branch4.qforward(x2, _spatial(x)))
        return self.ConvLinear.qforward(_cat_feats(feats))


class ACSP(QuantAware, nn.Module):
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

    def qmap(self) -> dict:
        out = {"branch0.0": "branch0_a", "branch0.1": "branch0_b",
               "branch1": "branch1", "branch2": "branch2",
               "ConvLinear": "conv_linear"}
        if self.branch_global is not None:
            out["branch_global"] = "branch_global"
        return out

    def qforward(self, x):
        x0 = self.branch0[1].qforward(self.branch0[0].qforward(x))
        x1 = self.branch1.qforward(x0)
        x2 = self.branch2.qforward(x1)
        feats = [x0, x1, x2]
        if self.branch_global is not None:
            feats.append(self.branch_global.qforward(x2, _spatial(x)))
        return self.ConvLinear.qforward(_cat_feats(feats))


class PyramidPooling(QuantAware, nn.Module):
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
        feats = [x] if self.short_cut else []
        for i, k in enumerate(self.k):
            y = getattr(self, f"conv{i + 1}")(adaptive_avg_pool(x, k))
            feats.append(resize_bilinear_onto(y, x))
        return torch.cat(feats, 1)

    def quirk_bn_prefixes(self):
        return [f"conv{i + 1}.bn." for i, k in enumerate(self.k) if k == 1]

    def qmap(self) -> dict:
        return {f"conv{i + 1}": f"conv{i + 1}" for i in range(len(self.k))}

    def qforward(self, x):
        """int8: pooled at the input scale, the small maps convolved in
        int8, upsampled at the conv's output scale."""
        hw = _spatial(x)
        feats = [x] if self.short_cut else []
        for i, k in enumerate(self.k):
            conv = getattr(self, f"conv{i + 1}")
            if isinstance(x, QTensor):
                y = conv.qforward(Q.qt_global_avg_pool(x, k))
                feats.append(Q.qt_resize_bilinear(y, hw, align_corners=True))
            else:
                y = conv.qforward(adaptive_avg_pool_separable(x, k))
                feats.append(resize_store(y, hw))
        if isinstance(x, QTensor):
            return Q.qt_concat(feats)
        return cat_parts(widen_mixed(feats))


def resize_store(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The align_corners bilinear resize of the seg paths on an fp map: the
    JAX package's bf16 form for an fp8-stored map (cast back to fp8),
    PyTorch's otherwise."""
    if x.dtype in F8_DTYPES:
        return resize_bilinear_separable(x, out_hw, align_corners=True)
    return resize_bilinear(x, out_hw, align_corners=True)


# ---------------------------------------------------------------------------
# Blocks the model DSL cannot name, kept importable as in the JAX package
# (desenet_tpu/models/layers.py: ARM, ASPPs, RFB1, DAPPM, ConvBNReLU,
# Classify, Sum). Child modules carry the JAX modules' names, so that
# ``utils/convert.block_state_dict_from_jax`` carries one block's flax
# variables across. They run in the fp forward only (no ``qforward``).


class ARM(nn.Module):
    """BiSeNet attention refinement: a 3x3 ConvBnAct, then an SE gate (a
    global pool, a 1x1 ConvBnAct without activation whose BN never runs on
    the 1x1 map, a sigmoid) scaling it."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = ConvBnAct(c1, c2, 3, 1)
        self.att_conv = ConvBnAct(c2, c2, 1, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        return feat * torch.sigmoid(self.att_conv(adaptive_avg_pool(feat, 1)))

    def qforward(self, x):
        """fp8 storage: the 3x3 conv stores; the gate and the product run
        in the compute dtype."""
        dt = self.conv.conv.weight.dtype
        feat = to_compute(self.conv.qforward(x), dt)
        att = self.att_conv.qforward(adaptive_avg_pool(feat, 1))
        return feat * torch.sigmoid(to_compute(att, dt))

    def quirk_bn_prefixes(self):
        return ["att_conv.bn."]


class ASPPs(nn.Module):
    """ASPP with a 1x1 input reduction in each branch: branch0 a 1x1 and a
    3x3, branches 1-3 a 1x1 then a dilated 3x3 (``d``), the global branch
    on the input if ``has_global``, all to c1 // map_reduce, concatenated
    into a 1x1 ConvBnAct."""

    def __init__(self, c1: int, c2: int, d: Sequence[int] = (3, 6, 9),
                 has_global: bool = True, map_reduce: int = 4):
        super().__init__()
        hid = c1 // map_reduce
        self.d = tuple(d)
        self.branch0_a = ConvBnAct(c1, hid, 1)
        self.branch0_b = ConvBnAct(hid, hid, 3)
        for i, di in enumerate(self.d, start=1):
            setattr(self, f"branch{i}_red", ConvBnAct(c1, hid, 1))
            setattr(self, f"branch{i}", DilatedConvBnSiLU(hid, hid, di))
        self.branch4 = GlobalBranch(c1, hid) if has_global else None
        self.conv_linear = ConvBnAct(hid * (len(self.d) + 1 + has_global),
                                     c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0_b(self.branch0_a(x))]
        for i in range(1, len(self.d) + 1):
            outs.append(getattr(self, f"branch{i}")(
                getattr(self, f"branch{i}_red")(x)))
        if self.branch4 is not None:
            outs.append(self.branch4(x, x.shape[2:]))
        return self.conv_linear(torch.cat(outs, 1))

    def qforward(self, x):
        """fp8 storage: every ConvBnAct and dilated conv stores."""
        outs = [self.branch0_b.qforward(self.branch0_a.qforward(x))]
        for i in range(1, len(self.d) + 1):
            outs.append(getattr(self, f"branch{i}").qforward(
                getattr(self, f"branch{i}_red").qforward(x)))
        if self.branch4 is not None:
            outs.append(self.branch4.qforward(x, _spatial(x)))
        return self.conv_linear.qforward(maybe_cat(outs))

    def quirk_bn_prefixes(self):
        return ["branch4.1.bn."] if self.branch4 is not None else []


class RFB1(nn.Module):
    """ASPP-like block with pre-convs: branch0 a 1x1 and a 3x3, branches
    1-3 a 1x1, a 3x3/3x3/5x5 pre-conv and a dilated 3x3 (``d``), the
    global branch on the input if ``has_global``, all to
    c1 // map_reduce, concatenated into a 1x1 ConvBnAct (``fusion``)."""

    PRE_K = (3, 3, 5)

    def __init__(self, c1: int, c2: int, map_reduce: int = 4,
                 d: Sequence[int] = (3, 5, 7), has_global: bool = False):
        super().__init__()
        inter = c1 // map_reduce
        self.d = tuple(d)
        self.branch0_a = ConvBnAct(c1, inter, 1)
        self.branch0_b = ConvBnAct(inter, inter, 3)
        for i, di in enumerate(self.d, start=1):
            setattr(self, f"branch{i}_red", ConvBnAct(c1, inter, 1))
            setattr(self, f"branch{i}_pre",
                    ConvBnAct(inter, inter, self.PRE_K[i - 1]))
            setattr(self, f"branch{i}", DilatedConvBnSiLU(inter, inter, di))
        self.branch4 = GlobalBranch(c1, inter) if has_global else None
        self.fusion = ConvBnAct(inter * (len(self.d) + 1 + has_global), c2,
                                1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0_b(self.branch0_a(x))]
        for i in range(1, len(self.d) + 1):
            y = getattr(self, f"branch{i}_pre")(
                getattr(self, f"branch{i}_red")(x))
            outs.append(getattr(self, f"branch{i}")(y))
        if self.branch4 is not None:
            outs.append(self.branch4(x, x.shape[2:]))
        return self.fusion(torch.cat(outs, 1))

    def qforward(self, x):
        """fp8 storage: every ConvBnAct and dilated conv stores."""
        outs = [self.branch0_b.qforward(self.branch0_a.qforward(x))]
        for i in range(1, len(self.d) + 1):
            y = getattr(self, f"branch{i}_pre").qforward(
                getattr(self, f"branch{i}_red").qforward(x))
            outs.append(getattr(self, f"branch{i}").qforward(y))
        if self.branch4 is not None:
            outs.append(self.branch4.qforward(x, _spatial(x)))
        return self.fusion.qforward(maybe_cat(outs))

    def quirk_bn_prefixes(self):
        return ["branch4.1.bn."] if self.branch4 is not None else []


class DAPPM(nn.Module):
    """DDRNet's pyramid with pre-norm blocks (BN, SiLU, conv): the input
    and its 5/2, 9/4 and 17/8 average pools (zero padding counted) and
    global pool, each to ``branch_planes`` by a 1x1; each coarser scale
    upsampled (bilinear, align_corners) onto the finer result and mixed by
    a 3x3; the five concatenated and compressed to ``outplanes``, plus a
    1x1 shortcut of the input."""

    POOLS = ((5, 2), (9, 4), (17, 8))

    def __init__(self, c1: int, branch_planes: int, outplanes: int):
        super().__init__()
        bp = branch_planes

        def block(name: str, cin: int, cout: int, k: int):
            setattr(self, f"{name}_bn", batch_norm(cin))
            setattr(self, f"{name}_conv",
                    nn.Conv2d(cin, cout, k, 1, k // 2, bias=False))

        for i in range(5):
            block(f"scale{i}", c1, bp, 1)
        for i in range(1, 5):
            block(f"process{i}", bp, bp, 3)
        block("compression", 5 * bp, outplanes, 1)
        block("shortcut", c1, outplanes, 1)

    def _bn_act_conv(self, y: torch.Tensor, name: str) -> torch.Tensor:
        y = F.silu(getattr(self, f"{name}_bn")(y))
        return getattr(self, f"{name}_conv")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        scales = [self._bn_act_conv(x, "scale0")]
        for i, (k, s) in enumerate(self.POOLS, start=1):
            y = F.avg_pool2d(x, k, s, k // 2, count_include_pad=True)
            scales.append(self._bn_act_conv(y, f"scale{i}"))
        scales.append(self._bn_act_conv(adaptive_avg_pool(x, 1), "scale4"))
        outs = [scales[0]]
        for i in range(1, 5):
            up = resize_bilinear(scales[i], (h, w), align_corners=True)
            outs.append(self._bn_act_conv(up + outs[i - 1], f"process{i}"))
        comp = self._bn_act_conv(torch.cat(outs, 1), "compression")
        return comp + self._bn_act_conv(x, "shortcut")

    def qforward(self, x):
        """fp8 storage: the input upcast; the pre-norm blocks store
        nothing."""
        return self(to_compute(x, self.scale0_conv.weight.dtype))


class ConvBNReLU(nn.Module):
    """Conv (no bias) + BN + ReLU6."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 p: Optional[int] = None, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(self.bn(self.conv(x)))

    def qforward(self, x):
        """fp8 storage: the input upcast; nothing stored."""
        return self(to_compute(x, self.conv.weight.dtype))


class Classify(nn.Module):
    """Classification head: each input globally pooled, concatenated, a
    ``k``x``k`` conv with bias to ``c2``, flattened. ``c1``: the channels of
    the input, or the sum over a list of inputs."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g, bias=True)

    def forward(self, x) -> torch.Tensor:
        xs = x if isinstance(x, (list, tuple)) else [x]
        y = torch.cat([adaptive_avg_pool(v, 1) for v in xs], 1)
        return self.conv(y).flatten(1)


class Sum(nn.Module):
    """Sum of ``n`` inputs; with ``weight`` the inputs after the first are
    scaled by 2 sigmoid(w), w initialized to -(1, 2, ...) / 2."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.w = (nn.Parameter(-torch.arange(1.0, n) / 2) if weight
                  else None)

    def forward(self, xs) -> torch.Tensor:
        y = xs[0]
        if self.w is None:
            for v in xs[1:self.n]:
                y = y + v
            return y
        w = torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + xs[i + 1] * w[i]
        return y
