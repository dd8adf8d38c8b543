"""The fused int8 conv block: the counterpart of the XLA fusion that
``desenet_tpu/quant.py:int8_conv_block`` relies on.

    out = requant(act(sum_p f32(conv_i32(x_p, W_p)) * g_p + bn_b + bias
                      - corr) + res)

``x_p`` are up to four int8 input parts (an implicit channel concat, each
convolved with its slice of the int8 kernel), each part's int32 sum turned
into f32 and scaled by its per-output-channel factor ``g_p``, the parts
added in f32 in order, then the epilogue in the JAX order: BN bias, conv
bias, minus the bias-correction term, SiLU or identity, plus the
dequantized int8 residual, round half to even, clip to +-127, int8 out at
a per-tensor or per-channel scale; or f32 / bf16 logits where there is no
output scale (the seg class conv).

``prepare`` quantizes the kernel per output channel (folding per-channel
input scales into it first) and computes ``g_p``, the BN fold and the
bias-correction term: the constants the JAX package folds at trace time.
``run`` computes the block: ``int8_conv_plain`` on a CPU tensor (the conv
in float64, exact while |sum| < 2^53, cast to int32; ``F.conv2d`` on int8
wraps modulo 256 on the CPU), the kernel ``csrc/int8_conv.cu`` on a CUDA
tensor (an implicit GEMM on ``mma.sync`` m16n8k32 s8, one GEMM a group
for a grouped conv; a depthwise conv, one input channel a group, on a
CUDA-core kernel of the same source; ``launches`` counts the launches of
either). No fallback: a CUDA tensor builds and launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MAX_PARTS = 4
BK = 32  # the kernel's depth step in bytes (csrc/int8_conv.cu kBK)
OUT_INT8, OUT_F32, OUT_BF16, OUT_I32 = 0, 1, 2, 3

launches = 0


@dataclasses.dataclass
class Prepared:
    """The constants of one int8 conv site, on the weight's device."""

    qw: torch.Tensor  # (O, C_in / groups, KH, KW) int8
    g: List[torch.Tensor]  # per part (O,) f32
    bn_b: Optional[torch.Tensor]  # (O,) f32
    bias: Optional[torch.Tensor]  # (O,) f32
    corr: Optional[torch.Tensor]  # (O,) f32
    channels: List[int]  # per part
    stride: int
    padding: tuple  # (pad_h, pad_w)
    dilation: int
    groups: int
    packed: Optional[torch.Tensor] = None  # the kernel's weight layout
    koff: Optional[List[int]] = None
    kpad: Optional[List[int]] = None
    kpack: Optional[List[bool]] = None
    zeros: Optional[torch.Tensor] = None  # (O,) f32: absent epilogue terms


def prepare(kernel: torch.Tensor, part_scales: Sequence, channels: Sequence[int],
            *, stride: int = 1, padding=(0, 0), dilation: int = 1,
            groups: int = 1, bn=None, bias=None, in_mean=None,
            mse_clip: bool = False) -> Prepared:
    """Fold the site's constants as ``int8_conv_block`` does. ``kernel``:
    OIHW float weights; ``part_scales``: the input parts' scales (floats or
    per-channel tuples; grouped convs take per-tensor ones only);
    ``bn``: (scale, bias) f32 vectors or None; ``in_mean``: the calibrated
    input channel means (numpy) or None."""
    from desenet_tpu_torch.quant import quantize_kernel, scale_vec

    dev = kernel.device
    per_channel_in = any(isinstance(s, tuple) for s in part_scales)
    if per_channel_in and groups != 1:
        raise ValueError("a grouped int8 conv takes per-tensor input scales")
    if per_channel_in:
        s_in = np.concatenate([scale_vec(s, c)
                               for s, c in zip(part_scales, channels)])
        kernel_src = kernel.float() * torch.from_numpy(s_in).to(dev).view(
            1, -1, 1, 1)
    else:
        s_in = None
        kernel_src = kernel.float()
    qw, s_w = quantize_kernel(kernel_src, mse_clip=mse_clip)
    g = s_w * bn[0] if bn is not None else s_w
    corr = None
    if in_mean is not None and groups == 1:
        w_err = qw.float() * s_w.view(-1, 1, 1, 1) - kernel_src
        e_x = np.asarray(in_mean, np.float32)
        if s_in is not None:
            e_x = e_x / s_in
        corr = torch.einsum("oihw,i->o", w_err,
                            torch.from_numpy(np.asarray(e_x, np.float32))
                            .to(dev))
        if bn is not None:
            corr = corr * bn[0]
    gs = [g if per_channel_in else
          g * torch.tensor(float(s), dtype=torch.float32, device=dev)
          for s in part_scales]
    pad = padding if isinstance(padding, tuple) else (padding, padding)
    return Prepared(
        qw=qw, g=gs, bn_b=None if bn is None else bn[1].float(),
        bias=None if bias is None else bias.detach().float(), corr=corr,
        channels=list(channels), stride=stride, padding=tuple(pad),
        dilation=dilation, groups=groups)


def _out_hw(h: int, w: int, p: Prepared):
    kh, kw = p.qw.shape[2:]
    d = p.dilation
    ho = (h + 2 * p.padding[0] - d * (kh - 1) - 1) // p.stride + 1
    wo = (w + 2 * p.padding[1] - d * (kw - 1) - 1) // p.stride + 1
    return ho, wo


def int8_conv_plain(parts: Sequence[torch.Tensor], p: Prepared,
                    residual: Optional[torch.Tensor] = None,
                    res_scale: Optional[torch.Tensor] = None,
                    out_scale: Optional[torch.Tensor] = None,
                    act: bool = False, out_mode: int = OUT_INT8
                    ) -> torch.Tensor:
    """The block in PyTorch ops: each part's conv in float64 (exact) cast
    to int32, then the f32 epilogue in the kernel's order. ``out_mode``
    OUT_I32 returns the int32 sum over all parts with no epilogue.
    ``res_scale`` / ``out_scale``: f32 tensors broadcastable over NCHW."""
    acc, isum, off = None, None, 0
    for data, g in zip(parts, p.g):
        c = data.shape[1]
        w = p.qw[:, off:off + c] if len(parts) > 1 else p.qw
        off += c
        y = F.conv2d(data.double(), w.double(), None, p.stride,
                     p.padding, p.dilation, p.groups).to(torch.int32)
        if out_mode == OUT_I32:
            isum = y if isum is None else isum + y
            continue
        y = y.float() * g.view(1, -1, 1, 1)
        acc = y if acc is None else acc + y
    if out_mode == OUT_I32:
        return isum
    for v in (p.bn_b, p.bias):
        if v is not None:
            acc = acc + v.view(1, -1, 1, 1)
    if p.corr is not None:
        acc = acc - p.corr.view(1, -1, 1, 1)
    if act:
        acc = acc * torch.sigmoid(acc)
    if residual is not None:
        acc = acc + residual.float() * res_scale
    if out_mode == OUT_F32:
        return acc
    if out_mode == OUT_BF16:
        return acc.to(torch.bfloat16)
    return torch.clamp(torch.round(acc / out_scale), -127.0, 127.0).to(
        torch.int8)


class _Args(ctypes.Structure):
    """``Int8ConvArgs`` of csrc/int8_conv.cu, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p * MAX_PARTS),
        ("g", ctypes.c_void_p * MAX_PARTS),
        ("c", ctypes.c_int * MAX_PARTS),
        ("ld", ctypes.c_int * MAX_PARTS),
        ("kpad", ctypes.c_int * MAX_PARTS),
        ("koff", ctypes.c_int * MAX_PARTS),
        ("vec", ctypes.c_int * MAX_PARTS),
        ("kpack", ctypes.c_int * MAX_PARTS),
        ("nparts", ctypes.c_int),
        ("w", ctypes.c_void_p),
        ("ktot", ctypes.c_int),
        ("bnb", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("corr", ctypes.c_void_p),
        ("res", ctypes.c_void_p),
        ("res_ld", ctypes.c_int),
        ("res_scale", ctypes.c_void_p),
        ("out_scale", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("out_ld", ctypes.c_int),
        ("out_mode", ctypes.c_int),
        ("act", ctypes.c_int),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("Ho", ctypes.c_int), ("Wo", ctypes.c_int), ("O", ctypes.c_int),
        ("KH", ctypes.c_int), ("KW", ctypes.c_int), ("stride", ctypes.c_int),
        ("pad_h", ctypes.c_int), ("pad_w", ctypes.c_int),
        ("dil", ctypes.c_int),
        ("groups", ctypes.c_int),
    ]


def pack_weights(p: Prepared) -> None:
    """The kernel's weight layout, once a site: (O, ktot) int8, part by
    part. A part of at least BK channels goes tap by tap (row-major over
    KH, KW), each tap's channels zero-padded to a multiple of BK (``kpad``
    is that padded width); a narrower one (``kpack``) as one run of (kh,
    kw, c), zero-padded to a multiple of BK (``kpad`` its whole length).
    A grouped conv's one part counts a group's channels: each output
    channel's row holds its own group's weights."""
    if p.packed is not None:
        return
    o, cg, kh, kw = p.qw.shape
    cols, koff, kpad, kpack, off, k = [], [], [], [], 0, 0
    for c in (p.channels if p.groups == 1 else [cg]):
        w = p.qw[:, off:off + c].permute(0, 2, 3, 1)  # (O, KH, KW, c)
        packed = c < BK
        if packed:
            n = kh * kw * c
            cp = -(-n // BK) * BK
            w = F.pad(w.reshape(o, n), (0, cp - n))
            k_len = cp
        else:
            cp = -(-c // BK) * BK
            w = F.pad(w, (0, cp - c)).reshape(o, kh * kw * cp)
            k_len = kh * kw * cp
        cols.append(w)
        koff.append(k)
        kpad.append(cp)
        kpack.append(packed)
        k += k_len
        off += c
    p.packed = torch.cat(cols, 1).contiguous()
    p.koff, p.kpad, p.kpack = koff, kpad, kpack
    p.zeros = torch.zeros(o, dtype=torch.float32, device=p.qw.device)


def _pixel_view(t: torch.Tensor):
    """(pointer, pixel stride in elements) of an NCHW tensor whose channels
    are contiguous at each pixel and whose pixels are evenly spaced (a
    channels_last tensor or a channel slice of one); None otherwise."""
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    if sc != 1 and c > 1:
        return None
    if h * w > 1 and not (sh == w * sw and (n == 1 or sn == h * sh)):
        return None
    ld = sw if w > 1 else (sh if h > 1 else (sn if n > 1 else c))
    return t.data_ptr(), ld


def _nhwc(t: torch.Tensor):
    v = _pixel_view(t)
    if v is None:
        t = t.contiguous(memory_format=torch.channels_last)
        v = _pixel_view(t)
    return t, v


def int8_conv_kernel(parts: Sequence[torch.Tensor], p: Prepared,
                     residual: Optional[torch.Tensor] = None,
                     res_scale: Optional[torch.Tensor] = None,
                     out_scale: Optional[torch.Tensor] = None,
                     act: bool = False, out_mode: int = OUT_INT8
                     ) -> torch.Tensor:
    """The block on the card: one launch of ``int8_conv_kernel`` from
    csrc/int8_conv.cu. Arguments as ``int8_conv_plain``; the output is
    NCHW in the channels_last memory format."""
    global launches
    from desenet_tpu_torch.ops import _ext

    if not 1 <= len(parts) <= (MAX_PARTS if p.groups == 1 else 1):
        raise ValueError(f"int8 conv takes 1 to {MAX_PARTS} input parts, "
                         f"one for a grouped conv, got {len(parts)}")
    x0 = parts[0]
    dev = x0.device
    b, _, h, w = x0.shape
    for t in parts:
        if t.device != dev or t.dtype != torch.int8 or t.dim() != 4 \
                or t.shape[0] != b or tuple(t.shape[2:]) != (h, w):
            raise ValueError("int8 conv parts must be int8 NCHW tensors of "
                             f"one batch and map on {dev}, got "
                             f"{[(tuple(q.shape), q.dtype) for q in parts]}")
    pack_weights(p)
    o = p.qw.shape[0]
    kh, kw = p.qw.shape[2:]
    ho, wo = _out_hw(h, w, p)
    out_dtype = {OUT_INT8: torch.int8, OUT_F32: torch.float32,
                 OUT_BF16: torch.bfloat16, OUT_I32: torch.int32}[out_mode]
    out = torch.empty((b, o, ho, wo), dtype=out_dtype, device=dev,
                      memory_format=torch.channels_last)
    a = _Args()
    keep = []
    for i, t in enumerate(parts):
        t, (ptr, ld) = _nhwc(t)
        keep.append(t)
        c = t.shape[1] // p.groups  # a group's channels
        a.x[i], a.c[i], a.ld[i] = ptr, c, ld
        a.g[i] = p.g[i].data_ptr()
        a.kpad[i], a.koff[i] = p.kpad[i], p.koff[i]
        a.kpack[i] = int(p.kpack[i])
        a.vec[i] = int(c % 16 == 0 and ld % 16 == 0 and ptr % 16 == 0)
    a.nparts = len(parts)
    a.w, a.ktot = p.packed.data_ptr(), p.packed.shape[1]
    zeros = p.zeros
    a.bnb = (p.bn_b if p.bn_b is not None else zeros).data_ptr()
    a.bias = (p.bias if p.bias is not None else zeros).data_ptr()
    a.corr = (p.corr if p.corr is not None else zeros).data_ptr()
    vecs = []
    if residual is not None:
        residual, (rptr, rld) = _nhwc(residual)
        rs = res_scale.reshape(-1).expand(o).contiguous()
        vecs.append(rs)
        a.res, a.res_ld, a.res_scale = rptr, rld, rs.data_ptr()
    if out_mode == OUT_INT8:
        os_ = out_scale.reshape(-1).expand(o).contiguous()
        vecs.append(os_)
        a.out_scale = os_.data_ptr()
    a.out, a.out_ld, a.out_mode, a.act = out.data_ptr(), o, out_mode, int(act)
    a.B, a.H, a.W, a.Ho, a.Wo, a.O = b, h, w, ho, wo, o
    a.KH, a.KW, a.stride = kh, kw, p.stride
    a.pad_h, a.pad_w, a.dil = p.padding[0], p.padding[1], p.dilation
    a.groups = p.groups
    stream, device = _ext.stream_and_device(x0)
    _ext.check(_ext.load().desenet_int8_conv(ctypes.addressof(a), stream,
                                             device), "int8_conv")
    launches += 1
    del keep, vecs  # the caching allocator orders their reuse after it
    return out


def run(parts: Sequence[torch.Tensor], p: Prepared,
        residual: Optional[torch.Tensor] = None,
        res_scale: Optional[torch.Tensor] = None,
        out_scale: Optional[torch.Tensor] = None, act: bool = False,
        out_mode: int = OUT_INT8) -> torch.Tensor:
    """The block: the plain version on a CPU tensor, the kernel on a CUDA
    tensor, anything else raises."""
    dev = parts[0].device
    if dev.type == "cpu":
        return int8_conv_plain(parts, p, residual, res_scale, out_scale, act,
                               out_mode)
    if dev.type == "cuda":
        return int8_conv_kernel(parts, p, residual, res_scale, out_scale, act,
                                out_mode)
    raise ValueError(f"int8 conv on {dev}: CPU or CUDA tensors only")
