"""Eval BatchNorm folded into conv weights, in the layouts of the kernels.

Counterparts of ``desenet_tpu/utils/profiling.py:fold_conv_bn`` and
``desenet_tpu/utils/torch_convert.py:_focus_kernel_to_conv``; ``bn_affine``,
eval BN as a per-channel scale and shift (which the served ConvBnAct's
fused epilogue keeps, ``models/layers.ConvBnAct.fuse_epilogue``);
``fold_conv``, the one fold of a port conv and its BN, which the seg head's
fold (``ops/seg_head_pallas.py``, kernel K4) shares; and the folds that
carry the port's ``Focus`` and ``C3`` modules into the weights of kernels
K5 (``ops/stem_pallas.py``) and K6 (``ops/c3_fused.py``).

The reference skips the BN of a conv whose input map is 1x1
(``ConvBnAct.forward``); ``fold_focus`` and ``fold_c3`` take the module's
input size ``hw`` and fold that conv with no BN (scale 1, bias 0). They
return numpy float32 on the host.

No import of ``desenet_tpu_torch.models`` here: the model builder imports
the seg head's fold, which imports this module.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from desenet_tpu_torch.models.layers import (C3, ConvBnAct, Focus,
                                                 FusedFocus)


def fold_conv_bn(kernel: np.ndarray, bias, gamma, beta, mean, var,
                 eps: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic BN fold into a conv: kernel HWIO (output channels last);
    returns (kernel', bias')."""
    scale = gamma / np.sqrt(var + eps)
    k = kernel * scale.reshape(1, 1, 1, -1)
    b = (bias if bias is not None else 0.0) * scale + beta - mean * scale
    return k, b


def _focus_kernel_to_conv(w: np.ndarray) -> np.ndarray:
    """Focus conv weight (O, 4C, k, k) over the slice-concat -> the (2k, 2k,
    C, O) HWIO kernel of the same stride-2 conv on the raw image: tap
    (2*di + oy, 2*dj + ox) takes the w[:, C*(oy + 2*ox):.., di, dj] block
    (slice order (oy, ox) = (0,0), (1,0), (0,1), (1,1))."""
    o, c4, k, _ = w.shape
    c = c4 // 4
    out = np.zeros((2 * k, 2 * k, c, o), w.dtype)
    for oy in range(2):
        for ox in range(2):
            s = oy + 2 * ox
            out[oy::2, ox::2] = np.transpose(w[:, c * s:c * (s + 1)],
                                             (2, 3, 1, 0))
    return out


def fold_conv(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d | None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv (+ eval BN) -> (W f32, b f32) on the conv's device: W in HWIO,
    or (ci, co) for a 1x1; ``bn`` None for a conv whose BN never runs."""
    w = conv.weight.detach().float().permute(2, 3, 1, 0)
    if w.shape[0] == 1 and w.shape[1] == 1:
        w = w[0, 0]
    if bn is None:
        return w, torch.zeros(w.shape[-1], device=w.device)
    s, b = bn_affine(bn)
    return w * s, b


def bn_affine(bn: torch.nn.BatchNorm2d, dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as ``y * scale + shift``: (gamma * rsqrt(var + eps), beta -
    mean * scale), each (C,) in ``dtype`` on the BN's device."""
    s = bn.weight.detach().to(dtype) * torch.rsqrt(
        bn.running_var.detach().to(dtype) + bn.eps)
    shift = bn.bias.detach().to(dtype) - bn.running_mean.detach().to(dtype) * s
    return s, shift


def _fold_cba(m: ConvBnAct, bn_runs: bool) -> Tuple[np.ndarray, np.ndarray]:
    """A ConvBnAct (SiLU, groups 1) -> ``fold_conv``'s (W, b) as numpy."""
    if m.conv.groups != 1 or not isinstance(m.act, torch.nn.SiLU):
        raise ValueError("the kernels take grouped-free ConvBnAct with SiLU")
    w, b = fold_conv(m.conv, m.bn if bn_runs else None)
    return w.cpu().numpy(), b.cpu().numpy()


def fold_focus(focus: Focus | FusedFocus, hw: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's Focus or FusedFocus on (H, W) images -> (W6 (6, 6, 3, CO)
    HWIO, bias (CO,)), both f32, for ``stem_weight_matrix`` and
    ``stem_conv``. Focus's conv sees the (H/2, W/2) slice-concat, so its BN
    is skipped for a 2x2 image; FusedFocus's sees the image."""
    if isinstance(focus.conv, torch.nn.Conv2d):  # FusedFocus: one 6x6 conv
        c = focus.conv
        if c.kernel_size != (6, 6) or c.stride != (2, 2) or \
                c.padding != (2, 2) or c.in_channels != 3:
            raise ValueError("fold_focus takes FusedFocus(3, CO): a 6x6/s2 "
                             "pad-2 conv over the image")
        return _fold_cba(focus, hw[0] * hw[1] > 1)
    cba = focus.conv
    if cba.conv.kernel_size != (3, 3) or cba.conv.stride != (1, 1) or \
            cba.conv.padding != (1, 1) or cba.conv.in_channels != 12:
        raise ValueError("fold_focus takes Focus(3, CO, k=3): a 3x3/s1 pad-1 "
                         "conv over the 12-channel slice-concat")
    w, b = _fold_cba(cba, (hw[0] // 2) * (hw[1] // 2) > 1)
    return _focus_kernel_to_conv(np.transpose(w, (3, 2, 0, 1))), b


def fold_c3(c3: C3, hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """The port's C3 on (H, W) maps -> K6's params, f32, in the layout of
    ``tools/proto_c3_kernel.py``: w12 (C, 2c_) = [cv1 | cv2] (the y1 half,
    which runs through the bottlenecks, first), wb1 (n, c_, c_), wb2 (n, 9,
    c_, c_) with wb2[i, dy*3+dx] = Bottleneck i's 3x3 slice (c_in, c_out),
    w3 (2c_, C2), and biases b12, bb1, bb2, b3. Call ``c3_fused`` with
    ``n = len(c3.m)`` and ``shortcut = c3.m[0].add``. On a 1x1 map no BN
    runs, and none is folded."""
    bn = hw[0] * hw[1] > 1
    w1, b1 = _fold_cba(c3.cv1, bn)
    w2, b2 = _fold_cba(c3.cv2, bn)
    w3, b3 = _fold_cba(c3.cv3, bn)
    c_ = w1.shape[-1]
    wb1, bb1, wb2, bb2 = [], [], [], []
    for blk in c3.m:
        wa, ba = _fold_cba(blk.cv1, bn)
        wb, bb = _fold_cba(blk.cv2, bn)
        if wa.shape != (c_, c_) or wb.shape != (3, 3, c_, c_):
            raise ValueError("fold_c3 takes C3 with Bottleneck(c_, c_, e=1)")
        wb1.append(wa)
        bb1.append(ba)
        wb2.append(wb.reshape(9, c_, c_))
        bb2.append(bb)
    if len({blk.add for blk in c3.m}) > 1:
        raise ValueError("fold_c3: bottlenecks differ in their shortcut")
    return {
        "w12": np.concatenate([w1, w2], -1),
        "b12": np.concatenate([b1, b2]),
        "wb1": np.stack(wb1), "bb1": np.stack(bb1),
        "wb2": np.stack(wb2), "bb2": np.stack(bb2),
        "w3": w3, "b3": b3,
    }
