"""The FusedFocus stem: a 6x6/s2 pad-2 conv from 3 channels, + bias + SiLU.

Counterpart of ``desenet_tpu/ops/stem_pallas.py``. On a CUDA tensor
``stem_conv`` launches the hand-written kernel ``csrc/stem_conv.cu`` (kernel
K5) or raises; on a CPU tensor it runs ``stem_conv_plain``, the kernel's
arithmetic in PyTorch ops: inputs and tap matrix in x.dtype, the 108
products of a pixel summed in f32, f32 bias, SiLU in f32, one cast to
x.dtype. ``stem_conv_reference`` is the plain conv it is held against.

Inference only (BN folded into the weights: ``utils/fold.fold_focus``), as
in the JAX package. The kernel reads the NHWC image directly; the JAX
package's phase-plane prepass (``_plane_split``), which exists because the
TPU cannot deinterleave NHWC rows inside a kernel, has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext

launches = 0  # kernel launches made by stem_conv
K_TAPS = 108  # 3x3 offsets x 12 phase planes
K_PAD = 112   # the JAX tap matrix's padded depth (rows 108-111 are zero)
CO_MAX = 64   # widest stem the kernel takes (yolov5l_seg's)


def stem_weight_matrix(w, dtype=torch.bfloat16) -> torch.Tensor:
    """(6, 6, 3, CO) HWIO kernel -> (112, CO) tap matrix in kernel order:
    kk = (dy*3+dx)*12 + sy*6 + sx*3 + c,  tap = W[2dy+sy, 2dx+sx, c]."""
    w = np.asarray(w, np.float32)
    if w.shape[:3] != (6, 6, 3) or w.ndim != 4:
        raise ValueError(f"expected a (6, 6, 3, CO) kernel, got {w.shape}")
    co = w.shape[3]
    wm = np.zeros((K_PAD, co), np.float32)
    for dy in range(3):
        for dx in range(3):
            for sy in range(2):
                for sx in range(2):
                    for c in range(3):
                        kk = (dy * 3 + dx) * 12 + sy * 6 + sx * 3 + c
                        wm[kk] = w[2 * dy + sy, 2 * dx + sx, c]
    return torch.from_numpy(wm).to(dtype)


def _silu_f32(y):
    return y * torch.sigmoid(y)


def stem_conv_plain(x: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor,
                    silu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: the (B, H/2, W/2, 108) tap
    patches of the zero-padded image times the tap matrix, in f32."""
    b, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    xp = F.pad(x, (0, 0, 2, 2, 2, 2))
    taps = []
    for dy in range(3):
        for dx in range(3):
            for sy in range(2):
                for sx in range(2):
                    ky, kx = 2 * dy + sy, 2 * dx + sx
                    taps.append(xp[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2])
    patches = torch.cat(taps, -1)  # (B, ho, wo, 108) in kk order
    y = torch.matmul(patches.float(), wm[:K_TAPS].float()) + bias.float()
    if silu:
        y = _silu_f32(y)
    return y.to(x.dtype)


def stem_conv_reference(x: torch.Tensor, w, bias=None,
                        silu: bool = True) -> torch.Tensor:
    """Plain-conv reference: 6x6/s2 pad-2 conv of NHWC ``x`` with the HWIO
    kernel ``w`` (inputs in x.dtype, f32 sums), + bias, SiLU, in x.dtype."""
    w = torch.as_tensor(np.asarray(w, np.float32)).to(x.device, x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), stride=2, padding=2)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + torch.as_tensor(bias).to(x.device, torch.float32)
    if silu:
        y = _silu_f32(y)
    return y.to(x.dtype)


def stem_conv(x: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor, *,
              silu: bool = True) -> torch.Tensor:
    """6x6/s2 'same' (pad 2) conv + bias + optional SiLU.

    x: (B, H, W, 3) float32 or bfloat16, H and W even (an NCHW
    ``channels_last`` image permuted with ``.permute(0, 2, 3, 1)`` is that
    layout); wm: (112, CO) from ``stem_weight_matrix`` (BN pre-folded), cast
    to x.dtype here; bias: (CO,), used in f32. CO is a multiple of 8 up to
    64. Returns (B, H/2, W/2, CO) in x.dtype. The JAX function's
    ``block_rows`` and ``interpret`` are TPU tiling and interpreter knobs
    and have no counterpart."""
    global launches
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem_conv needs (B, H, W, 3) with H, W even, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv runs float32 or bfloat16, not {x.dtype}")
    co = wm.shape[1] if wm.dim() == 2 else -1
    if wm.dim() != 2 or wm.shape[0] != K_PAD or co % 8 or not 0 < co <= CO_MAX:
        raise ValueError(f"stem_conv needs a (112, CO) tap matrix with CO a "
                         f"multiple of 8 up to {CO_MAX}, got {tuple(wm.shape)}")
    if tuple(bias.shape) != (co,):
        raise ValueError(f"stem_conv: bias {tuple(bias.shape)} for CO {co}")
    if wm.device != x.device or bias.device != x.device:
        raise ValueError("stem_conv: x, wm and bias lie on different devices")
    x = x.contiguous()
    wm = wm.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    if x.device.type == "cpu":
        return stem_conv_plain(x, wm, bias, silu)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv runs on CPU or CUDA, not {x.device}")
    b, h, w, _ = x.shape
    out = torch.empty((b, h // 2, w // 2, co), dtype=x.dtype, device=x.device)
    stream, dev = _ext.stream_and_device(x)
    _ext.check(_ext.load().desenet_stem_conv(
        x.data_ptr(), wm.data_ptr(), bias.data_ptr(), b, h, w, co, int(silu),
        int(x.dtype == torch.bfloat16), out.data_ptr(), stream, dev),
        "stem_conv kernel")
    launches += 1
    return out
