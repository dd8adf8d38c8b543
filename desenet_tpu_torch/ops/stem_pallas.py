"""The FusedFocus stem: a 6x6/s2 pad-2 conv from 3 channels, + bias + SiLU.

Counterpart of ``desenet_tpu/ops/stem_pallas.py``. On a CUDA tensor
``stem_conv`` launches one of the two hand-written kernels of
``csrc/stem_conv.cu`` (kernel K5) or raises: in bfloat16 the tensor-core one
(``"mma"``: an implicit GEMM on ``mma.sync``, persistent blocks, the SiLU
through ``tanh.approx.f32``), in float32 the CUDA-core one (``"fma"``, f32 sums
in tap order and the exact SiLU, 1e-5 parity); ``last_variant`` says which
the last call launched. On a CPU tensor it runs ``stem_conv_plain``, the
kernels' arithmetic in PyTorch ops: inputs and tap matrix in x.dtype, the 108
products of a pixel summed in f32, f32 bias, the exact SiLU in f32, one cast
to x.dtype. ``stem_conv_reference`` is the plain conv it is held against.

The public tap matrix keeps the JAX order (``stem_weight_matrix``) and goes
to the kernels as it is. The tensor-core kernel orders K as (ky, kx * 3 + c),
so that a pixel's taps on one input row are 18 contiguous values of the NHWC
row; each of its blocks gathers the matrix once into shared memory, the rows
in that order and laid out by ``mma.sync`` B fragment, the output channels
dealt so that a lane's results are neighbours in memory.
``stem_weight_kernel_order`` and ``stem_weight_fragments`` state those two
layouts in PyTorch ops, for the tests, which run where the kernel cannot.

Inference only (BN folded into the weights: ``utils/fold.fold_focus``), as
in the JAX package. The kernels read the NHWC image directly; the JAX
package's phase-plane prepass (``_plane_split``), which exists because the
TPU cannot deinterleave NHWC rows inside a kernel, has no counterpart here.

``served_stem`` is the served program's row 0 on the card (``DeSeNet``'s
forward on a uint8 image, ``models/layers.ConvBnAct``): the (B, H, W, 3)
uint8 batch as uploaded, widened as ``infer`` widens it (``widen_u8``), the
6x6/s2 conv on the unfolded bf16 weights (their ``stem_weight_matrix``)
with f32 sums on Hopper's warpgroup MMA, eval BN's affine in f32 and the
SiLU, rounded once to bf16: the third kernel of ``csrc/stem_conv.cu``, or
``served_stem_plain`` on a CPU tensor. It replaces the widen, the conv and
its epilogue pass, and counts ``stem.fused`` and ``epilogue.fused`` while
tracing (on a card after the launch); ``served_launches`` counts its
launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.utils.profiling import count

launches = 0  # kernel launches made by stem_conv
served_launches = 0  # kernel launches made by served_stem
last_variant = None  # "mma" or "fma": the kernel the last launch took
K_STEPS = 7   # k16 steps of the tensor-core kernel: 108 -> 112
K_TAPS = 108  # 3x3 offsets x 12 phase planes
K_PAD = 112   # the JAX tap matrix's padded depth (rows 108-111 are zero)
CO_MAX = 64   # widest stem the kernel takes (yolov5l_seg's)
SERVED_CO_MAX = 80  # widest stem served_stem takes (yolov5x6_seg's)
# the widen's factor: PyTorch's CUDA division by a scalar multiplies by its
# f32 reciprocal, so ``u8.to(bf16) / 255`` is bf16(float(u8) * INV255)
INV255 = float(np.float32(1) / np.float32(255))


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


def _kernel_order() -> np.ndarray:
    """perm[k'] = the public row kk of the kernel's row k' = ky*18 + kx*3 + c
    (k' < 108)."""
    perm = np.zeros(K_TAPS, np.int64)
    for ky in range(6):
        for kx in range(6):
            for c in range(3):
                dy, sy, dx, sx = ky // 2, ky % 2, kx // 2, kx % 2
                perm[ky * 18 + kx * 3 + c] = ((dy * 3 + dx) * 12 + sy * 6
                                              + sx * 3 + c)
    return perm



def stem_weight_kernel_order(wm: torch.Tensor) -> torch.Tensor:
    """(112, CO) tap matrix in the public order -> (112, CO) in the
    tensor-core kernel's K order, row k' = ky*18 + kx*3 + c holding tap
    W[ky, kx, c]; rows 108-111 zero."""
    idx = torch.from_numpy(_kernel_order()).to(wm.device)
    return torch.cat([wm.index_select(0, idx),
                      wm.new_zeros((K_PAD - K_TAPS, wm.shape[1]))])


def fragment_channels(co: int) -> np.ndarray:
    """(CO/8, 8): the output channel behind column g of n8 tile nt in the
    kernel's B fragments. The kernel takes the n-tiles in passes of 4 (the
    last may have fewer, nj); a lane's C fragment holds columns 2t, 2t + 1
    of each n-tile of the pass, and the columns are dealt so that those are
    the 2 nj neighbouring channels from 32 pass + 2 nj t on, which it
    stores as one piece."""
    nts = co // 8
    cols = np.zeros((nts, 8), np.int64)
    for nt in range(nts):
        p, j = divmod(nt, 4)
        nj = min(4, nts - 4 * p)
        for g in range(8):
            cols[nt, g] = 32 * p + 2 * nj * (g // 2) + 2 * j + g % 2
    return cols


def stem_weight_fragments(wm: torch.Tensor) -> torch.Tensor:
    """(112, CO) tap matrix in the public order -> (7, CO/8, 32, 2, 2): the
    ``mma.sync`` m16n8k16 B fragments that a block of the tensor-core kernel
    gathers, the matrix's rows in the kernel's K order and its columns dealt
    by ``fragment_channels``. For k16
    step ks and n8 tile nt, lane 4g + t holds registers b0, b1, each two
    neighbouring k: element [ks, nt, 4g + t, r, h] is row
    16 ks + 2 t + 8 r + h, channel ``fragment_channels(CO)[nt, g]``."""
    co = wm.shape[1]
    cols = torch.from_numpy(fragment_channels(co).reshape(-1)).to(wm.device)
    wk = stem_weight_kernel_order(wm).index_select(1, cols)
    return wk.view(K_STEPS, 2, 4, 2, co // 8, 8).permute(
        0, 4, 5, 2, 1, 3).reshape(K_STEPS, co // 8, 32, 2, 2).contiguous()


def stem_patches_kernel_order(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/2, W/2, 108): each output pixel's 6 x 18 window
    of the zero-padded image, flat in the kernel's K order."""
    b, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    xp = F.pad(x, (0, 0, 2, 2, 2, 2)).reshape(b, h + 4, (w + 4) * 3)
    rows = [xp[:, ky:ky + 2 * ho:2].unfold(2, 18, 6)[:, :, :wo]
            for ky in range(6)]
    return torch.cat(rows, -1)


def pick_variant(dtype: torch.dtype) -> str:
    """The kernel ``stem_conv`` launches on a CUDA tensor: ``"mma"`` (tensor
    cores) in bfloat16, ``"fma"`` (CUDA cores) in float32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _silu_f32(y):
    return y * torch.sigmoid(y)


def _tap_sums(x: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """The (B, H/2, W/2, 108) tap patches of the zero-padded image times
    the tap matrix, summed in f32."""
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
    return torch.matmul(patches.float(), wm[:K_TAPS].float())


def stem_conv_plain(x: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor,
                    silu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: the (B, H/2, W/2, 108) tap
    patches of the zero-padded image times the tap matrix, in f32."""
    y = _tap_sums(x, wm) + bias.float()
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
    global launches, last_variant
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
    if x.data_ptr() % 16:  # a view that starts off the kernels' 16-byte copies
        x = x.clone()
    b, h, w, _ = x.shape
    out = torch.empty((b, h // 2, w // 2, co), dtype=x.dtype, device=x.device)
    variant = pick_variant(x.dtype)
    stream, dev = _ext.stream_and_device(x)
    _ext.check(_ext.load().desenet_stem_conv(
        x.data_ptr(), wm.data_ptr(), bias.data_ptr(), b, h, w, co, int(silu),
        int(x.dtype == torch.bfloat16), int(variant == "mma"),
        out.data_ptr(), stream, dev), f"stem_conv kernel ({variant})")
    launches += 1
    last_variant = variant
    return out


# ---- the served stem -------------------------------------------------------


def widen_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> bf16 as ``infer`` widens on the card: bf16(float(x) *
    INV255)."""
    return (x.float() * INV255).to(torch.bfloat16)


def served_stem_plain(x: torch.Tensor, wm: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, silu: bool = True) -> torch.Tensor:
    """The served stem's arithmetic in PyTorch ops: ``x`` widened to bf16
    (``widen_u8``), the tap sums in f32, ``* scale + shift`` and the SiLU in
    f32, one rounding to bf16. (The kernel's SiLU, ``h + h tanh(h)`` with
    ``tanh.approx``, differs from the exact one by about 2^-11 of a value
    before the rounding.)"""
    v = _tap_sums(widen_u8(x), wm) * scale.float() + shift.float()
    if silu:
        v = _silu_f32(v)
    return v.to(torch.bfloat16)


def _served_refusal(x: torch.Tensor, wm: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor):
    """What keeps ``served_stem`` from these tensors, or None."""
    if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[3] != 3 \
            or x.shape[1] % 2 or x.shape[2] % 2 or 0 in x.shape[1:3]:
        return (f"x is {x.dtype} {tuple(x.shape)}, not a (B, H, W, 3) "
                "uint8 batch with H and W even")
    co = wm.shape[1] if wm.dim() == 2 else -1
    if wm.dtype != torch.bfloat16 or wm.dim() != 2 or wm.shape[0] != K_PAD \
            or co % 8 or not 0 < co <= SERVED_CO_MAX:
        return (f"wm is {wm.dtype} {tuple(wm.shape)}, not a bfloat16 (112, "
                f"CO) tap matrix with CO a multiple of 8 up to "
                f"{SERVED_CO_MAX}")
    for name, c in (("scale", scale), ("shift", shift)):
        if c.dtype != torch.float32 or tuple(c.shape) != (co,):
            return f"{name} is {c.dtype} {tuple(c.shape)}, not ({co},) f32"
    if not (wm.device == scale.device == shift.device == x.device):
        return "x, wm, scale and shift lie on different devices"
    if x.device.type not in ("cpu", "cuda"):
        return f"x is on {x.device}, not the CPU or a card"
    return None


def served_stem(x: torch.Tensor, wm: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, *, silu: bool = True) -> torch.Tensor:
    """The served stem (module docstring): x (B, H, W, 3) uint8, H and W
    even; wm the (112, CO) bf16 tap matrix of the conv's weights
    (``stem_weight_matrix``), CO a multiple of 8 up to ``SERVED_CO_MAX``;
    scale and shift eval BN's (CO,) f32 affine (``utils/fold.bn_affine``).
    Returns (B, H/2, W/2, CO) bf16. ValueError for tensors it cannot
    take."""
    global served_launches
    why = _served_refusal(x, wm, scale, shift)
    if why is not None:
        raise ValueError(f"served_stem: {why}")
    x = x.contiguous()
    if x.device.type == "cpu":
        out = served_stem_plain(x, wm, scale, shift, silu)
    else:
        b, h, w, _ = x.shape
        co = wm.shape[1]
        out = torch.empty((b, h // 2, w // 2, co), dtype=torch.bfloat16,
                          device=x.device)
        vec = w % 16 == 0 and x.data_ptr() % 16 == 0
        wm, scale, shift = (t.contiguous() for t in (wm, scale, shift))
        stream, dev = _ext.stream_and_device(x)
        _ext.check(_ext.load().desenet_stem_u8(
            x.data_ptr(), wm.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            b, h, w, co, int(silu), int(vec), out.data_ptr(),
            stream, dev), "served stem kernel")
        served_launches += 1
    count("stem.fused", 1)
    count("epilogue.fused", 1)
    return out
