"""The served ConvBnAct's epilogue: eval BN's affine, SiLU and the
Bottleneck shortcut in one pass over the conv's output.

    out = silu(y * scale[c] + shift[c]) + residual

``scale`` and ``shift`` are the BN's per-channel constants in f32
(``utils/fold.bn_affine``), the SiLU is on with ``act``, ``residual`` is
optional. The arithmetic runs in f32 (float64 for a float64 ``y``) and is
rounded to ``y``'s dtype once.

On a card ``conv_epilogue`` launches the kernel ``csrc/conv_epilogue.cu``
and writes ``y`` in place. It takes a ``y`` in float32 or bfloat16 that
is contiguous in the channels_last memory format (NHWC in memory, so an
element's channel is its linear index mod C), f32 constants on its
device, at most ``MAX_C`` channels, a residual of ``y``'s shape, dtype and
layout or none, and no autograd graph to keep; any other card tensor is a
ValueError that names what failed. The kernel moves 16-byte vectors where
C is a multiple of 16 / element size and both tensors are 16-byte
aligned, else one element at a time. On the CPU ``conv_epilogue_plain``
computes a new tensor. Each call adds 1 to the counter ``epilogue.fused``
while tracing (on a card, after the launch); ``launches`` counts the
kernel's launches.

The phase pass (``heads.Proto``): a nearest 2x upsample followed by a 3x3
ConvBnAct runs as the 2x2 conv of ``fold_phases`` over the small map, and
``conv_epilogue_phases`` applies BN's affine and the SiLU to its four
output phases and writes each into its place in the 2x map, a fresh
tensor. It takes the same card tensors as ``conv_epilogue`` (no residual;
C channels of constants, a ``y`` of 4 C channels and at least 2 x 2
pixels), raises a ValueError that names what failed on any other, counts
``epilogue.fused`` alike, and ``phase_launches`` counts its launches;
``conv_epilogue_phases_plain`` serves the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.utils.profiling import count

MAX_C = 6144  # scale and shift staged in 48 KB of shared memory
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

launches = 0
phase_launches = 0


def conv_epilogue_plain(y: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, act: bool,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: ``y`` (N, C, H, W) and the
    (C,) constants, in f32 or wider, rounded to ``y``'s dtype once."""
    cd = torch.promote_types(y.dtype, torch.float32)
    v = (y.to(cd) * scale.to(cd).view(1, -1, 1, 1)
         + shift.to(cd).view(1, -1, 1, 1))
    if act:
        v = F.silu(v)
    if residual is not None:
        v = v + residual.to(cd)
    return v.to(y.dtype)


def _refusal(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             residual: Optional[torch.Tensor]) -> Optional[str]:
    """What keeps the kernel from these card tensors (module docstring),
    or None."""
    if y.dtype not in KERNEL_DTYPES:
        return f"y is {y.dtype}, not bfloat16 or float32"
    if y.dim() != 4 or not y.is_contiguous(
            memory_format=torch.channels_last):
        return (f"y {tuple(y.shape)} strides {y.stride()} is not a 4-d "
                "tensor contiguous in channels_last")
    if y.shape[1] > MAX_C:
        return f"{y.shape[1]} channels, more than {MAX_C}"
    for name, c in (("scale", scale), ("shift", shift)):
        if not (c.device == y.device and c.dtype == torch.float32
                and c.is_contiguous() and c.numel() == y.shape[1]):
            return (f"{name} is {c.dtype} {tuple(c.shape)} on {c.device}, "
                    f"not {y.shape[1]} contiguous float32 on {y.device}")
    if residual is not None and not (
            residual.device == y.device and residual.dtype == y.dtype
            and residual.shape == y.shape
            and residual.is_contiguous(memory_format=torch.channels_last)):
        return (f"residual {residual.dtype} {tuple(residual.shape)} on "
                f"{residual.device} differs from y's dtype, shape, device "
                "or channels_last layout")
    if torch.is_grad_enabled() and (
            y.requires_grad or (residual is not None
                                and residual.requires_grad)):
        return "an autograd graph to keep (the kernel writes y in place)"
    return None


def conv_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  act: bool, residual: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``conv_epilogue_plain``'s function: on a card through the kernel,
    in place in ``y`` (ValueError where it cannot take them); the plain
    version on the CPU."""
    global launches
    if not y.is_cuda:
        out = conv_epilogue_plain(y, scale, shift, act, residual)
    else:
        why = _refusal(y, scale, shift, residual)
        if why is not None:
            raise ValueError(f"conv_epilogue: {why}")
        width = 16 // y.element_size()
        vec = (y.shape[1] % width == 0 and y.data_ptr() % 16 == 0
               and (residual is None or residual.data_ptr() % 16 == 0))
        stream, dev = _ext.stream_and_device(y)
        _ext.check(_ext.load().desenet_conv_epilogue(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.numel() // y.shape[1],
            y.shape[1], int(act), int(y.dtype == torch.bfloat16), int(vec),
            stream, dev), "conv_epilogue kernel")
        launches += 1
        out = y
    count("epilogue.fused", 1)
    return out


# ---- a nearest 2x upsample and a 3x3 conv as four phases of one 2x2 conv ----

# output row 2i + py of the 3x3 conv over the upsampled map reads the small
# map's rows i - 1 + py + a, a = 0, 1, through these 3x3 rows (columns alike)
_PHASE_TAPS = torch.tensor([[[1., 0., 0.], [0., 1., 1.]],
                            [[1., 1., 0.], [0., 0., 1.]]])


def fold_phases(w: torch.Tensor) -> torch.Tensor:
    """A 3x3, stride-1, pad-1 conv weight (CO, CI, 3, 3) -> the 2x2 weight
    (4 CO, CI, 2, 2) whose conv over the small map, pad 1, gives the conv
    over its nearest 2x upsample as four phases: output channel p CO + o,
    p = 2 py + px, at (i + py, j + px) is output channel o at (2i + py,
    2j + px). Each tap sums the 1, 2 or 4 taps of ``w`` that read the same
    source pixel, in f32 (float64 for float64 ``w``), rounded once to
    ``w``'s dtype."""
    cd = torch.promote_types(w.dtype, torch.float32)
    t = _PHASE_TAPS.to(w.device, cd)
    k = torch.einsum("pay,oiyx,qbx->pqoiab", t, w.detach().to(cd), t)
    return k.reshape(4 * w.shape[0], w.shape[1], 2, 2).to(w.dtype)


def conv_epilogue_phases_plain(y: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor) -> torch.Tensor:
    """The phase pass in PyTorch ops: ``y`` (B, 4C, H+1, W+1), the folded
    conv's output, and the (C,) constants -> (B, C, 2H, 2W) channels_last,
    ``silu(y * scale + shift)`` of phase p = 2 py + px at (2i + py,
    2j + px), in f32 or wider, rounded to ``y``'s dtype once."""
    cd = torch.promote_types(y.dtype, torch.float32)
    b, c4, h1, w1 = y.shape
    c = c4 // 4
    s = scale.to(cd).view(1, -1, 1, 1)
    t = shift.to(cd).view(1, -1, 1, 1)
    out = torch.empty((b, c, 2 * (h1 - 1), 2 * (w1 - 1)), dtype=y.dtype,
                      device=y.device, memory_format=torch.channels_last)
    for p in range(4):
        py, px = divmod(p, 2)
        v = y[:, p * c:(p + 1) * c, py:py + h1 - 1, px:px + w1 - 1]
        out[:, :, py::2, px::2] = F.silu(v.to(cd) * s + t).to(y.dtype)
    return out


def _phases_refusal(y: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor) -> Optional[str]:
    """What keeps the phase kernel from these card tensors (module
    docstring), or None."""
    if y.dtype not in KERNEL_DTYPES:
        return f"y is {y.dtype}, not bfloat16 or float32"
    if y.dim() != 4 or not y.is_contiguous(
            memory_format=torch.channels_last):
        return (f"y {tuple(y.shape)} strides {y.stride()} is not a 4-d "
                "tensor contiguous in channels_last")
    c = scale.numel()
    if y.shape[1] != 4 * c:
        return f"y has {y.shape[1]} channels, not four times {c} constants"
    if c > MAX_C:
        return f"{c} channels, more than {MAX_C}"
    if y.shape[2] < 2 or y.shape[3] < 2:
        return f"a {y.shape[2]} x {y.shape[3]} map, not at least 2 x 2"
    for name, k in (("scale", scale), ("shift", shift)):
        if not (k.device == y.device and k.dtype == torch.float32
                and k.is_contiguous() and k.numel() == c):
            return (f"{name} is {k.dtype} {tuple(k.shape)} on {k.device}, "
                    f"not {c} contiguous float32 on {y.device}")
    if torch.is_grad_enabled() and y.requires_grad:
        return "an autograd graph to keep"
    return None


def conv_epilogue_phases(y: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """``conv_epilogue_phases_plain``'s function: on a card through the
    kernel into a fresh channels_last tensor (ValueError where it cannot
    take them); the plain version on the CPU."""
    global phase_launches
    if not y.is_cuda:
        out = conv_epilogue_phases_plain(y, scale, shift)
    else:
        why = _phases_refusal(y, scale, shift)
        if why is not None:
            raise ValueError(f"conv_epilogue_phases: {why}")
        b, c4, h1, w1 = y.shape
        c = c4 // 4
        out = torch.empty((b, c, 2 * (h1 - 1), 2 * (w1 - 1)),
                          dtype=y.dtype, device=y.device,
                          memory_format=torch.channels_last)
        vec = c % (16 // y.element_size()) == 0 and y.data_ptr() % 16 == 0
        stream, dev = _ext.stream_and_device(y)
        _ext.check(_ext.load().desenet_conv_epilogue_phases(
            y.data_ptr(), out.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            b, h1 - 1, w1 - 1, c, int(y.dtype == torch.bfloat16), int(vec),
            stream, dev), "conv_epilogue_phases kernel")
        phase_launches += 1
    count("epilogue.fused", 1)
    return out
