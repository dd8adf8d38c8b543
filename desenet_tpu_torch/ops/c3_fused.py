"""The fused C3 block (inference, BN folded): cv12 1x1 -> n x Bottleneck
(1x1, 3x3, optional residual) -> concat -> cv3 1x1, SiLU after each.

Counterpart of the kernel half of ``tools/proto_c3_kernel.py``. On a CUDA
tensor ``c3_fused`` launches the hand-written kernel ``csrc/c3_fused.cu``
(kernel K6) or raises; on a CPU tensor it runs ``c3_plain``, which mirrors
the TPU kernel ``_c3_kernel``: products of x.dtype values summed in f32, f32
biases and SiLU, and a rounding to x.dtype in exactly four places (y1 and y2
after the first SiLU, t after the bottleneck's 1x1, y1 after the residual
add, the output). The proto's ``c3_xla`` rounds every product to x.dtype
before the bias instead, so in bf16 it is not what the kernel computes.

Parameters come in the proto's layout (``c3_params``; from the port's ``C3``
module through ``utils/fold.fold_c3``): w12 (C, 2c_) = [cv1 | cv2], b12
(2c_,), wb1 (n, c_, c_), bb1 (n, c_), wb2 (n, 9, c_, c_) with wb2[i,
dy*3+dx] the (c_in, c_out) slice of bottleneck i's 3x3, bb2 (n, c_), w3
(2c_, C2), b3 (C2,). Weights in x.dtype, biases f32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext

launches = 0  # kernel launches made by c3_fused
KEYS = ("w12", "b12", "wb1", "bb1", "wb2", "bb2", "w3", "b3")
SMEM_BUDGET = 110 * 1024  # bytes of the kernel's two frame buffers (2 blocks/SM)


def c3_params(params: Mapping[str, np.ndarray], device="cpu",
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The proto's numpy params -> tensors on ``device``: weights in
    ``dtype``, biases in f32."""
    return {k: torch.as_tensor(np.asarray(params[k], np.float32)).to(
        device, dtype if k.startswith("w") else torch.float32).contiguous()
        for k in KEYS}


def _silu(y):
    return y * torch.sigmoid(y)


def _mm(a, w):
    return torch.matmul(a.float(), w.float())


def c3_plain(x: torch.Tensor, params: Mapping[str, torch.Tensor], n: int,
             shortcut: bool = True) -> torch.Tensor:
    """``_c3_kernel``'s arithmetic in PyTorch ops (the 3x3 as nine shifted
    products over a zero-padded t)."""
    dt = x.dtype
    _, h, w, _ = x.shape
    c_ = params["wb1"].shape[-1]
    y = _silu(_mm(x, params["w12"]) + params["b12"].float())
    y1, y2 = y[..., :c_].to(dt), y[..., c_:].to(dt)
    for i in range(n):
        t = _silu(_mm(y1, params["wb1"][i]) + params["bb1"][i].float()).to(dt)
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
        acc = params["bb2"][i].float()
        for dy in range(3):
            for dx in range(3):
                acc = acc + _mm(tp[:, dy:dy + h, dx:dx + w],
                                params["wb2"][i, dy * 3 + dx])
        t2 = _silu(acc)
        y1 = (y1.float() + t2 if shortcut else t2).to(dt)
    out = _mm(torch.cat([y1, y2], -1), params["w3"]) + params["b3"].float()
    return _silu(out).to(dt)


def pick_tile(c_: int, n: int, itemsize: int) -> int:
    """The kernel's output tile side: the largest of 16, 8, 4, 2, 1 whose two
    frame buffers of (tile + 2n)^2 x c_ values fit ``SMEM_BUDGET``."""
    for t in (16, 8, 4, 2, 1):
        if 2 * (t + 2 * n) ** 2 * c_ * itemsize <= SMEM_BUDGET:
            return t
    raise ValueError(f"c3_fused: c_ {c_} with {n} bottlenecks does not fit "
                     f"the kernel's shared memory")


def c3_fused(x: torch.Tensor, params: Mapping[str, torch.Tensor], n: int,
             shortcut: bool = True) -> torch.Tensor:
    """The C3 block of ``params`` on NHWC ``x`` (B, H, W, C), float32 or
    bfloat16 -> (B, H, W, C2) in x.dtype. C, c_ and C2 are multiples of 8.
    The JAX function's ``interpret`` is a TPU interpreter knob and has no
    counterpart."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"c3_fused needs NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c3_fused runs float32 or bfloat16, not {x.dtype}")
    b, h, w, c = x.shape
    c_ = params["wb1"].shape[-1]
    c2 = params["w3"].shape[-1]
    want = {"w12": (c, 2 * c_), "b12": (2 * c_,), "wb1": (n, c_, c_),
            "bb1": (n, c_), "wb2": (n, 9, c_, c_), "bb2": (n, c_),
            "w3": (2 * c_, c2), "b3": (c2,)}
    for k, shape in want.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"c3_fused: {k} is {tuple(params[k].shape)}, "
                             f"expected {shape} for C {c}, n {n}")
        if params[k].device != x.device:
            raise ValueError("c3_fused: x and params lie on different devices")
    if c % 8 or c_ % 8 or c2 % 8:
        raise ValueError(f"c3_fused needs C, c_, C2 multiples of 8, got "
                         f"{c}, {c_}, {c2}")
    x = x.contiguous()
    p = {k: params[k].to(x.dtype if k.startswith("w") else torch.float32)
         .contiguous() for k in KEYS}
    if x.device.type == "cpu":
        return c3_plain(x, p, n, shortcut)
    if x.device.type != "cuda":
        raise ValueError(f"c3_fused runs on CPU or CUDA, not {x.device}")
    tile = pick_tile(c_, n, x.element_size())
    out = torch.empty((b, h, w, c2), dtype=x.dtype, device=x.device)
    stream, dev = _ext.stream_and_device(x)
    _ext.check(_ext.load().desenet_c3_fused(
        x.data_ptr(), *(p[k].data_ptr() for k in KEYS), b, h, w, c, c_, c2,
        n, int(shortcut), tile, int(x.dtype == torch.bfloat16),
        out.data_ptr(), stream, dev), "c3_fused kernel")
    launches += 1
    return out
