"""The fused C3 block (inference, BN folded): cv12 1x1 -> n x Bottleneck
(1x1, 3x3, optional residual) -> concat -> cv3 1x1, SiLU after each.

Counterpart of the kernel half of ``tools/proto_c3_kernel.py``. On a CUDA
tensor ``c3_fused`` launches one of the two hand-written kernels of
``csrc/c3_fused.cu`` (kernel K6) or raises: the tensor-core one (``"mma"``)
in bfloat16 when C, c_ and C2 are multiples of 16, else the CUDA-core one
(``"fma"``: float32, where it keeps 1e-6 parity, and other channel counts);
``last_variant`` says which the last call launched. The output tile is
chosen here (``pick_tile``), so the CPU tests reach the choice. On a CPU
tensor it runs ``c3_plain``, which mirrors
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

import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext

launches = 0  # kernel launches made by c3_fused
last_variant = None  # "mma" or "fma": the kernel the last launch took
KEYS = ("w12", "b12", "wb1", "bb1", "wb2", "bb2", "w3", "b3")
SMEM_BUDGET = 110 * 1024  # the CUDA-core kernel's two frame buffers (2 blocks/SM)
SMEM_BLOCK = 232448  # shared memory one block can use on the H100 (227 KB)
MMA_PAD = 8  # elements of padding per frame row (mma_bf16.cuh, kPad)
# the tensor-core kernel's double-buffered ring: weights 2 x 32 x (256 + 8)
# and a pass's pixels of x 2 x 256 x (32 + 8), bf16 (c3_fused.cu, kRingBytes)
MMA_RING_BYTES = 2 * (32 * (256 + MMA_PAD) + 256 * (32 + MMA_PAD)) * 2
MAX_TILE = 64  # largest tile side pick_tile offers
RAGGED_GAIN = 1.25  # see pick_tile


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


def pick_variant(dtype: torch.dtype, c: int, c_: int, c2: int) -> str:
    """The kernel ``c3_fused`` launches on a CUDA tensor: ``"mma"`` (tensor
    cores) in bfloat16 with all three channel counts multiples of 16, else
    ``"fma"`` (CUDA cores)."""
    if dtype == torch.bfloat16 and not (c % 16 or c_ % 16 or c2 % 16):
        return "mma"
    return "fma"


def pick_square_tile(c_: int, n: int, itemsize: int) -> int:
    """The CUDA-core kernel's output tile side: the largest of 16, 8, 4, 2, 1
    whose two frame buffers of (tile + 2n)^2 x c_ values fit
    ``SMEM_BUDGET``."""
    for t in (16, 8, 4, 2, 1):
        if 2 * (t + 2 * n) ** 2 * c_ * itemsize <= SMEM_BUDGET:
            return t
    raise ValueError(f"c3_fused: c_ {c_} with {n} bottlenecks does not fit "
                     f"the kernel's shared memory")


def mma_smem_bytes(th: int, tw: int, c_: int, n: int) -> int:
    """Dynamic shared memory of the tensor-core kernel at tile th x tw: the
    two padded frame buffers and the ring."""
    return (4 * (th + 2 * n) * (tw + 2 * n) * (c_ + MMA_PAD)
            + MMA_RING_BYTES)


def c3_macs(h: int, w: int, c: int, c_: int, c2: int, n: int, th: int,
            tw: int) -> int:
    """Multiply-adds one image costs at tile th x tw, the recomputed halo
    included: every block computes y1 on its whole frame, each bottleneck
    on the frame less its depth, y2 and the output on the tile."""
    rh, rw = th + 2 * n, tw + 2 * n
    block = rh * rw * c * c_
    for i in range(n):
        block += (rh - 2 * i) * (rw - 2 * i) * c_ * c_
        block += (rh - 2 * i - 2) * (rw - 2 * i - 2) * 9 * c_ * c_
    block += th * tw * (c * c_ + 2 * c_ * c2)
    return -(-h // th) * -(-w // tw) * block


# What a block of the tensor-core kernel costs, in clock cycles of its SM,
# fitted to the phase counters of tools/profile_c3_phases.py at the eight
# served rows (NVIDIA H100 80GB HBM3, 700 W): the products of a pass of K
# values on 64 channels, a byte staged into the ring, a pass's set-up, an
# epilogue value.
CYCLES_PER_K_CHANNEL = 0.37
RING_BYTES_PER_CYCLE = 30.0
CYCLES_PER_PASS = 1800
CYCLES_PER_VALUE = 0.29


def mma_block_cycles(th: int, tw: int, c: int, c_: int, c2: int,
                     n: int) -> float:
    """The cycles one block of the tensor-core kernel takes at tile th x tw,
    by the fitted model above. The kernel's eight warp pairs take a stage's
    (32-pixel, 64-channel) items eight at a time, pixel tiles fastest,
    channel blocks of 256 apart; a pass of K values costs its products
    whatever share of the pairs is busy, the weights of the channel tiles
    it touches (and, for the two halves of cv12, its 256 pixels of x)
    through the ring, and its set-up; every value of a stage costs its
    epilogue."""
    def stage(m, k, width, from_x):
        n_mt = -(-m // 32)
        cycles = CYCLES_PER_VALUE * m * width
        for nb in range(0, width, 256):
            nbw = min(256, width - nb)
            items = n_mt * -(-nbw // 64)
            for it0 in range(0, items, 8):
                last = min(items, it0 + 8) - 1
                ncols = min(nbw, (last // n_mt + 1) * 64) - it0 // n_mt * 64
                staged = 2 * k * (ncols + (256 if from_x else 0))
                cycles += (CYCLES_PER_K_CHANNEL * k * min(nbw, 64)
                           + staged / RING_BYTES_PER_CYCLE + CYCLES_PER_PASS)
        return cycles

    rh, rw = th + 2 * n, tw + 2 * n
    cycles = stage(rh * rw, c, c_, True)
    for i in range(n):
        cycles += stage((rh - 2 * i) * (rw - 2 * i), c_, c_, False)
        cycles += stage((rh - 2 * i - 2) * (rw - 2 * i - 2), 9 * c_, c_,
                        False)
    return (cycles + stage(th * tw, c, c_, True)
            + stage(th * tw, 2 * c_, c2, False))


@functools.lru_cache(maxsize=256)
def pick_tile(h: int, w: int, c: int, c_: int, c2: int,
              n: int) -> Tuple[int, int]:
    """The tensor-core kernel's output tile (th, tw) on an h x w map: of the
    tiles up to ``MAX_TILE`` a side whose frame buffers and ring fit one
    block's shared memory, the one whose blocks cost the least together
    (``mma_block_cycles``: the recomputed halo, the idle warps of a ragged
    pass and the weights a pass stages counted); ties go to fewer
    multiply-adds, then fewer blocks. A tile
    that divides the map is preferred (no block hangs over the border)
    unless the best such tile costs over ``RAGGED_GAIN`` times the best
    ragged one, as on a map of prime sides."""
    best = {}
    for th in range(1, min(h, MAX_TILE) + 1):
        for tw in range(1, min(w, MAX_TILE) + 1):
            if mma_smem_bytes(th, tw, c_, n) > SMEM_BLOCK:
                break
            blocks = -(-h // th) * -(-w // tw)
            key = (blocks * mma_block_cycles(th, tw, c, c_, c2, n),
                   c3_macs(h, w, c, c_, c2, n, th, tw), blocks)
            for kind in ("any", "dividing")[:1 + (h % th == 0 == w % tw)]:
                if kind not in best or key < best[kind][0]:
                    best[kind] = (key, (th, tw))
    if not best:
        raise ValueError(f"c3_fused: c_ {c_} with {n} bottlenecks does not "
                         f"fit the kernel's shared memory")
    if best["dividing"][0][0] <= RAGGED_GAIN * best["any"][0][0]:
        return best["dividing"][1]
    return best["any"][1]


def c3_fused(x: torch.Tensor, params: Mapping[str, torch.Tensor], n: int,
             shortcut: bool = True) -> torch.Tensor:
    """The C3 block of ``params`` on NHWC ``x`` (B, H, W, C), float32 or
    bfloat16 -> (B, H, W, C2) in x.dtype. C, c_ and C2 are multiples of 8
    (of 16 for the tensor-core kernel, see ``pick_variant``).
    The JAX function's ``interpret`` is a TPU interpreter knob and has no
    counterpart."""
    global launches, last_variant
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
    variant = pick_variant(x.dtype, c, c_, c2)
    if variant == "mma":
        th, tw = pick_tile(h, w, c, c_, c2, n)
    else:
        th = tw = pick_square_tile(c_, n, x.element_size())
    out = torch.empty((b, h, w, c2), dtype=x.dtype, device=x.device)
    stream, dev = _ext.stream_and_device(x)
    _ext.check(_ext.load().desenet_c3_fused(
        x.data_ptr(), *(p[k].data_ptr() for k in KEYS), b, h, w, c, c_, c2,
        n, int(shortcut), th, tw, int(variant == "mma"),
        int(x.dtype == torch.bfloat16), out.data_ptr(), stream, dev),
        f"c3_fused kernel ({variant})")
    launches += 1
    last_variant = variant
    return out
