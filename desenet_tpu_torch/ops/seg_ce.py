"""Fused tiled upsample + cross-entropy for segmentation training.

Counterpart of ``desenet_tpu/ops/seg_ce.py``. The training objective is
pixel CE against the seg head's 8x bilinear (align_corners=True) upsample
of its 1/8-resolution logits. Computed literally it holds a (B, C, H, W)
logits map and its gradient; :func:`upsampled_ce` computes the same loss
and gradient one block of output rows at a time: the forward upsamples a
block by the separable interpolation matrices (``ops/resize.py:
_linear_matrix``, the H contraction with the block's rows of the H matrix,
then the W one) and sums its masked CE; the backward runs the blocks again
and accumulates the transposed-matrix gradient into an f32 ``dz``. Live
memory is one (B, C, TB, W) block.

Dtype rules are the JAX package's: f32 logits contract in f32, bf16 ones
in bf16 (f32 accumulation inside each product); the CE is f32; the CE's
gradient is cast to the logits' dtype before the transposed contractions.
With several processes the denominator (valid pixels, or their class
weights) is summed over the processes, as the seg CE's is. Plain PyTorch:
no TPU kernel stands behind it.
"""

from __future__ import annotations

import functools

import torch

from desenet_tpu_torch.ops.resize import _linear_matrix
from desenet_tpu_torch.parallel.multihost import global_sum

__all__ = ["upsampled_ce"]


def _row_blocks(h_out: int, target: int = 64) -> int:
    """Number of uniform output-row blocks (a divisor of h_out, block size
    as close to ``target`` rows as possible from below)."""
    nblk = max(1, h_out // target)
    while h_out % nblk:
        nblk += 1
    return nblk


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The contractions' dtype: bf16 for bf16 logits, else f32."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


@functools.lru_cache(maxsize=32)
def _matrix(n_in: int, n_out: int, align_corners: bool, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The (n_out, n_in) interpolation matrix on ``device``, made once."""
    return torch.from_numpy(_linear_matrix(n_in, n_out, align_corners)).to(
        device, dtype)


def _prep(z, labels, out_hw, align_corners, row_target):
    """Per-block H-matrix rows, the transposed W matrix and the labels'
    row blocks."""
    h_in, w_in = z.shape[2:]
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    nblk = _row_blocks(h_out, row_target)
    cdt = _compute_dtype(z.dtype)
    mh = _matrix(h_in, h_out, align_corners, z.device, cdt)
    mw_t = _matrix(w_in, w_out, align_corners, z.device, cdt).t()
    return mh.chunk(nblk), mw_t, labels.chunk(nblk, 1), cdt


def _upsample_block(z, mh_blk, mw_t, cdt):
    """One output-row block of the bilinear upsample: (B, C, TB, W)."""
    return torch.matmul(torch.matmul(mh_blk, z.to(cdt)), mw_t).to(z.dtype)


def _onehot(safe: torch.Tensor, c: int) -> torch.Tensor:
    return safe[:, None] == torch.arange(
        c, dtype=safe.dtype, device=safe.device)[:, None, None]


def _pixel_weight(valid, onehot, cw):
    """Per-pixel weight: 1 or the class weight where valid, else 0 (f32)."""
    if cw is None:
        return valid.float()
    return torch.where(valid, torch.where(onehot, cw, 0.0).sum(1), 0.0)


class _UpsampledCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, labels, out_hw, align_corners, ignore_index,
                class_weight, row_target):
        mh_blocks, mw_t, lab_blocks, cdt = _prep(z, labels, out_hw,
                                                 align_corners, row_target)
        cw = (None if class_weight is None else torch.as_tensor(
            class_weight, dtype=torch.float32, device=z.device)[:, None, None])
        c = z.shape[1]
        nll_sum = torch.zeros((), device=z.device)
        den = torch.zeros((), device=z.device)
        for mh_blk, lab in zip(mh_blocks, lab_blocks):
            lf = _upsample_block(z, mh_blk, mw_t, cdt).float()
            valid = lab != ignore_index
            onehot = _onehot(torch.where(valid, lab, 0), c)
            nll = -torch.where(onehot, torch.log_softmax(lf, 1), 0.0).sum(1)
            w = _pixel_weight(valid, onehot, cw)
            nll_sum = nll_sum + (nll * w).sum()
            den = den + w.sum()
        den = global_sum(den).clamp(min=1.0)
        ctx.save_for_backward(z, labels, den)
        ctx.cfg = (out_hw, align_corners, ignore_index, cw, row_target)
        return nll_sum / den

    @staticmethod
    def backward(ctx, g):
        z, labels, den = ctx.saved_tensors
        out_hw, align_corners, ignore_index, cw, row_target = ctx.cfg
        mh_blocks, mw_t, lab_blocks, cdt = _prep(z, labels, out_hw,
                                                 align_corners, row_target)
        c = z.shape[1]
        scale = g / den  # d loss / d nll_sum
        dz = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
        for mh_blk, lab in zip(mh_blocks, lab_blocks):
            lf = _upsample_block(z, mh_blk, mw_t, cdt).float()
            valid = lab != ignore_index
            onehot = _onehot(torch.where(valid, lab, 0), c)
            w = _pixel_weight(valid, onehot, cw)
            g_up = (torch.softmax(lf, 1) - onehot.float()) * (w * scale)[:, None]
            # the cotangent takes the logits' dtype before the transposed
            # contractions, as the unfused path's cast boundary does
            g_up = g_up.to(z.dtype).to(cdt)
            dz += torch.matmul(mh_blk.t(), torch.matmul(g_up, mw_t.t())).float()
        return dz.to(z.dtype), None, None, None, None, None, None


def upsampled_ce(z: torch.Tensor, labels: torch.Tensor, out_hw,
                 align_corners: bool = True, ignore_index: int = -1,
                 class_weight=None, row_target: int = 64) -> torch.Tensor:
    """Mean pixel CE of bilinear-upsampled logits, tiled over output rows.

    Equals ``segmentation_loss(resize_bilinear(z, out_hw, align_corners),
    labels, ...)`` without the full-resolution map. ``z`` (B, C, h, w)
    low-resolution logits; ``labels`` (B, H_out, W_out) int class ids;
    ``class_weight`` an optional (C,) vector (no gradient flows to it)."""
    return _UpsampledCE.apply(z, labels, (int(out_hw[0]), int(out_hw[1])),
                              align_corners, ignore_index, class_weight,
                              row_target)
