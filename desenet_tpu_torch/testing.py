"""Seeded synthetic inputs for holding the port's kernels against their
plain PyTorch versions. ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` both draw from here, so the checks on
the card and the card tests see the same data at the same shapes.

Everything is made on the CPU; callers move it to the device.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_decode(rng, b: int, a: int, nc: int, frac: float) -> np.ndarray:
    """(B, A, 5+nc) f32 decode in pixel xywh + obj + cls; about ``frac`` of
    the anchors carry obj in [0.3, 1], the rest obj < 0.05."""
    cxy = rng.uniform(50, 600, (b, a, 2))
    wh = rng.uniform(10, 120, (b, a, 2))
    obj = rng.uniform(0, 0.05, (b, a, 1))
    live = rng.uniform(0, 1, (b, a, 1)) < frac
    obj[live] = rng.uniform(0.3, 1.0, int(live.sum()))
    cls = rng.uniform(0, 1, (b, a, nc))
    return np.concatenate([cxy, wh, obj, cls], -1).astype(np.float32)


def greedy_candidates(rng, b: int, k: int):
    """A (B, K) candidate set as kernel K3 gets it: (B, K, 4) xyxy boxes and
    (B, K) scores in (0, 1), about 30% invalid at -1, as f32 tensors."""
    centers = rng.uniform(50, 2000, (b, k, 2))
    wh = rng.uniform(20, 300, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = np.where(rng.uniform(0, 1, (b, k)) < 0.3, -1.0,
                      rng.uniform(0, 1, (b, k)))
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)))


def random_psp2_head(chans, c_hid: int, n_segcls: int = 3, seed: int = 0):
    """A SegMaskPSP2 module (1/8-resolution output) in eval mode on inputs
    of ``chans`` channels, with seeded random weights and BN statistics."""
    from desenet_tpu_torch.models.heads import SegMaskPSP2

    head = SegMaskPSP2(list(chans), n_segcls=n_segcls, c_hid=c_hid,
                       upsample=False).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in head.state_dict().items():
            if t.dtype != torch.float32:
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif t.dim() == 4:
                bound = t[0].numel() ** -0.5
                t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.5)
    return head


def check_psp2(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """Hold K4's logits ``got`` against its plain version's ``want``
    (both f32, same inputs). The kernel sums its products in another order
    than the plain matmuls. In f32 (TF32 off): rtol/atol 1e-4. In bf16, where
    both round to bf16 at the same points and an order difference can flip
    one rounding: max abs error at most 1e-2 of the largest plain logit
    (one to three bf16 ulps of it), and class decisions equal on at least
    99% of positions. Raises AssertionError; returns (max abs err, argmax
    agreement)."""
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        bound = 1e-2 * float(want.abs().max())
        if not err <= bound or agree < 0.99:
            raise AssertionError(
                f"K4 {dtype}: max abs err {err} (bound {bound}), argmax "
                f"agreement {agree} (bound 0.99)")
    return err, agree


def psp2_inputs(b: int, h8: int, w8: int, chans, seed: int = 0):
    """[l16, l19, l22]: NHWC f32 feature maps at 1/8, 1/16 and 1/32
    resolution (``h8`` x ``w8`` at 1/8) with ``chans`` channels."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h8 // s, w8 // s, c), generator=g)
            for s, c in zip((1, 2, 4), chans)]
