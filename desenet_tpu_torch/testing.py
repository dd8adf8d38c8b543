"""Seeded synthetic inputs for holding the port's kernels against their
plain PyTorch versions, and the bars they are held to. ``chip_smoke.py``,
the probes in ``desenet_tpu_torch/tools`` and
``tests/test_torch_kernels_cuda.py`` draw from here, so the checks on the
card and the card tests see the same data at the same shapes.

Everything is made on the CPU; callers move it to the device.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """Full f32 matmuls and convolutions inside the block (cuDNN takes f32
    convolutions in TF32 by default)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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


def dense_decode(rng, b: int, a: int, nc: int, live: int, objects: int):
    """(B, A, 5+nc) f32 decode as a trained model gives kernel K1: ``live``
    anchors, scattered over the anchor axis, pass conf 0.25 (obj and one
    class in [0.6, 1], so conf is at least 0.36) and crowd around ``objects``
    well-separated objects of one class each (100-pixel boxes on a 250-pixel
    grid, jittered by up to 3 pixels: two of one object overlap with IoU
    above 0.75); every other anchor has obj < 0.05. NMS at IoU 0.45 keeps
    one box an object and walks the whole candidate set."""
    side = int(np.ceil(np.sqrt(objects)))
    which = rng.integers(0, objects, (b, a))
    cx = 100.0 + 250.0 * (which % side) + rng.uniform(-3, 3, (b, a))
    cy = 100.0 + 250.0 * (which // side) + rng.uniform(-3, 3, (b, a))
    wh = 100.0 + rng.uniform(-2, 2, (b, a, 1)).repeat(2, -1)
    is_live = np.zeros((b, a), bool)
    for i in range(b):
        is_live[i, rng.choice(a, live, replace=False)] = True
    obj = np.where(is_live, rng.uniform(0.6, 1.0, (b, a)),
                   rng.uniform(0, 0.05, (b, a)))
    cls = rng.uniform(0, 0.3, (b, a, nc))
    np.put_along_axis(cls, (which % nc)[..., None],
                      rng.uniform(0.6, 1.0, (b, a, 1)), -1)
    return np.concatenate([np.stack([cx, cy], -1), wh, obj[..., None], cls],
                          -1).astype(np.float32)


def select_planes(rng, b: int, a: int, live: int, levels: int = 0,
                  dup: float = 0.0, spread: float = 2000.0, nc: int = 6):
    """Kernel K1's six (B, A) f32 planes (x1, y1, x2, y2 class-offset by
    4096 a class, score, cls) with exactly ``live`` candidates an image at
    scattered anchors (scores in (0, 1)), the rest at -1. With ``levels`` >
    0 the scores take that many distinct values, so many tie; a fraction
    ``dup`` of the boxes (and their classes) are exact copies of other
    anchors'; box centres are uniform over ``spread`` pixels."""
    centers = rng.uniform(50, 50 + spread, (b, a, 2))
    wh = rng.uniform(20, 300, (b, a, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    cls = rng.integers(0, nc, (b, a)).astype(np.float64)
    if dup > 0:
        src = rng.integers(0, a, (b, a))
        copy = rng.uniform(0, 1, (b, a)) < dup
        boxes = np.where(copy[..., None],
                         np.take_along_axis(boxes, src[..., None], 1), boxes)
        cls = np.where(copy, np.take_along_axis(cls, src, 1), cls)
    sc = rng.uniform(0.01, 1, (b, a))
    if levels > 0:
        sc = np.ceil(sc * levels) / levels
    is_live = np.zeros((b, a), bool)
    for i in range(b):
        is_live[i, rng.choice(a, live, replace=False)] = True
    sc = np.where(is_live, sc, -1.0)
    boxes = boxes + cls[..., None] * 4096.0
    return tuple(torch.from_numpy(np.ascontiguousarray(v, np.float32))
                 for v in (*np.moveaxis(boxes, -1, 0), sc, cls))


# Kernel K1's cases: (name, generator, its arguments, max_det, the path every
# image takes: 0 the ordered walk, 1 the argmax loop). "planes" draws
# ``select_planes`` (A 25200 unless given), the others a decode that goes
# through ``nms_planes`` at conf 0.25. The counts sit on and beside the caps
# of csrc/nms_fused.cu: 4096 candidates on the ordered path (sorted over the
# next power of two), max_det 2048 in the walk's kept list.
NMS_FUSED_CASES = (
    ("sparse decode", "synthetic", dict(b=8, frac=0.01), 300, 0),
    ("decode above the candidate cap", "synthetic", dict(b=4, frac=0.8), 300,
     1),
    ("dense decode", "dense", dict(b=4, live=3000, objects=100), 300, 0),
    ("all dead", "planes", dict(live=0), 300, 0),
    ("one candidate", "planes", dict(live=1), 300, 0),
    ("fewer live than max_det", "planes", dict(live=100), 300, 0),
    ("more kept than max_det", "planes", dict(live=2000), 100, 0),
    ("many tied scores", "planes", dict(live=1000, levels=5, spread=800.0),
     300, 0),
    ("many tied scores, many candidates", "planes",
     dict(live=3500, levels=7, spread=800.0), 600, 0),
    ("exact duplicate boxes", "planes", dict(live=1500, dup=0.5), 600, 0),
    ("crowded", "planes", dict(live=3000, spread=500.0), 300, 0),
    ("a power of two", "planes", dict(live=1024), 300, 0),
    ("one over a power of two", "planes", dict(live=1025), 300, 0),
    ("at the candidate cap", "planes", dict(live=4096), 300, 0),
    ("one over the candidate cap", "planes", dict(live=4097), 300, 1),
    ("max_det at the walk's cap", "planes", dict(live=500), 2048, 0),
    ("max_det above the walk's cap", "planes", dict(live=500), 2049, 1),
    ("few anchors", "planes", dict(a=512, live=300, spread=500.0), 64, 0),
    ("few anchors, above the candidate cap", "planes",
     dict(a=5000, live=4500, spread=500.0), 64, 1),
    # the TTA decode at 640 (25200 + 18207 + 12348 anchors) and a
    # two-member ensemble's (2 x 25200), at the detect CLI's max_det 1000,
    # with its class filter and agnostic NMS
    ("TTA decode", "synthetic", dict(b=4, a=55755, frac=0.01), 1000, 0),
    ("TTA decode, class filter, agnostic", "synthetic",
     dict(b=4, a=55755, frac=0.02, classes=(0, 2, 4), agnostic=True), 1000,
     0),
    ("TTA dense decode", "dense", dict(b=4, a=55755, live=9000, objects=100),
     1000, 1),
    ("ensemble decode", "synthetic", dict(b=4, a=50400, frac=0.01), 1000, 0),
    ("ensemble dense decode, class filter", "dense",
     dict(b=4, a=50400, live=6000, objects=100, classes=(1, 3, 5)), 1000, 0),
)


def nms_fused_case(case, seed: int = 0):
    """The six (B, A) planes of one of ``NMS_FUSED_CASES``, on the CPU."""
    from desenet_tpu_torch.ops.nms_fused import nms_planes

    _, gen, kw, _, _ = case
    kw = dict(kw)
    rng = np.random.default_rng(seed)
    a = kw.pop("a", 25200)
    if gen == "planes":
        return select_planes(rng, kw.pop("b", 2), a, **kw)
    if gen == "dense":
        pred = dense_decode(rng, kw["b"], a, 6, kw["live"], kw["objects"])
    else:
        pred = synthetic_decode(rng, kw["b"], a, 6, kw["frac"])
    return nms_planes(torch.from_numpy(pred), 0.25,
                      agnostic=kw.get("agnostic", False),
                      classes=kw.get("classes"))


# Kernel K2's cases: (B, h, w, C, dtype, scale, align_corners, the kernel the
# wrapper picks). The span kernel takes an output width that is a multiple
# of 16 and runs of at most 9 pixels a source column, a one-tap pixel only
# as the first of its run; the pixel kernel the rest.
SEG_TAIL_CASES = (
    (8, 80, 80, 3, torch.float32, 8, True, "span"),
    (8, 80, 80, 3, torch.bfloat16, 8, True, "span"),
    (4, 80, 80, 19, torch.float32, 8, True, "span"),
    (1, 80, 80, 3, torch.bfloat16, 8, True, "span"),     # B = 1
    (2, 80, 80, 3, torch.bfloat16, 4, True, "span"),     # another scale
    (2, 50, 72, 256, torch.float32, 2, True, "span"),    # H cuts the last tile
    (2, 20, 24, 3, torch.float32, 2, False, "span"),     # half-pixel centres
    (2, 80, 80, 3, torch.float32, 8, False, "pixel"),    # a run of 12
    (2, 40, 60, 5, torch.bfloat16, 12, True, "pixel"),   # runs of 13
    (2, 83, 81, 3, torch.float32, 8, True, "pixel"),     # W = 648
    (2, 80, 80, 3, torch.float32, 16, True, "pixel"),    # runs of 17
    (2, 20, 20, 3, torch.bfloat16, 16, False, "pixel"),
)


def seg_tail_input(case, seed: int = 0) -> torch.Tensor:
    """The (B, h, w, C) logits of one of ``SEG_TAIL_CASES``, on the CPU."""
    b, h, w, c, dtype = case[:5]
    x = np.random.default_rng(seed).normal(0, 1, (b, h, w, c))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def seg_tail_infinite_input(seed: int = 0) -> torch.Tensor:
    """(2, 80, 80, 3) f32 logits with infinite values in the columns beside
    the one-tap pixels of the 8x align_corners taps (output columns 0 and
    639 sit on sources 0 and 79) and in a row beside such a row: a kernel
    that multiplied them by a weight of 0 would give NaN where the plain
    version gives a number. The one-tap rows' and columns' own sources
    stay finite, so the plain version meets no NaN."""
    x = seg_tail_input((2, 80, 80, 3, torch.float32), seed)
    x[:, 1:79, 1, 2] = float("inf")
    x[:, 1:79, 78, 1] = float("-inf")
    x[:, 1, 5:70, 0] = float("inf")
    return x


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


def sorted_candidates(rng, b: int, k: int, live: int, levels: int = 0,
                      dup: float = 0.0, spread: float = 2000.0):
    """A (B, K) candidate set in the order the validation path's top-k
    gives K3: ``live`` scores in (0, 1) in descending order, then -1. With
    ``levels`` > 0 the scores take that many distinct values, so most
    neighbours tie; a fraction ``dup`` of the boxes are exact copies of
    other boxes; box centres are uniform over ``spread`` pixels (a smaller
    spread makes a denser set)."""
    centers = rng.uniform(50, 50 + spread, (b, k, 2))
    wh = rng.uniform(20, 300, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    if dup > 0:
        src = rng.integers(0, k, (b, k))
        copy = rng.uniform(0, 1, (b, k)) < dup
        boxes = np.where(copy[..., None],
                         np.take_along_axis(boxes, src[..., None], 1), boxes)
    sc = rng.uniform(0.01, 1, (b, k))
    if levels > 0:
        sc = np.ceil(sc * levels) / levels
    sc = -np.sort(-sc, axis=1)
    sc[:, live:] = -1.0
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(sc.astype(np.float32)))


def dense_sorted_candidates(rng, b: int, k: int, live: int, clusters: int):
    """A dense ordered (B, K) set, as a trained model's decode gives K3:
    ``live`` candidates in descending score order that crowd around
    ``clusters`` well-separated objects (100-pixel boxes on a 250-pixel
    grid, jittered by up to 3 pixels, so two of one cluster overlap with IoU
    above 0.75), then -1. NMS at IoU 0.6 keeps one box a cluster and walks
    the whole live prefix."""
    side = int(np.ceil(np.sqrt(clusters)))
    which = rng.integers(0, clusters, (b, k))
    cx = 100.0 + 250.0 * (which % side) + rng.uniform(-3, 3, (b, k))
    cy = 100.0 + 250.0 * (which // side) + rng.uniform(-3, 3, (b, k))
    half = 50.0 + rng.uniform(-1, 1, (b, k))
    boxes = np.stack([cx - half, cy - half, cx + half, cy + half], -1)
    sc = -np.sort(-rng.uniform(0.01, 1, (b, k)), axis=1)
    sc[:, live:] = -1.0
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(sc.astype(np.float32)))


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


# bf16 bars of kernels K5 and K6, as fractions of the largest |want|.
# Against the plain version, which rounds to bf16 at the kernel's own points
# and differs only in the order of its f32 sums, an element may land an ulp
# away, and an ulp's step in an intermediate moves the output by about as
# much (at most 0.4% of the largest value in the CPU tests): 2^-6, at least
# two bf16 ulps of the largest value (bf16 keeps 8 significant bits).
# Against the cuDNN modules, which also round after every conv, BN and SiLU
# and keep their BN apart from the bf16 weights (up to 1.23% in the CPU
# tests): 2^-5.
BF16_BAR = 2.0 ** -6
BF16_MODULE_BAR = 2.0 ** -5


def check_bf16(got: torch.Tensor, want: torch.Tensor, what: str,
               bar: float = BF16_BAR) -> float:
    """Hold a bf16 output to ``bar`` (a fraction of the largest |want|)
    after checking its shape and that it is finite. Raises AssertionError;
    returns the max abs err."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - want).abs().max())
    bound = bar * float(want.abs().max())
    if not err <= bound:
        raise AssertionError(f"{what}: max abs err {err} above the bf16 bar "
                             f"{bound} ({bar:g} of |want| max)")
    return err


def check_close(got: torch.Tensor, want: torch.Tensor, what: str,
                f32_tol: float, bar: float = BF16_BAR) -> float:
    """Hold a K5/K6 output to its bar by its dtype: float32 at rtol/atol
    ``f32_tol``, bfloat16 by ``check_bf16`` at ``bar``. Raises
    AssertionError; returns the max abs err."""
    if got.dtype == torch.bfloat16:
        return check_bf16(got, want, what, bar)
    torch.testing.assert_close(got, want.to(got.dtype), rtol=f32_tol,
                               atol=f32_tol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at |t| (8 bits of mantissa), f32."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_epilogue(got: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, act: bool,
                   residual: Optional[torch.Tensor], what: str) -> float:
    """The fused conv epilogue's output ``got`` (``ops/conv_epilogue.py``)
    against its plain version on the input ``y``: bf16 to 1 ulp of the
    largest term of its sums (the two differ only in f32 rounding before
    the one bf16 rounding: a fused multiply-add, ``__expf``), f32 to 1e-5
    of it. Raises AssertionError; returns the max abs err."""
    from desenet_tpu_torch.ops.conv_epilogue import conv_epilogue_plain

    want = conv_epilogue_plain(y, scale, shift, act, residual)
    prod = y.float() * scale.view(1, -1, 1, 1)
    v = prod + shift.view(1, -1, 1, 1)
    a = torch.nn.functional.silu(v) if act else v
    big = torch.maximum(a.abs(), want.float().abs())
    big = torch.maximum(big, torch.maximum(
        prod.abs(), shift.abs().view(1, -1, 1, 1).expand_as(prod)))
    if residual is not None:
        big = torch.maximum(big, residual.float().abs())
    err = (got.float() - want.float()).abs()
    if y.dtype == torch.bfloat16:
        bad = err > _bf16_ulp(big)
    else:
        bad = err > 1e-5 * big + 1e-30
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} "
                             f"off, worst {float(err.max())}")
    return float(err.max())


def randomize_bn(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded BN statistics and affine parameters for every BatchNorm2d of
    ``module`` (in place), so that BN folds are exercised."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=g) + 0.5)
    return module


def stem_inputs(b: int, h: int, w: int, co: int, seed: int = 0):
    """K5's inputs: NHWC f32 image in [0, 1) as a tensor, a (6, 6, 3, CO)
    HWIO kernel (normal x 0.3, as tests/test_stem_pallas.py draws it) and a
    (CO,) bias, both numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    w6 = (rng.normal(size=(6, 6, 3, co)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=co) * 0.1).astype(np.float32)
    return torch.from_numpy(x), w6, bias


# yolov5s_seg's eight C3 rows at 640 px (depth 0.33, width 0.5):
# (row, C, C2, c_, n, shortcut, side of the square map)
C3_SERVED = (
    (2, 64, 64, 32, 1, True, 160),
    (4, 128, 128, 64, 3, True, 80),
    (6, 256, 256, 128, 3, True, 40),
    (9, 512, 512, 256, 1, False, 20),
    (13, 512, 256, 128, 1, False, 40),
    (17, 256, 128, 64, 1, False, 80),
    (20, 256, 256, 128, 1, False, 40),
    (23, 512, 512, 256, 1, False, 20),
)


def random_c3_params(rng, c: int, c_: int, c2: int, n: int) -> dict:
    """K6's params in the proto's layout (numpy f32): weights normal over
    sqrt(fan-in), so activations stay of order 1 through the block, biases
    normal x 0.1."""
    def w(fan_in, *shape):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    def b(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return {"w12": w(c, c, 2 * c_), "b12": b(2 * c_),
            "wb1": w(c_, n, c_, c_), "bb1": b(n, c_),
            "wb2": w(9 * c_, n, 9, c_, c_), "bb2": b(n, c_),
            "w3": w(2 * c_, 2 * c_, c2), "b3": b(c2)}


def psp2_inputs(b: int, h8: int, w8: int, chans, seed: int = 0):
    """[l16, l19, l22]: NHWC f32 feature maps at 1/8, 1/16 and 1/32
    resolution (``h8`` x ``w8`` at 1/8) with ``chans`` channels."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h8 // s, w8 // s, c), generator=g)
            for s, c in zip((1, 2, 4), chans)]


# ---- the training step ------------------------------------------------------
#
# Bars of a training step against another run of it (the JAX package's on
# the CPU, or the port's on the CPU against the card): the loss and its
# components relative, each state tensor (parameters, BN statistics,
# optimizer buffers, EMA) against its largest magnitude. In float64 the
# losses and the seg upsample stay float32 on both sides; their roundings
# of the loss gradient differ at 1e-7 and the tiny model's train-mode
# backward (BN over 8 to 32 values a channel) carries that to 3e-6 of the
# worst tensor after a second step and 2e-5 after a third, hence (first
# step, later steps). In float32 the network itself is the limit: the JAX
# package's own f32 step differs from its float64 step by 1e-5 in the loss
# and 9e-4 in the momentum after one step, 7e-2 after three (the port's
# f32 step is nearer JAX's float64 one than that), so f32 is held for one
# step only, at bars above what one f32 step of either package scatters.
TRAIN_LOSS_BAR = {torch.float64: 1e-5, torch.float32: 1e-4}
TRAIN_STATE_BAR = {torch.float64: (1e-5, 1e-4), torch.float32: (5e-3, 5e-3)}
TRAIN_PARITY_STEPS = {torch.float64: 2, torch.float32: 1}


def tiny_cfg() -> dict:
    """The tests' tiny_psp2 graph: yolov5s_seg rows at width 0.125 with
    3 detection and 2 seg classes (JSON, since PyYAML may be absent)."""
    import json

    from desenet_tpu_torch.models import config_path

    with open(config_path("yolov5s_seg")) as fh:
        cfg = json.load(fh)
    cfg.update(width_multiple=0.125, de_nc=3, se_nc=2)
    return cfg


# the seg-head rows of tests/configs/tiny_{psp,lab,base}.yaml, and BiSe's,
# which the reference cannot name in a config
def calibrated_tiny(seed: int = 0, **build_kw):
    """The tiny graph in eval mode with seeded weights, its BN statistics
    taken from one batch of noise images and its Detect convs scaled by
    0.2: spread, unsaturated scores that rarely tie (a random net with
    identity BNs gives spatially constant features and tied scores).
    ``build_kw`` goes to ``build_model``."""
    from desenet_tpu_torch.models import build_model, init_weights

    model, spec = build_model(tiny_cfg(), **build_kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # cumulative average: one batch sets the stats
    x = torch.rand((4, 3, 64, 64),
                   generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        model.train()(x)
        for conv in model.model[spec.det_layer].m:
            conv.weight.mul_(0.2)
    return model.eval()


TINY_HEAD_ROWS = {
    "SegMaskPSP": [[16, 19, 22], 1, "SegMaskPSP", ["se_nc", 3, 256, False]],
    "SegMaskLab": [[4, 19], 1, "SegMaskLab", ["se_nc", 1, 256, False]],
    "SegMaskBase": [[16], 1, "SegMaskBase", ["se_nc", 1, 256, False]],
    "SegMaskBiSe": [[16, 19, 22], 1, "SegMaskBiSe", ["se_nc", 1, 256]],
}


def tiny_head_cfg(head: str) -> dict:
    """``tiny_cfg`` with the seg head ``head`` (a key of TINY_HEAD_ROWS)."""
    cfg = tiny_cfg()
    cfg["head"][-2] = TINY_HEAD_ROWS[head]
    return cfg


# a copy of tests/test_exotic_blocks.py's EXOTIC_CFG, which routes through
# every DSL row no bundled config uses (that test module imports JAX);
# tests/test_torch_model_family.py holds the two equal
EXOTIC_CFG = {
    "de_nc": 2,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [
        [-1, 1, "Focus", [16, 3]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "BottleneckCSP", [32]],
        [-1, 1, "GhostConv", [32, 1, 1]],
        [-1, 1, "GhostBottleneck", [32, 3, 2]],
        [-1, 2, "C3Ghost", [32]],
        [-1, 1, "CrossConv", [32, 3, 1]],
        [-1, 1, "MixConv2d", [32]],
        [-1, 1, "DWConv", [48, 3, 1]],
        [-1, 1, "SPPF", [32, 5]],
        [-1, 1, "C3TR", [32]],
        [-1, 1, "C3SPP", [32]],
        [-1, 1, "Contract", [2]],
        [-1, 1, "Bottleneck", [128]],
        [-1, 1, "Expand", [2]],
        [-1, 1, "nn.BatchNorm2d", []],
    ],
    "head": [
        [[-1], 1, "Detect", ["de_nc", "anchors"]],
    ],
}


# grouped DSL Conv rows (g 2, 4 and depthwise; k 1 and 3; stride 1 and 2),
# which the int8 program runs as grouped int8 convs (ops/int8_conv.py);
# the last Conv row feeds Detect and stays fp
GROUPED_CFG = {
    "de_nc": 2,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [
        [-1, 1, "Focus", [16, 3]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [32, 3, 1, None, 2]],
        [-1, 1, "Conv", [64, 3, 2, None, 4]],
        [-1, 1, "Conv", [64, 1, 1, None, 4]],
        [-1, 1, "Conv", [64, 3, 1, None, 64]],
        [-1, 1, "C3", [64]],
        [-1, 1, "Conv", [64, 3, 2, None, 64]],
        [-1, 1, "Conv", [64, 1, 1]],
    ],
    "head": [
        [[-1], 1, "Detect", ["de_nc", "anchors"]],
    ],
}


def train_batch(rng, b: int, imgsz: int, nc: int, max_targets: int = 32
                ) -> dict:
    """A training batch (tests/test_train_step.py's kind, at any size):
    uint8 noise images, 1 to ``max_targets`` boxes an image, each painted
    one colour, and uint8 seg labels with class 1 under every box."""
    img = rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8)
    seg = np.zeros((b, imgsz, imgsz), np.uint8)
    tg = np.zeros((b, max_targets, 5), np.float32)
    n = rng.integers(1, max_targets + 1, b)
    mask = np.arange(max_targets)[None] < n[:, None]
    tg[..., 0] = rng.integers(0, nc, (b, max_targets))
    tg[..., 1:3] = rng.uniform(0.15, 0.85, (b, max_targets, 2))
    tg[..., 3:5] = rng.uniform(0.03, 0.3, (b, max_targets, 2))
    tg[~mask] = 0
    for i in range(b):
        for j in range(n[i]):
            _, cx, cy, w, h = tg[i, j]
            y0, y1 = int((cy - h / 2) * imgsz), int((cy + h / 2) * imgsz)
            x0, x1 = int((cx - w / 2) * imgsz), int((cx + w / 2) * imgsz)
            seg[i, y0:y1, x0:x1] = 1
            img[i, y0:y1, x0:x1] = (200, 30, 30)
    return {"image": img, "det_targets": tg, "det_mask": mask,
            "seg_labels": seg}


def train_steps(device, fused: bool, dtype: torch.dtype, steps: int,
                seed: int = 0, cfg=None, imgsz: int = 64, b: int = 2,
                rows: Optional[slice] = None, spatial: int = 1) -> list:
    """A model (``cfg``, the tiny one by default, at ``imgsz``) takes
    ``steps`` training steps on ``device`` from a seeded state and a seeded
    global batch of ``b`` (SGD, a batch that always steps). ``rows``: this
    process's rows of the global batch in a multi-process run (the step
    takes the global batch's gradient, ``train/step.py``). ``spatial``
    above 1: the process group is a data x spatial mesh
    (``parallel.mesh.make_mesh``), the rows are this process's data row's
    and the step trains on its height band of them. Returns per step
    ``(loss, {group: {key: tensor}})``, the groups ``params``, ``stats``,
    ``mu`` and ``ema`` copied to the CPU in float64 after the step."""
    from desenet_tpu_torch.models import build_model, init_weights
    from desenet_tpu_torch.parallel.mesh import make_mesh
    from desenet_tpu_torch.parallel.multihost import local_batch_slice
    from desenet_tpu_torch.train import create_train_state, make_train_step
    from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
    from desenet_tpu_torch.train.state import bn_stats

    mesh = None
    if spatial > 1:
        mesh = make_mesh(spatial=spatial)
        rows = local_batch_slice(b, mesh.data_index, mesh.n_data)
    dev = torch.device(device)
    model, spec = build_model(cfg or tiny_cfg(), seg_upsample=not fused,
                              train=True)
    batch = train_batch(np.random.default_rng(seed), b, imgsz, spec.de_nc, 8)
    batch = {k: torch.from_numpy(v[rows or slice(None)]).to(dev)
             for k, v in batch.items()}
    init_weights(model, torch.Generator().manual_seed(seed))
    # bf16 computes under autocast on f32 parameters, as the engine's step
    model.to(dev, torch.float32 if dtype == torch.bfloat16 else dtype)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, imgsz, 10)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=4,
                           warmup_iters=2, nominal_bs=b, batch_size=b,
                           fused_seg=fused, dtype=dtype, mesh=mesh)
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        snap = {"params": state.params, "stats": bn_stats(model),
                "mu": state.opt_state["mu"], "ema": state.ema}
        # copies: a CPU float64 tensor's ``.double().cpu()`` is itself,
        # which the next step updates in place
        out.append((float(m["loss"]), {
            g: {k: v.detach().to("cpu", torch.float64, copy=True)
                for k, v in d.items()}
            for g, d in snap.items()}))
    return out


def parity_errors(got: list, want: list) -> list:
    """Per step of two ``train_steps`` runs: the loss's relative error and
    each state group's worst (error, tensor) against its tensor's largest
    magnitude, ``want`` the reference."""
    res = []
    for (loss, g_snap), (ref_loss, w_snap) in zip(got, want):
        errs = {"loss": abs(loss - ref_loss) / abs(ref_loss)}
        for g in w_snap:
            errs[g] = max((float((g_snap[g][k] - w).abs().max())
                           / max(float(w.abs().max()), 1e-30), k)
                          for k, w in w_snap[g].items())
        res.append(errs)
    return res


def train_parity(device, fused: bool, dtype: torch.dtype, seed: int = 0
                 ) -> list:
    """``train_steps`` for ``TRAIN_PARITY_STEPS[dtype]`` steps on ``device``
    and on the CPU; their ``parity_errors``, the CPU run the reference. Run
    f32 on a card under ``no_tf32``."""
    runs = [train_steps(dev, fused, dtype, TRAIN_PARITY_STEPS[dtype], seed)
            for dev in (device, "cpu")]
    return parity_errors(*runs)


def check_train_parity(res: list, dtype: torch.dtype, what: str) -> None:
    """Raise unless ``train_parity``'s errors are within the bars."""
    for i, errs in enumerate(res):
        bar = TRAIN_STATE_BAR[dtype][min(i, 1)]
        bad = {g: e for g, e in errs.items()
               if (e > TRAIN_LOSS_BAR[dtype] if g == "loss" else e[0] > bar)}
        if bad:
            raise AssertionError(f"{what}, step {i}: {bad} over the bars "
                                 f"(loss {TRAIN_LOSS_BAR[dtype]}, state {bar})")


# ---- the int8 slice: weights with O(1) activations -------------------------


def realistic_convbnact_state(rng, c1: int, c2: int, k: int) -> dict:
    """A ConvBnAct's state dict with O(1) activations: a kaiming-normal
    kernel, unit-ish BN statistics (the JAX package's tests/test_quant.py
    fixture, OIHW here)."""
    kern = rng.normal(0, 1.0 / np.sqrt(k * k * c1), (c2, c1, k, k))
    return {
        "conv.weight": torch.tensor(kern, dtype=torch.float32),
        "bn.weight": torch.tensor(rng.uniform(0.5, 1.5, c2), dtype=torch.float32),
        "bn.bias": torch.tensor(rng.normal(0, 0.1, c2), dtype=torch.float32),
        "bn.running_mean": torch.tensor(rng.normal(0, 0.05, c2),
                                        dtype=torch.float32),
        "bn.running_var": torch.tensor(rng.uniform(0.5, 1.5, c2),
                                       dtype=torch.float32),
        "bn.num_batches_tracked": torch.tensor(0),
    }


def boosted_state(model: torch.nn.Module, seed: int = 0) -> dict:
    """The state dict of a DeSeNet of ``model``'s architecture as torch
    builds it with its global generator seeded from ``seed`` (whatever the
    process drew before; ``model`` itself is left as it is), with every conv
    kernel redrawn N(0, 1.3 / sqrt(fan_in)) from numpy (tests/test_quant.py's
    ``_boost_variables``): a seeded init's activations fade through the
    depth and saturate the sigmoids, which would hide the quantization
    error."""
    from desenet_tpu_torch.models.build import DeSeNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DeSeNet(model.spec)
    rng = np.random.default_rng(seed)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight
            fan = w[0].numel()
            sd[f"{name}.weight"] = torch.tensor(
                rng.normal(0, 1.3 / np.sqrt(fan), tuple(w.shape)),
                dtype=torch.float32)
    return sd


# ---- the int8 conv kernel's cases (chip_smoke.py, the card tests) -----------
#
# name, batch, map, the parts' channels, output channels, kernel, stride,
# padding, dilation, per-channel input scales, a residual, the output
# (int8 or the class conv's f32 / bf16 logits). The residual case reads
# its part and its residual as channel slices of wider maps (the C3
# bottleneck's y1 is a slice of cv12's output), so pixels lie further apart
# than the part is wide.
INT8_CONV_CASES = (
    ("stem", 2, 64, 64, (3,), 32, 6, 2, 2, 1, True, False, "int8"),
    ("backbone_3x3_s2", 2, 40, 40, (64,), 128, 3, 2, 1, 1, True, False,
     "int8"),
    ("bottleneck_residual", 2, 40, 40, (64,), 64, 3, 1, 1, 1, True, True,
     "int8"),
    ("spp_4_parts", 2, 20, 20, (256, 256, 256, 256), 512, 1, 1, 0, 1, True,
     False, "int8"),
    ("per_tensor_2_parts", 2, 40, 40, (128, 128), 256, 1, 1, 0, 1, False,
     False, "int8"),
    ("dilated_d3", 2, 80, 80, (21,), 21, 3, 1, 3, 3, True, False, "int8"),
    ("class_conv_f32", 2, 80, 80, (128,), 19, 1, 1, 0, 1, True, False,
     "f32"),
    ("class_conv_bf16", 2, 80, 80, (128,), 19, 1, 1, 0, 1, True, False,
     "bf16"),
)

# grouped convs (the fields above and the group count last): per-tensor
# input scales (a grouped int8 conv takes no per-channel ones), g 2 and 4,
# depthwise (one channel a group, GhostConv's cheap 5x5 among them), k 1,
# 3 and 5, stride 1 and 2, one with the residual read from a slice
INT8_GROUPED_CASES = (
    ("g2_3x3_s1", 8, 80, 80, (128,), 128, 3, 1, 1, 1, False, False, "int8",
     2),
    ("g2_1x1_s2", 8, 80, 80, (128,), 128, 1, 2, 0, 1, False, False, "int8",
     2),
    ("g4_1x1_s1", 8, 80, 80, (128,), 256, 1, 1, 0, 1, False, False, "int8",
     4),
    ("g4_3x3_s2", 8, 80, 80, (128,), 128, 3, 2, 1, 1, False, False, "int8",
     4),
    ("g2_3x3_residual", 8, 40, 40, (64,), 64, 3, 1, 1, 1, False, True,
     "int8", 2),
    ("dw_3x3_s1", 8, 80, 80, (128,), 128, 3, 1, 1, 1, False, False, "int8",
     128),
    ("dw_3x3_s2", 8, 80, 80, (128,), 128, 3, 2, 1, 1, False, False, "int8",
     128),
    ("dw_5x5_s1", 8, 40, 40, (64,), 64, 5, 1, 2, 1, False, False, "int8",
     64),
)


def int8_conv_case(case, device="cpu", seed: int = 0) -> dict:
    """The inputs of ``ops.int8_conv.run`` for one of ``INT8_CONV_CASES``
    or ``INT8_GROUPED_CASES`` on ``device``: int8 parts (channels_last),
    their constants folded by
    ``ops.int8_conv.prepare`` from seeded f32 weights, BN and bias
    correction, and the epilogue's arguments."""
    from desenet_tpu_torch.ops import int8_conv
    from desenet_tpu_torch.quant import scale_t

    (_, b, h, w, chans, o, k, stride, pad, dil, per_channel, residual,
     out) = case[:13]
    groups = case[13] if len(case) > 13 else 1
    rng = np.random.default_rng(seed)
    cl = torch.channels_last

    def int8(shape):
        return torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)

    parts, scales = [], []
    for c in chans:
        if residual:  # a channel slice of a map twice as wide
            part = int8((b, 2 * c, h, w)).to(device).contiguous(
                memory_format=cl)[:, :c]
        else:
            part = int8((b, c, h, w)).to(device).contiguous(memory_format=cl)
        parts.append(part)
        scales.append(tuple(float(v) for v in rng.uniform(0.005, 0.05, c))
                      if per_channel else float(rng.uniform(0.005, 0.05)))
    cin = sum(chans) // groups
    weight = torch.tensor(rng.normal(0, 1 / np.sqrt(cin * k * k),
                                     (o, cin, k, k)), dtype=torch.float32)
    bn = (torch.tensor(rng.uniform(0.5, 1.5, o), dtype=torch.float32),
          torch.tensor(rng.normal(0, 0.1, o), dtype=torch.float32))
    logits = out != "int8"
    prep = int8_conv.prepare(
        weight.to(device), scales, chans, stride=stride, padding=(pad, pad),
        dilation=dil, groups=groups,
        bn=None if logits else tuple(t.to(device) for t in bn),
        bias=bn[1].to(device) if logits else None,
        in_mean=None if logits else rng.normal(0.1, 0.5, cin))
    res = res_scale = None
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    if residual:
        res = int8((b, 2 * o, ho, wo)).to(device).contiguous(
            memory_format=cl)[:, o:]
        res_scale = scale_t(tuple(float(v) for v in
                                  rng.uniform(0.01, 0.05, o)), device)
    mode = {"int8": int8_conv.OUT_INT8, "f32": int8_conv.OUT_F32,
            "bf16": int8_conv.OUT_BF16}[out]
    out_scale = (scale_t(tuple(float(v) for v in rng.uniform(0.02, 0.1, o)),
                         device) if mode == int8_conv.OUT_INT8 else None)
    return {"parts": parts, "prep": prep, "residual": res,
            "res_scale": res_scale, "out_scale": out_scale,
            "act": not logits, "out_mode": mode}


def check_int8(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The int8 conv bar: int8 outputs within 1 LSB, equal on at least
    99.9% of the elements; logits (f32 / bf16) within 1e-5 of the largest
    plain magnitude (the same f32 operations; only SiLU's exp may differ by
    an ulp). Returns the largest absolute difference."""
    if want.dtype == torch.int8:
        d = (got.int() - want.int()).abs()
        eq = float((d == 0).float().mean())
        err = float(d.max())
        if err > 1 or eq < 0.999:
            raise AssertionError(f"{what}: int8 max |diff| {err}, "
                                 f"equal on {eq:.6f}")
        return err
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-5 * float(want.float().abs().max()) * (
        256 if want.dtype == torch.bfloat16 else 1)
    if err > tol:
        raise AssertionError(f"{what}: logits max |diff| {err} > {tol}")
    return err


# the mask assembly (ops/mask_assembly.py): (B, A, nc, img, max_det) of
# the cases the card and the CPU tests share; the last is the served
# cell's shape, b128 at 640 with about 100 boxes an image
MASK_CASES = (
    (3, 600, 80, 128, 40),
    (2, 300, 3, 96, 7),       # Wp 24: a row of 3 bytes, byte stores
    (128, 25200, 80, 640, 300),
)


def mask_assembly_case(case, seed: int = 0, dtype=torch.bfloat16,
                       kept: int = 100):
    """Seeded inputs of ``ops.mask_assembly.assemble_masks``: (decode (B,
    A, 5 + nc + 32) f32 with N(0, 1) coefficients, index (B, max_det)
    int32, boxes (B, max_det, 4) f32, num (B,) int32, proto (B, 32, img/4,
    img/4) in ``dtype``, nc, (img, img)). Image 0 keeps no box and image 1
    all ``max_det``; the others up to ``kept``. The boxes lie anywhere
    from beyond the image's top left to beyond its bottom right, a third
    of them with every edge on a whole proto pixel (multiples of 4 px)."""
    b, a, nc, img, max_det = case
    g = torch.Generator().manual_seed(seed)
    decode = torch.rand((b, a, 5 + nc + 32), generator=g)
    decode[..., 5 + nc:] = torch.randn((b, a, 32), generator=g)
    hp = img // 4
    proto = torch.randn((b, 32, hp, hp), generator=g).mul(0.5).to(dtype)
    num = torch.randint(0, min(kept, max_det) + 1, (b,), generator=g)
    num[0] = 0
    if b > 1:
        num[1] = max_det
    index = torch.full((b, max_det), -1, dtype=torch.int32)
    boxes = torch.zeros((b, max_det, 4))
    for i in range(b):
        n = int(num[i])
        index[i, :n] = torch.randperm(a, generator=g)[:n].to(torch.int32)
        xy = torch.rand((n, 2), generator=g) * (img * 1.2) - img * 0.1
        wh = torch.rand((n, 2), generator=g) * img * 0.5
        bx = torch.cat([xy, xy + wh], 1)
        whole = torch.rand((n,), generator=g) < 1 / 3
        bx[whole] = (bx[whole] / 4).round() * 4
        boxes[i, :n] = bx
    return decode, index, boxes, num.to(torch.int32), proto, nc, (img, img)


def check_masks(got: torch.Tensor, want: torch.Tensor, decode, index, num,
                proto, nc: int, rel: float = 1e-3) -> tuple:
    """The packed masks ``got`` equal ``want`` bit for bit, except at
    pixels where ``|c . P|`` is below ``rel`` times its median over the
    box's plane (float64 sums; there the two float32 sums may fall on
    either side of 0). Returns (the count of bits that differ, the largest
    ``|c . P|`` over its plane's median at a bit that differs, 0 where
    none does)."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == torch.uint8
    diff = np.unpackbits((got ^ want).numpy(), axis=-1, bitorder="little")
    if not diff.any():
        return 0, 0.0
    bb, jj = np.nonzero(diff.reshape(diff.shape[0], diff.shape[1], -1)
                        .any(-1))
    worst = 0.0
    for i, j in zip(bb.tolist(), jj.tolist()):
        assert j < int(num[i]), (i, j, "a row past num differs")
        p = proto[i].cpu().double()
        c = decode[i, int(index[i, j]), 5 + nc:5 + nc + p.shape[0]].cpu()
        v = (c.double() @ p.reshape(p.shape[0], -1)).abs().view(
            p.shape[1], p.shape[2])
        bad = torch.from_numpy(diff[i, j].astype(bool))
        ratio = float(v[bad].max()) / float(v.median())
        assert ratio < rel, (i, j, ratio)
        worst = max(worst, ratio)
    return int(diff.sum()), worst


# (B, C, H, W): the phase pass's cases, y (B, 4C, H+1, W+1). C 64 takes the
# 16-byte groups in bf16 and f32, 20 in f32 only (a multiple of 4, not of
# 8), 3 in neither; H and W odd and even
PHASE_CASES = [(3, 64, 5, 7), (2, 20, 4, 3), (2, 3, 6, 5)]
# Proto at the x7seg cell's widths (c1, c_, c2) on a b2 P3 map of 80 x 80
PROTO_SERVED = (320, 320, 32, 80)


def phases_case(case, dtype=torch.bfloat16, seed: int = 0):
    """The phase pass's inputs for ``PHASE_CASES`` entry ``case``: the
    folded conv's output y (B, 4C, H+1, W+1) channels_last in ``dtype``
    and the (C,) f32 scale and shift, on the CPU."""
    b, c, h, w = case
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn((b, 4 * c, h + 1, w + 1), generator=g) * 2).to(
        dtype).contiguous(memory_format=torch.channels_last)
    scale = torch.rand(c, generator=g) + 0.5
    shift = torch.randn(c, generator=g) * 0.3
    return y, scale, shift


# (what, words of its ValueError): the tensors the phase kernel refuses
PHASE_REFUSALS = [("dtype", "not bfloat16 or float32"),
                  ("layout", "channels_last"),
                  ("channels", "not four times"), ("wide", "more than"),
                  ("small", "not at least 2 x 2"), ("constants", "scale is"),
                  ("autograd", "autograd")]


def phases_refusal_case(what: str):
    """The phase pass's inputs (``phases_case`` of the first case, on the
    CPU) broken as ``PHASE_REFUSALS`` names, or whole for "none"."""
    from desenet_tpu_torch.ops.conv_epilogue import MAX_C

    y, scale, shift = phases_case(PHASE_CASES[0])
    if what == "dtype":
        y = y.half()
    elif what == "layout":
        y = y.contiguous()
    elif what == "channels":
        scale, shift = scale[1:], shift[1:]
    elif what == "wide":
        c = MAX_C + 1
        y = torch.zeros((1, 4 * c, 2, 2), dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        scale, shift = torch.ones(c), torch.zeros(c)
    elif what == "small":
        y = y[:, :, :1].contiguous(memory_format=torch.channels_last)
    elif what == "constants":
        scale = scale.double()
    elif what == "autograd":
        y = y.float().requires_grad_()
    return y, scale, shift
