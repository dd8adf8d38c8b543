"""desenet_tpu_torch.ops.seg_ce.upsampled_ce (a torch.autograd.Function:
CE against the 8x align_corners bilinear upsample, tiled over output rows)
against the port's literal composition ``segmentation_loss(resize_bilinear
(z))`` and against the JAX package's ``upsampled_ce``, loss and ``dz``, on
the same logits (numpy, seeded). Bars are tests/test_seg_ce_fused.py's:
f32 5e-7 relative on the loss and 5e-7 of the gradient's largest magnitude;
bf16 the same on the loss against JAX (same contraction order and
roundings) and 2^-6 on the gradient. Against the port's composition the
gradient bar is 2e-6 in f32: ``F.interpolate``'s backward scatters where
the tiled form contracts, so their roundings differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desenet_tpu.ops.seg_ce import _row_blocks as jax_row_blocks
from desenet_tpu.ops.seg_ce import upsampled_ce as jax_upsampled_ce
from desenet_tpu_torch.losses import segmentation_loss
from desenet_tpu_torch.ops.resize import resize_bilinear
from desenet_tpu_torch.ops.seg_ce import _row_blocks, upsampled_ce

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
BARS = {"f32": (5e-7, 5e-7), "bf16": (5e-7, 2.0 ** -6)}


def inputs(seed, b, h, w, c, s=8, ignore=False):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 2, (b, c, h, w)).astype(np.float32)
    y = rng.integers(0, c, (b, h * s, w * s)).astype(np.int32)
    if ignore:
        y[0, :17] = -1  # an ignored band across a block boundary
    return z, y


def port_loss_grad(z, y, dt, fn):
    zt = torch.from_numpy(z).to(TDT[dt]).requires_grad_(True)
    loss = fn(zt, torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), zt.grad.float().numpy()


def jax_loss_grad(z, y, dt, *args):
    zj = jnp.asarray(np.transpose(z, (0, 2, 3, 1)), JDT[dt])
    loss, g = jax.value_and_grad(
        lambda v: jax_upsampled_ce(v, jnp.asarray(y), y.shape[1:], True,
                                   *args))(zj)
    return float(loss), np.transpose(np.asarray(g, np.float32), (0, 3, 1, 2))


def assert_close(got, want, bars):
    (lg, gg), (lw, gw) = got, want
    tol, gtol = bars
    assert np.isclose(lg, lw, rtol=tol, atol=0), (lg, lw)
    scale = np.abs(gw).max()
    d = np.abs(gg - gw).max()
    assert d <= max(gtol * scale, 1e-9), (d, scale)


@pytest.mark.parametrize("row_target", [16, 40, 64])
def test_matches_composition_f32(row_target):
    z, y = inputs(0, 2, 10, 12, 3)
    got = port_loss_grad(z, y, "f32", lambda v, t: upsampled_ce(
        v, t, t.shape[1:], True, -1, None, row_target))
    want = port_loss_grad(z, y, "f32", lambda v, t: segmentation_loss(
        resize_bilinear(v, t.shape[1:], align_corners=True), t))
    assert_close(got, want, (5e-7, 2e-6))


def test_matches_composition_bf16():
    # F.interpolate rounds the bf16 upsample once, the tiled form twice (H,
    # then W, as the JAX package does), so the loss moves by up to a bf16
    # rounding of the logits: 2^-8 relative
    z, y = inputs(1, 2, 10, 12, 3)
    got = port_loss_grad(z, y, "bf16", lambda v, t: upsampled_ce(
        v, t, t.shape[1:], True, -1, None, 16))
    want = port_loss_grad(z, y, "bf16", lambda v, t: segmentation_loss(
        resize_bilinear(v, t.shape[1:], align_corners=True), t))
    assert_close(got, want, (2.0 ** -8, 2.0 ** -6))


def test_ignore_index_and_class_weight_match_composition():
    z, y = inputs(2, 2, 8, 8, 4, ignore=True)
    cw = [1.0, 2.0, 0.5, 1.5]
    got = port_loss_grad(z, y, "f32", lambda v, t: upsampled_ce(
        v, t, t.shape[1:], True, -1, cw, 16))
    want = port_loss_grad(z, y, "f32", lambda v, t: segmentation_loss(
        resize_bilinear(v, t.shape[1:], align_corners=True), t,
        class_weight=cw))
    assert_close(got, want, (1e-6, 2e-6))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["plain", "ignore", "class_weight",
                                  "odd_rows"])
def test_matches_jax(dt, case):
    shape = (1, 11, 11, 3) if case == "odd_rows" else (2, 10, 12, 4)
    z, y = inputs(3, *shape, ignore=case == "ignore")
    cw = [1.0, 2.0, 0.5, 1.5] if case == "class_weight" else None
    row_target = 64 if case == "odd_rows" else 16  # 88 rows: 2 blocks of 44
    got = port_loss_grad(z, y, dt, lambda v, t: upsampled_ce(
        v, t, t.shape[1:], True, -1, cw, row_target))
    want = jax_loss_grad(z, y, dt, -1,
                         None if cw is None else jnp.asarray(cw), row_target)
    assert_close(got, want, BARS[dt])


def test_row_blocks_match_jax():
    for h in list(range(1, 200)) + [640, 1280]:
        for target in (16, 40, 64):
            assert _row_blocks(h, target) == jax_row_blocks(h, target)


def test_holds_no_full_resolution_map():
    """Autograd saves the low-resolution logits and the labels only."""
    z, y = inputs(4, 1, 10, 10, 3)
    zt = torch.from_numpy(z).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        upsampled_ce(zt, torch.from_numpy(y), (80, 80), True, -1, None, 16)
    assert max(int(np.prod(s)) for s in saved) <= max(z.size, y.size), saved
